"""The hand-written CUDA paged-attention kernels against their plain PyTorch
version, on the card. Marked ``cuda``: they skip where there is no CUDA
device or no nvcc. On a machine with the card (which has no JAX, so the
suite's conftest cannot load):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: |kernel - plain| <= 2e-3 + 1e-2·|plain| on valid rows — both
read the same bf16 inputs and sum in f32 in different orders, and the
outputs round to bf16 (2^-8 relative), so they may differ by one step. The
outputs are softmax averages of N(0, 1) values, |out| ~ 0.03-0.06 over
hundreds of keys, where a bf16 step is ~2.4e-4: 2e-3 is a few steps there,
small enough that an output off by a couple of percent fails.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def kernels():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from dynamo_tpu_torch.ops.cuda import build
    from dynamo_tpu_torch.ops.cuda import paged_attention as kernels

    try:
        build.nvcc_path()
    except RuntimeError:
        pytest.skip("no nvcc")
    return kernels


def _case(B, C, H, KH, D, BS, starts, lens, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    P = (max(s + C for s in starts) + BS - 1) // BS + 1
    NB = B * P + 5
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    return dict(
        q=rnd(B, C, H, D), k=rnd(NB, BS, KH, D), v=rnd(NB, BS, KH, D),
        tables=torch.randperm(NB, generator=g, device="cuda")[: B * P].reshape(B, P).int(),
        start=torch.tensor(starts, dtype=torch.int32, device="cuda"),
        lens=torch.tensor(lens, dtype=torch.int32, device="cuda"),
    )


def _check(out, ref, lens):
    torch.cuda.synchronize()
    for b, n in enumerate(lens):
        a, r = out[b, :n].float(), ref[b, :n].float()
        assert torch.isfinite(a).all()
        assert bool(((a - r).abs() <= 2e-3 + 1e-2 * r.abs()).all()), float((a - r).abs().max())


CASES = [
    # B, C, H, KH, D, BS, starts, lens, window, cap
    (5, 1, 14, 2, 64, 16, [0, 1, 15, 16, 700], [1] * 5, 0, 0.0),
    (3, 8, 8, 1, 64, 8, [3, 100, 260], [8] * 3, 0, 0.0),
    (4, 2, 32, 8, 64, 4, [0, 9, 33, 64], [2] * 4, 7, 0.0),
    (2, 3, 14, 2, 64, 32, [50, 300], [3, 3], 0, 50.0),
]


@pytest.mark.parametrize("B,C,H,KH,D,BS,starts,lens,window,cap", CASES)
def test_decode_kernel_matches_plain(kernels, B, C, H, KH, D, BS, starts, lens, window, cap):
    from dynamo_tpu_torch.ops.attention import paged_attention_ref

    c = _case(B, C, H, KH, D, BS, starts, lens, seed=B * 10 + C)
    out = kernels.paged_attention_decode(c["q"], c["k"], c["v"], c["tables"], c["start"],
                                         window=window, logit_cap=cap)
    ref = paged_attention_ref(c["q"], c["k"], c["v"], c["tables"], c["start"], c["lens"],
                              window=window, logit_cap=cap)
    _check(out, ref, lens)


CHUNK_CASES = [
    (3, 100, 14, 2, 64, 16, [0, 17, 200], [100, 64, 1], 0, 0.0),
    (2, 70, 8, 2, 64, 8, [5, 64], [70, 33], 20, 30.0),
    (2, 9, 4, 4, 64, 64, [0, 129], [9, 0], 0, 0.0),
]


@pytest.mark.parametrize("B,C,H,KH,D,BS,starts,lens,window,cap", CHUNK_CASES)
def test_chunk_kernel_matches_plain(kernels, B, C, H, KH, D, BS, starts, lens, window, cap):
    from dynamo_tpu_torch.ops.attention import paged_attention_ref

    c = _case(B, C, H, KH, D, BS, starts, lens, seed=B * 10 + C)
    out = kernels.paged_attention_chunk(c["q"], c["k"], c["v"], c["tables"], c["start"],
                                        c["lens"], window=window, logit_cap=cap)
    ref = paged_attention_ref(c["q"], c["k"], c["v"], c["tables"], c["start"], c["lens"],
                              window=window, logit_cap=cap)
    _check(out, ref, lens)
    assert torch.isfinite(out).all()  # padding rows too


def test_wrappers_count_launches_and_refuse_what_the_kernel_does_not_take(kernels):
    c = _case(2, 1, 14, 2, 64, 16, [3, 40], [1, 1], seed=0)
    kernels.reset_launch_counts()
    kernels.paged_attention_decode(c["q"], c["k"], c["v"], c["tables"], c["start"])
    kernels.paged_attention_chunk(c["q"], c["k"], c["v"], c["tables"], c["start"], c["lens"])
    assert kernels.launch_counts == {"paged_attention_decode": 1, "paged_attention_chunk": 1}
    with pytest.raises(TypeError):
        kernels.paged_attention_decode(c["q"].float(), c["k"], c["v"], c["tables"], c["start"])
    with pytest.raises(ValueError):
        kernels.paged_attention_decode(c["q"], c["k"], c["v"], c["tables"].cpu(), c["start"])
    big = _case(1, 9, 16, 2, 64, 16, [0], [9], seed=1)  # C*G = 72 > 64
    with pytest.raises(ValueError):
        kernels.paged_attention_decode(big["q"], big["k"], big["v"], big["tables"], big["start"])
    wide = _case(1, 1, 8, 2, 128, 16, [5], [1], seed=2)  # built for head_dim 64 only
    with pytest.raises(ValueError):
        kernels.paged_attention_decode(wide["q"], wide["k"], wide["v"], wide["tables"], wide["start"])
