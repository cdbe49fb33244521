"""The hand-written CUDA kernels (paged attention, the fused decoder layer,
the int8 lm-head) against their plain PyTorch versions, on the card.
Marked ``cuda``: they skip where there is no CUDA device or no nvcc. On a
machine with the card (which has no JAX, so the suite's conftest cannot
load):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: |kernel - plain| <= 2e-3 + 1e-2·|plain| on valid rows — both
read the same bf16 inputs and sum in f32 in different orders, and the
outputs round to bf16 (2^-8 relative), so they may differ by one step. The
outputs are softmax averages of N(0, 1) values, |out| ~ 0.03-0.06 over
hundreds of keys, where a bf16 step is ~2.4e-4: 2e-3 is a few steps there,
small enough that an output off by a couple of percent fails.

The fused layer and the int8 head are held to one bf16 step
(tools.cases.bf16_steps).
"""

import pytest
import torch

from dynamo_tpu_torch.tools.cases import (
    LAYER_CASES,
    bf16_steps,
    layer_case,
    make_layer_case,
    q8_weight,
    run_layer,
)

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
    wide = _case(1, 1, 8, 2, 256, 16, [5], [1], seed=2)  # built for head_dim 64 and 128
    with pytest.raises(ValueError):
        kernels.paged_attention_decode(wide["q"], wide["k"], wide["v"], wide["tables"], wide["start"])


def test_paged_attention_at_head_dim_128(kernels):
    """Llama-3-8B attention shapes: KH 8, G 4, D 128 (decode tiles of 128 keys,
    chunk tiles of 64 x 64)."""
    from dynamo_tpu_torch.ops.attention import paged_attention_ref

    dec = _case(6, 1, 32, 8, 128, 16, [0, 1, 16, 300, 1023, 1500], [1] * 6, seed=21)
    out = kernels.paged_attention_decode(dec["q"], dec["k"], dec["v"], dec["tables"], dec["start"])
    _check(out, paged_attention_ref(dec["q"], dec["k"], dec["v"], dec["tables"], dec["start"],
                                    dec["lens"]), [1] * 6)
    ch = _case(3, 100, 32, 8, 128, 16, [0, 37, 512], [100, 64, 1], seed=22)
    out = kernels.paged_attention_chunk(ch["q"], ch["k"], ch["v"], ch["tables"], ch["start"],
                                        ch["lens"], window=50, logit_cap=20.0)
    ref = paged_attention_ref(ch["q"], ch["k"], ch["v"], ch["tables"], ch["start"], ch["lens"],
                              window=50, logit_cap=20.0)
    _check(out, ref, [100, 64, 1])


# -- fused decoder layer and int8 head ----------------------------------------


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_fused_layer_kernel_matches_plain(kernels, name):
    """The kernel against fused_decoder_layer_ref on the same inputs, within
    one bf16 step (bf16_steps <= 1) — the two differ only in the order of their
    f32 sums — and bit-for-bit equal to itself on a second run. The 8B case
    has a row past its table (start 1600 > 94 pages x 16)."""
    from dynamo_tpu_torch.ops.cuda import fused_layer as kernel
    from dynamo_tpu_torch.ops.fused_layer import fused_decoder_layer_ref

    c, call = make_layer_case(name, "cuda")
    kernel.reset_launch_counts()
    got = run_layer(kernel.fused_decoder_layer, c, call)
    again = run_layer(kernel.fused_decoder_layer, c, call)
    ref = run_layer(fused_decoder_layer_ref, c, call)
    torch.cuda.synchronize()
    assert kernel.launch_counts["fused_decoder_layer"] == 2
    for label, a, r, a2 in zip(("x_out", "k_new", "v_new"), got, ref, again):
        assert torch.isfinite(a.float()).all(), label
        assert torch.equal(a, a2), f"{label} differs between two runs"
        assert bf16_steps(a, r) <= 1.0, (label, bf16_steps(a, r))


@pytest.mark.parametrize("tied,M,K,V", [(False, 16, 4096, 128256), (True, 16, 896, 151936),
                                        (False, 20, 200, 1008), (True, 3, 200, 77)])
def test_lm_head_kernel_matches_plain(kernels, tied, M, K, V):
    """int8 head: the product rounded to bf16 before the scale, as the plain
    version; they differ by at most one bf16 step of the product (the f32
    sums may round to neighbouring bf16 values)."""
    from dynamo_tpu_torch.ops.cuda import lm_head as kernel
    from dynamo_tpu_torch.ops.quant import lm_head_ref

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    g = torch.Generator(device="cuda").manual_seed(M + K)
    w = q8_weight(g, V, K, "cuda") if tied else q8_weight(g, K, V, "cuda")
    if tied:  # per vocab row
        w["s"] = (torch.rand(V, 1, generator=g, device="cuda") + 0.5) * (K**-0.5 / 73.3)
    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    kernel.reset_launch_counts()
    out = kernel.lm_head_int8(x, w["q8"], w["s"], tied=tied)
    ref = lm_head_ref(x, w, tied=tied)
    torch.cuda.synchronize()
    assert kernel.launch_counts["lm_head_int8"] == 1
    assert out.shape == (M, V) and out.dtype == torch.float32
    err = (out - ref).abs()
    assert bool((err <= 2.0**-7 * ref.abs() + 1e-5 * ref.abs().max()).all()), float(err.max())


def test_fused_and_head_wrappers_refuse_what_the_kernels_do_not_take(kernels):
    from dynamo_tpu_torch.ops.cuda import fused_layer, lm_head

    c = layer_case(2, 256, 4, 2, 128, 512, [3, 40], device="cuda", seed=9)
    with pytest.raises(TypeError):  # float32 residual
        fused_layer.fused_decoder_layer(c["x"].float(), c["cos"], c["sin"], c["lp"], c["k"], c["v"],
                                        c["tables"], c["start"], eps=1e-5, sm_scale=0.1)
    narrow = _case(2, 1, 8, 4, 64, 16, [3, 40], [1, 1], seed=3)  # head_dim 64: not built
    with pytest.raises(ValueError):
        fused_layer.fused_decoder_layer(c["x"], c["cos"], c["sin"], c["lp"], narrow["k"],
                                        narrow["v"], c["tables"], c["start"], eps=1e-5, sm_scale=0.1)
    x = torch.randn(2, 64, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError):  # vocab not a multiple of 16
        lm_head.lm_head_int8(x, torch.zeros(64, 24, dtype=torch.int8, device="cuda"),
                             torch.ones(1, 24, device="cuda"), tied=False)
    with pytest.raises(TypeError):  # float32 hidden states
        lm_head.lm_head_int8(x.float(), torch.zeros(64, 16, dtype=torch.int8, device="cuda"),
                             torch.ones(1, 16, device="cuda"), tied=False)
