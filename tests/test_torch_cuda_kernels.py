"""The hand-written CUDA kernels (paged attention over bf16 and int8 pools at
head_dim 64, 128 and 256 and block sizes up to 256, decode attention split
over the keys, chunk attention on the tensor cores, the fused decoder layer,
the int8 lm-head, the int8 weight-streaming product, decode attention with
bf16 probabilities, the int8 FFN) against their plain PyTorch versions, on
the card.
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

int8 pools are held to the same limit: kernel and plain version read the
same codes and scales and fold the scales in at the same points.

Decode attention with bf16 probabilities (decode_packed, decode_bf16) is
held to the same limit against decode_attention_bf16_ref at the wrapper's
split count and at forced splits 1, 2 and 16: the two round the
probabilities against different running maxima, a bf16 step apart at most.

The fused layer, the int8 head and the int8 FFN are held to one bf16 step
(tools.cases.bf16_steps). The int8 product: the raw float32 form to
tools.cases.RAW_RTOL of (|x| @ |w|) (float32 sums in other orders), the
epilogue form to qeinsum's rounding points on the kernel's own sums, bit
for bit, and to one bf16 step of the product from the plain version's
(tools.cases.epilogue_ok); both repeat bit for bit.

Kernel #1 at the speculative verify's shapes (tools.cases.SPEC_VERIFY_CASES:
C 5 a sequence) is held to the same limit.

KV blocks imported into a TorchEngine on the card (bf16 and int8 pools)
are read by its already captured decode graph: the next request replays
it, with no new capture, and gives the exporter's greedy stream.
"""

import pytest
import torch

from dynamo_tpu_torch.tools.cases import (
    BS128_ATTENTION_CASES,
    CHUNK_CASE_LABELS,
    D256_ATTENTION_CASES,
    GEMMA3_MATMUL_SHAPES,
    INT8_ATTENTION_CASES,
    INT8_D256_ATTENTION_CASES,
    LAYER_CASES,
    MATMUL_SHAPES,
    MODEL_LAYER_CASES,
    MODEL_PAST_ONE_SHARE,
    MODEL_STEP_LIMIT,
    PROTO_ATTENTION_CASES,
    SPEC_VERIFY_CASES,
    bf16_steps,
    epilogue_ok,
    ffn_case,
    layer_case,
    make_bs128_attention_case,
    make_chunk_case,
    make_d256_attention_case,
    make_int8_attention_case,
    make_layer_case,
    make_proto_attention_case,
    make_spec_verify_case,
    matmul_case,
    q8_weight,
    quantize_pool,
    raw_product_ok,
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


@pytest.mark.parametrize("label", list(SPEC_VERIFY_CASES))
def test_decode_kernel_at_the_spec_verify_shapes(kernels, label):
    """#1 at the speculative verify's rows (C 5 a sequence, 16 sequences,
    contexts 100-1,300): Qwen2.5-0.5B's 35 rows a block at D 64 (the
    64-row layout), Llama-3-8B's 20 at D 128 over bf16 and int8 pools; at
    the wrapper's split count and at forced splits 1, 2 and 16, and two
    runs bit for bit equal, one launch a call under the pool's name."""
    from dynamo_tpu_torch.ops.attention import paged_attention_ref

    name, c = make_spec_verify_case(label, "cuda")
    args = (c["q"], c["k"], c["v"], c["tables"], c["start"])
    ref = paged_attention_ref(*args, c["clens"])
    lens = c["clens"].tolist()
    kernels.reset_launch_counts()
    out = kernels.paged_attention_decode(*args)
    _check(out, ref, lens)
    counts = {**kernels.launch_counts, **kernels.int8_launch_counts}
    assert counts[name] == 1 and sum(counts.values()) == 1
    assert torch.equal(out, kernels.paged_attention_decode(*args))
    for splits in (1, 2, 16):
        _check(kernels.paged_attention_decode(*args, splits=splits), ref, lens)


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
    odd = _case(1, 1, 8, 2, 96, 16, [5], [1], seed=2)  # built for head_dim 64, 128 and 256
    with pytest.raises(ValueError):
        kernels.paged_attention_decode(odd["q"], odd["k"], odd["v"], odd["tables"], odd["start"])


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


@pytest.mark.parametrize("label", list(D256_ATTENTION_CASES))
def test_paged_attention_at_head_dim_256(kernels, label):
    """Gemma shapes over bf16 pools: Gemma-2 (KH 4, G 2, softcap 50, window
    4,096 at contexts of 4,000-6,600) and Gemma-3 (KH 1, G 4, window 512),
    with window boundaries inside a page and inside a 64-key tile. Each
    launches its kernel once, counted under the bf16 name."""
    from dynamo_tpu_torch.ops.attention import paged_attention_ref

    name, kind, c, window, cap = make_d256_attention_case(label, "cuda")
    kernels.reset_launch_counts()
    fn = kernels.paged_attention_decode if kind == "decode" else kernels.paged_attention_chunk
    extra = () if kind == "decode" else (c["clens"],)
    out = fn(c["q"], c["k"], c["v"], c["tables"], c["start"], *extra, window=window, logit_cap=cap)
    ref = paged_attention_ref(c["q"], c["k"], c["v"], c["tables"], c["start"], c["clens"],
                              window=window, logit_cap=cap)
    _check(out, ref, c["clens"].tolist())
    assert torch.isfinite(out).all()  # padding rows too
    assert kernels.launch_counts[name] == 1 and sum(kernels.launch_counts.values()) == 1


SPLIT_CASES = {
    # label: (B, C, H, KH, D, BS, starts, window, softcap)
    "D64 C1 G7": (4, 1, 14, 2, 64, 16, [0, 100, 1500, 3000], 0, 0.0),
    "D64 C5 G7 64-row layout": (3, 5, 14, 2, 64, 16, [7, 900, 2000], 0, 0.0),
    "D128 C1 G4 window 300 softcap 30": (4, 1, 32, 8, 128, 16, [50, 700, 1500, 2900], 300, 30.0),
    "D128 C2 G4 block size 128": (3, 2, 32, 8, 128, 128, [0, 129, 1000], 0, 0.0),
    "D256 C1 G2 window 4096 softcap 50": (3, 1, 8, 4, 256, 16, [4000, 5000, 6000], 4096, 50.0),
    "D256 C1 G4 B1 at 6,000 keys": (1, 1, 4, 1, 256, 16, [6000], 0, 0.0),
    "D256 C1 G4 100 and 6,000 keys": (2, 1, 4, 1, 256, 16, [100, 6000], 0, 0.0),
    "D256 C3 G4 window 512 64-row layout": (2, 3, 4, 1, 256, 16, [600, 4000], 512, 0.0),
}


@pytest.mark.parametrize("splits", [1, 2, 5, 16])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("label", list(SPLIT_CASES))
def test_decode_kernel_at_forced_splits(kernels, label, int8, splits):
    """The decode kernel with its keys split over `splits` blocks (1: the
    one-pass kernel) against paged_attention_ref, under the limit above, at
    D 64, 128 and 256 over both pool types, in both layouts; one launch
    counted a call, and two runs bit-equal (the splits are combined in a
    fixed order)."""
    from dynamo_tpu_torch.ops.attention import paged_attention_ref

    B, C, H, KH, D, BS, starts, window, cap = SPLIT_CASES[label]
    c = _case(B, C, H, KH, D, BS, starts, [C] * B, seed=B * 100 + D + C)
    k, v = (quantize_pool(c["k"]), quantize_pool(c["v"])) if int8 else (c["k"], c["v"])
    kernels.reset_launch_counts()
    out = kernels.paged_attention_decode(c["q"], k, v, c["tables"], c["start"], window=window,
                                         logit_cap=cap, splits=splits)
    again = kernels.paged_attention_decode(c["q"], k, v, c["tables"], c["start"], window=window,
                                           logit_cap=cap, splits=splits)
    ref = paged_attention_ref(c["q"], k, v, c["tables"], c["start"], c["lens"], window=window,
                              logit_cap=cap)
    _check(out, ref, [C] * B)
    assert torch.equal(out, again)
    counts = kernels.int8_launch_counts if int8 else kernels.launch_counts
    name = "paged_attention_decode_int8" if int8 else "paged_attention_decode"
    assert counts[name] == 2 and sum(counts.values()) == 2


def test_decode_split_count_comes_from_the_shapes(kernels):
    """split_count asks the card for the split kernel's capacity once and
    takes decode_splits of it: Gemma-3-1B's B 32 x KH 1 splits, _prof_attn.py's
    B 64 x KH 8 does not."""
    g3 = _case(32, 1, 4, 1, 256, 16, [10] * 32, [1] * 32, seed=1)
    p8 = _case(64, 1, 32, 8, 128, 128, [160] * 64, [1] * 64, seed=2)
    assert kernels.split_count(g3["q"], quantize_pool(g3["k"])) > 1
    assert kernels.split_count(p8["q"], p8["k"]) == 1


# -- fused decoder layer and int8 head ----------------------------------------


@pytest.mark.parametrize("name", list(LAYER_CASES) + list(MODEL_LAYER_CASES))
def test_fused_layer_kernel_matches_plain(kernels, name):
    """The kernel against fused_decoder_layer_ref on the same inputs, within
    one bf16 step (bf16_steps <= 1; at the full-width MODEL_LAYER_CASES
    within MODEL_STEP_LIMIT, few values past one step, see there) — the
    two differ only in the order of their f32 sums — and bit-for-bit equal
    to itself on a second run. The 8B case has a row past its table
    (start 1600 > 94 pages x 16)."""
    from dynamo_tpu_torch.ops.cuda import fused_layer as kernel
    from dynamo_tpu_torch.ops.fused_layer import fused_decoder_layer_ref

    c, call = make_layer_case(name, "cuda")
    kernel.reset_launch_counts()
    got = run_layer(kernel.fused_decoder_layer, c, call)
    again = run_layer(kernel.fused_decoder_layer, c, call)
    ref = run_layer(fused_decoder_layer_ref, c, call)
    torch.cuda.synchronize()
    assert kernel.launch_counts["fused_decoder_layer"] == 2
    model = name in MODEL_LAYER_CASES
    for label, a, r, a2 in zip(("x_out", "k_new", "v_new"), got, ref, again):
        assert torch.isfinite(a.float()).all(), label
        assert torch.equal(a, a2), f"{label} differs between two runs"
        assert bf16_steps(a, r) <= (MODEL_STEP_LIMIT if model else 1.0), (label, bf16_steps(a, r))
    if model:
        x, rx = got[0].float(), ref[0].float()
        unit = 2.0**-7 * (rx.abs() + rx.pow(2).mean().sqrt())
        assert int(((x - rx).abs() > unit).sum()) <= MODEL_PAST_ONE_SHARE * x.numel()


@pytest.mark.parametrize("tied,M,K,V", [(False, 16, 4096, 128256), (True, 16, 896, 151936),
                                        (True, 32, 1152, 262144), (False, 20, 200, 1008),
                                        (True, 3, 200, 77)])
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


@pytest.mark.parametrize("M,K,V", [(1, 1152, 262144), (32, 1152, 262144), (64, 1152, 262144),
                                   (100, 1152, 262144), (5, 1152, 1000), (9, 136, 262144),
                                   (40, 136, 1000)])
def test_tied_lm_head_on_tensor_cores(kernels, M, K, V):
    """The tied head at Gemma-3-1B's width (K 1,152 x V 262,144) for one to
    two row groups of 64, a ragged vocabulary (V 1,000: the last block's
    rows past V) and K 136 (not a multiple of 16: 8-byte copies, a zero-
    filled tail), against the plain version under the limit above; two runs
    bit-equal (sums in a fixed order)."""
    from dynamo_tpu_torch.ops.cuda import lm_head as kernel
    from dynamo_tpu_torch.ops.quant import lm_head_ref

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    g = torch.Generator(device="cuda").manual_seed(M + K + V)
    w = q8_weight(g, V, K, "cuda")
    w["s"] = (torch.rand(V, 1, generator=g, device="cuda") + 0.5) * (K**-0.5 / 73.3)
    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    out = kernel.lm_head_int8(x, w["q8"], w["s"], tied=True)
    again = kernel.lm_head_int8(x, w["q8"], w["s"], tied=True)
    ref = lm_head_ref(x, w, tied=True)
    torch.cuda.synchronize()
    assert out.shape == (M, V) and torch.equal(out, again)
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


# -- int8 KV pools and the int8 product ---------------------------------------


@pytest.mark.parametrize("label", list(INT8_ATTENTION_CASES) + list(INT8_D256_ATTENTION_CASES))
def test_int8_pool_attention_kernels_match_plain(kernels, label):
    """paged_attention_{decode,chunk}_int8 against paged_attention_ref on
    the same int8 pools, counted under their own names: Qwen2.5-0.5B and
    Llama-3-8B heads, and Gemma-3-1B's at head_dim 256 (KH 1, G 4: window
    512 with the first visible key inside a page and a 64-key tile, global
    layers at contexts of 4,000-6,000, and C·G > 64)."""
    from dynamo_tpu_torch.ops.attention import paged_attention_ref

    name, kind, c, window, cap = make_int8_attention_case(label, "cuda")
    kernels.reset_launch_counts()
    fn = kernels.paged_attention_decode if kind == "decode" else kernels.paged_attention_chunk
    extra = () if kind == "decode" else (c["clens"],)
    out = fn(c["q"], c["k"], c["v"], c["tables"], c["start"], *extra, window=window, logit_cap=cap)
    ref = paged_attention_ref(c["q"], c["k"], c["v"], c["tables"], c["start"], c["clens"],
                              window=window, logit_cap=cap)
    _check(out, ref, c["clens"].tolist())
    assert torch.isfinite(out).all()  # padding rows too
    assert kernels.int8_launch_counts[name] == 1 and sum(kernels.int8_launch_counts.values()) == 1
    assert not any(kernels.launch_counts.values())


def test_int8_pool_wrappers_refuse_what_the_kernels_do_not_take(kernels):
    _, _, c, _, _ = make_int8_attention_case("int8 D64 B4 C3 window 100 softcap 30", "cuda")
    q, k, v, tables, start = c["q"], c["k"], c["v"], c["tables"], c["start"]
    with pytest.raises(TypeError):  # a bf16 pool beside an int8 pool
        kernels.paged_attention_decode(q, k, v["q8"].to(torch.bfloat16), tables, start)
    with pytest.raises(TypeError):  # scales in the codes' order
        kernels.paged_attention_decode(
            q, {"q8": k["q8"], "s": k["s"].transpose(1, 2).contiguous()}, v, tables, start)
    with pytest.raises(ValueError):  # codes not contiguous
        kernels.paged_attention_decode(
            q, {"q8": k["q8"].transpose(0, 1), "s": k["s"]}, v, tables, start)


@pytest.mark.parametrize("M", [1, 16, 32, 64, 100])
@pytest.mark.parametrize("shape", list(MATMUL_SHAPES) + list(GEMMA3_MATMUL_SHAPES))
def test_int8_matmul_kernel_matches_plain(kernels, shape, M):
    """The raw and the epilogue form against int8_matmul_ref at the four
    Llama-3-8B weight shapes and a Gemma-3-1B layer's seven widths (d
    1,152, d_ff 6,912); M 100 takes two 64-row groups."""
    from dynamo_tpu_torch.ops.cuda import int8_matmul as kernel
    from dynamo_tpu_torch.ops.quant import int8_matmul_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    K, N, _ = {**MATMUL_SHAPES, **GEMMA3_MATMUL_SHAPES}[shape]
    c = matmul_case(M, K, N, device="cuda")
    kernel.reset_launch_counts()
    raw = kernel.int8_matmul(c["x"], c["q8"])
    out = kernel.int8_matmul(c["x"], c["q8"], c["s"])
    again = kernel.int8_matmul(c["x"], c["q8"], c["s"])
    raw_ref = int8_matmul_ref(c["x"], c["q8"])
    ref = int8_matmul_ref(c["x"], c["q8"], c["s"])
    torch.cuda.synchronize()
    assert kernel.launch_counts["int8_matmul"] == 3
    assert raw.dtype == torch.float32 and out.dtype == torch.bfloat16 and out.shape == (M, N)
    err, ok = raw_product_ok(raw, c["x"], c["q8"], raw_ref)
    assert ok, err
    err, ok = epilogue_ok(out, raw, raw_ref, c["x"], c["q8"], c["s"], ref)
    assert ok, err
    assert torch.equal(out, again)


@pytest.mark.parametrize("M,K,N", [(3, 200, 16), (20, 136, 1008), (7, 8, 48)])
def test_int8_matmul_kernel_ragged_shapes(kernels, M, K, N):
    """K not a multiple of 128 and N not of 64: the edges read as zero."""
    from dynamo_tpu_torch.ops.cuda import int8_matmul as kernel
    from dynamo_tpu_torch.ops.quant import int8_matmul_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    c = matmul_case(M, K, N, device="cuda", seed=1)
    x3 = c["x"].reshape(M, 1, K)  # [B, C, K] as qeinsum passes it
    raw = kernel.int8_matmul(x3, c["q8"])
    out = kernel.int8_matmul(x3, c["q8"], c["s"])
    raw_ref = int8_matmul_ref(c["x"], c["q8"])
    ref = int8_matmul_ref(c["x"], c["q8"], c["s"])
    torch.cuda.synchronize()
    assert raw.shape == (M, 1, N) and out.shape == (M, 1, N)
    assert raw_product_ok(raw[:, 0], c["x"], c["q8"], raw_ref)[1]
    assert epilogue_ok(out[:, 0], raw[:, 0], raw_ref, c["x"], c["q8"], c["s"], ref)[1]


def test_int8_matmul_wrapper_refuses_what_the_kernel_does_not_take(kernels):
    from dynamo_tpu_torch.ops.cuda import int8_matmul as kernel

    c = matmul_case(4, 256, 64, device="cuda")
    with pytest.raises(TypeError):  # float32 activations
        kernel.int8_matmul(c["x"].float(), c["q8"])
    with pytest.raises(ValueError):  # N not a multiple of 16
        kernel.int8_matmul(c["x"], c["q8"][:, :40].contiguous())
    with pytest.raises(ValueError):  # transposed codes
        kernel.int8_matmul(c["x"], c["q8"].t())
    with pytest.raises(TypeError):  # bf16 scales
        kernel.int8_matmul(c["x"], c["q8"], c["s"].to(torch.bfloat16))


def test_qeinsum_runs_the_int8_product_for_decode_rows_only(kernels):
    from dynamo_tpu_torch.ops import quant
    from dynamo_tpu_torch.ops.cuda import int8_matmul as kernel

    c = matmul_case(64, 512, 256, device="cuda")
    w = {"q8": c["q8"], "s": c["s"]}
    kernel.reset_launch_counts()
    y = quant.qeinsum("bcd,dh->bch", c["x"].reshape(64, 1, 512), w)
    assert kernel.launch_counts["int8_matmul"] == 1 and y.shape == (64, 1, 256)
    quant.qeinsum("bcd,dh->bch", c["x"].reshape(1, 64, 512).repeat(2, 1, 1), w)  # 128 rows
    assert kernel.launch_counts["int8_matmul"] == 1


# -- the chunk kernel on the tensor cores; the wide-tile int8 product ---------


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("label", CHUNK_CASE_LABELS)
def test_chunk_kernel_at_every_chunk_case(kernels, label, int8):
    """The chunk kernel (scores and P·V on the tensor cores, probabilities
    as bf16 hi + lo halves) against paged_attention_ref at every chunk case
    of tools/cases.py over both pool types, under the limit above; padding
    rows finite; two runs bit-equal (sums in a fixed order); one launch
    counted a call."""
    from dynamo_tpu_torch.ops.attention import paged_attention_ref

    c, window, cap = make_chunk_case(label, "cuda", int8)
    args = (c["q"], c["k"], c["v"], c["tables"], c["start"], c["clens"])
    kernels.reset_launch_counts()
    out = kernels.paged_attention_chunk(*args, window=window, logit_cap=cap)
    again = kernels.paged_attention_chunk(*args, window=window, logit_cap=cap)
    ref = paged_attention_ref(*args, window=window, logit_cap=cap)
    _check(out, ref, c["clens"].tolist())
    assert torch.isfinite(out).all() and torch.equal(out, again)
    counts = kernels.int8_launch_counts if int8 else kernels.launch_counts
    name = "paged_attention_chunk_int8" if int8 else "paged_attention_chunk"
    assert counts[name] == 2 and sum(counts.values()) == 2


@pytest.mark.parametrize("M", [13, 33])
@pytest.mark.parametrize("shape", list(MATMUL_SHAPES) + list(GEMMA3_MATMUL_SHAPES))
def test_int8_matmul_kernel_at_partial_row_groups(kernels, shape, M):
    """M 13 and 33 (a partial 16-row group) at every Llama-3-8B and
    Gemma-3-1B weight shape, as test_int8_matmul_kernel_matches_plain holds
    M 1, 16, 32, 64 and 100."""
    from dynamo_tpu_torch.ops.cuda import int8_matmul as kernel
    from dynamo_tpu_torch.ops.quant import int8_matmul_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    K, N, _ = {**MATMUL_SHAPES, **GEMMA3_MATMUL_SHAPES}[shape]
    c = matmul_case(M, K, N, device="cuda")
    raw = kernel.int8_matmul(c["x"], c["q8"])
    out = kernel.int8_matmul(c["x"], c["q8"], c["s"])
    again = kernel.int8_matmul(c["x"], c["q8"], c["s"])
    raw_ref = int8_matmul_ref(c["x"], c["q8"])
    ref = int8_matmul_ref(c["x"], c["q8"], c["s"])
    torch.cuda.synchronize()
    assert raw_product_ok(raw, c["x"], c["q8"], raw_ref)[1]
    assert epilogue_ok(out, raw, raw_ref, c["x"], c["q8"], c["s"], ref)[1]
    assert torch.equal(out, again)


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("M,K,N", [(32, 4096, 1024), (64, 1152, 256), (7, 1024, 1008),
                                   (64, 14336, 256)])
def test_int8_matmul_at_forced_splits(kernels, M, K, N, splits):
    """K split over 1 to 8 blocks of one cluster (the splits' sums added
    through distributed shared memory), N 1,008 a ragged 128-column tile,
    K 14,336 at 64 rows x staged in two windows: raw and epilogue forms
    against the plain version, and two runs bit-equal."""
    from dynamo_tpu_torch.ops.cuda import int8_matmul as kernel
    from dynamo_tpu_torch.ops.quant import int8_matmul_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    split_k = -(-(-(-K // 128)) // splits) * 128
    c = matmul_case(M, K, N, device="cuda", seed=splits)
    raw = kernel.int8_matmul(c["x"], c["q8"], split_k=split_k)
    out = kernel.int8_matmul(c["x"], c["q8"], c["s"], split_k=split_k)
    again = kernel.int8_matmul(c["x"], c["q8"], c["s"], split_k=split_k)
    raw_ref = int8_matmul_ref(c["x"], c["q8"])
    ref = int8_matmul_ref(c["x"], c["q8"], c["s"])
    torch.cuda.synchronize()
    err, ok = raw_product_ok(raw, c["x"], c["q8"], raw_ref)
    assert ok, err
    err, ok = epilogue_ok(out, raw, raw_ref, c["x"], c["q8"], c["s"], ref)
    assert ok, err
    assert torch.equal(out, again)


def test_int8_matmul_refuses_more_splits_than_a_cluster(kernels):
    from dynamo_tpu_torch.ops.cuda import int8_matmul as kernel

    c = matmul_case(4, 2048, 128, device="cuda")
    with pytest.raises(ValueError, match="split_k"):
        kernel.int8_matmul(c["x"], c["q8"], split_k=128)  # 16 splits
    with pytest.raises(ValueError, match="split_k"):
        kernel.int8_matmul(c["x"], c["q8"], split_k=200)


# -- block size 128; decode attention with bf16 probabilities; the int8 FFN ---


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("label", list(BS128_ATTENTION_CASES))
def test_paged_attention_at_block_size_128(kernels, label, int8):
    """Both kernels over pages of 128 keys (two 64-key tiles each), bf16 and
    int8 pools: window boundaries in a page's second tile, chunks across a
    page edge, and Qwen2.5-0.5B's heads at D 64."""
    from dynamo_tpu_torch.ops.attention import paged_attention_ref

    name, kind, c, window, cap = make_bs128_attention_case(label, "cuda", int8)
    kernels.reset_launch_counts()
    fn = kernels.paged_attention_decode if kind == "decode" else kernels.paged_attention_chunk
    extra = () if kind == "decode" else (c["clens"],)
    out = fn(c["q"], c["k"], c["v"], c["tables"], c["start"], *extra, window=window, logit_cap=cap)
    ref = paged_attention_ref(c["q"], c["k"], c["v"], c["tables"], c["start"], c["clens"],
                              window=window, logit_cap=cap)
    _check(out, ref, c["clens"].tolist())
    counts = {**kernels.launch_counts, **kernels.int8_launch_counts}
    assert counts[name] == 1 and sum(counts.values()) == 1


@pytest.mark.parametrize("name", ["decode_packed", "decode_bf16"])
@pytest.mark.parametrize("label", list(PROTO_ATTENTION_CASES))
def test_proto_attention_kernels_match_plain(kernels, label, name):
    from dynamo_tpu_torch.ops.attention import decode_attention_bf16_ref
    from dynamo_tpu_torch.ops.cuda import decode_attention_proto as kernel

    c, window, cap = make_proto_attention_case(label, "cuda")
    args = (c["q"], c["k"], c["v"], c["tables"], c["start"])
    kernel.reset_launch_counts()
    out = getattr(kernel, name)(*args, window, logit_cap=cap)
    ref = decode_attention_bf16_ref(*args, window, logit_cap=cap)
    _check(out, ref, c["clens"].tolist())
    assert kernel.launch_counts == {"decode_packed": 0, "decode_bf16": 0, name: 1}


@pytest.mark.parametrize("splits", [1, 2, 16])
@pytest.mark.parametrize("name", ["decode_packed", "decode_bf16"])
@pytest.mark.parametrize("label", list(PROTO_ATTENTION_CASES))
def test_proto_attention_kernels_at_forced_splits(kernels, label, name, splits):
    """Each case with its keys split over 1, 2 and 16 blocks (a split count
    the shapes would not choose; 16 leaves shares empty at the short
    contexts): one launch a call, whatever kernels the call runs."""
    from dynamo_tpu_torch.ops.attention import decode_attention_bf16_ref
    from dynamo_tpu_torch.ops.cuda import decode_attention_proto as kernel

    c, window, cap = make_proto_attention_case(label, "cuda")
    args = (c["q"], c["k"], c["v"], c["tables"], c["start"])
    kernel.reset_launch_counts()
    out = getattr(kernel, name)(*args, window, logit_cap=cap, splits=splits)
    ref = decode_attention_bf16_ref(*args, window, logit_cap=cap)
    _check(out, ref, c["clens"].tolist())
    assert kernel.launch_counts == {"decode_packed": 0, "decode_bf16": 0, name: 1}


@pytest.mark.parametrize("name", ["decode_packed", "decode_bf16"])
@pytest.mark.parametrize("label", list(PROTO_ATTENTION_CASES))
def test_proto_attention_kernels_repeat_bit_for_bit(kernels, label, name):
    """Two runs at the split count the wrapper chooses give the same bits:
    the key groups and the splits are added in a fixed order."""
    from dynamo_tpu_torch.ops.cuda import decode_attention_proto as kernel

    c, window, cap = make_proto_attention_case(label, "cuda")
    args = (c["q"], c["k"], c["v"], c["tables"], c["start"])
    fn = getattr(kernel, name)
    kernel.reset_launch_counts()
    assert torch.equal(fn(*args, window, logit_cap=cap), fn(*args, window, logit_cap=cap))
    assert kernel.launch_counts[name] == 2
    assert 1 <= kernel.split_count(c["q"], c["k"], name == "decode_packed") <= 16


def test_proto_attention_split_count_at_the_timed_case(kernels):
    """At _prof_attn.py's case (B 64, KH 8) the card's occupancy splits
    decode_packed's 64 blocks and leaves decode_bf16's 512 whole."""
    from dynamo_tpu_torch.ops.cuda import decode_attention_proto as kernel

    c, _, _ = make_proto_attention_case("llama3-8b B64 ctx 160 bs128", "cuda")
    assert kernel.split_count(c["q"], c["k"], True) >= 2
    assert kernel.split_count(c["q"], c["k"], False) == 1


def test_proto_attention_wrappers_refuse_what_the_kernels_do_not_take(kernels):
    from dynamo_tpu_torch.ops.cuda import decode_attention_proto as kernel

    c = _case(2, 1, 8, 2, 64, 16, [3, 40], [1, 1], seed=4)  # head_dim 64: not built
    with pytest.raises(ValueError, match="head_dim"):
        kernel.decode_packed(c["q"], c["k"], c["v"], c["tables"], c["start"])
    c = _case(2, 2, 8, 2, 128, 16, [3, 40], [2, 2], seed=5)  # two query tokens
    with pytest.raises(ValueError, match="one query token"):
        kernel.decode_bf16(c["q"], c["k"], c["v"], c["tables"], c["start"])
    c = _case(1, 1, 8, 2, 128, 48, [5], [1], seed=6)  # block size 48
    with pytest.raises(ValueError, match="block_size"):
        kernel.decode_packed(c["q"], c["k"], c["v"], c["tables"], c["start"])
    c = _case(2, 1, 8, 2, 128, 16, [3, 40], [1, 1], seed=7)
    for splits in (0, 17):
        with pytest.raises(ValueError, match="splits"):
            kernel.decode_bf16(c["q"], c["k"], c["v"], c["tables"], c["start"], splits=splits)


@pytest.mark.parametrize("M,d,F", [(64, 4096, 14336), (13, 4096, 14336), (1, 256, 512),
                                   (33, 384, 1152)])
def test_ffn_int8_kernel_matches_plain(kernels, M, d, F):
    from dynamo_tpu_torch.ops.cuda import ffn_int8 as kernel
    from dynamo_tpu_torch.ops.ffn_int8 import ffn_int8_ref

    x, *w = ffn_case(M, d, F, device="cuda")
    kernel.reset_launch_counts()
    out = kernel.ffn_int8(x, *w)
    again = kernel.ffn_int8(x, *w)
    ref = ffn_int8_ref(x, *w)
    torch.cuda.synchronize()
    assert kernel.launch_counts["ffn_int8"] == 2
    assert out.dtype == torch.bfloat16 and out.shape == (M, d)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, again)
    assert bf16_steps(out, ref) <= 1.0, bf16_steps(out, ref)


@pytest.mark.parametrize("M", [1, 13, 64])
@pytest.mark.parametrize("split_k", [(4096, 14336), (2048, 4864), (512, 1792), (1024, 2048)])
def test_ffn_int8_at_forced_splits(kernels, M, split_k):
    """Both launches at forced K splits, from one block a tile to eight (a
    cluster; the split sums added in order through distributed shared
    memory): within one bf16 step of the plain version, two runs bit-equal,
    at the Llama-3-8B FFN widths."""
    from dynamo_tpu_torch.ops.cuda import ffn_int8 as kernel
    from dynamo_tpu_torch.ops.ffn_int8 import ffn_int8_ref

    x, *w = ffn_case(M, 4096, 14336, device="cuda")
    out = kernel.ffn_int8(x, *w, split_k=split_k)
    again = kernel.ffn_int8(x, *w, split_k=split_k)
    ref = ffn_int8_ref(x, *w)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, again)
    assert bf16_steps(out, ref) <= 1.0, bf16_steps(out, ref)


def test_ffn_int8_wrapper_refuses_what_the_kernel_does_not_take(kernels):
    from dynamo_tpu_torch.ops.cuda import ffn_int8 as kernel

    x, wg, wu, wd, sg, su, sd = ffn_case(8, 256, 512, device="cuda")
    with pytest.raises(ValueError, match="rows"):
        kernel.ffn_int8(x.repeat(9, 1), wg, wu, wd, sg, su, sd)
    with pytest.raises(TypeError):
        kernel.ffn_int8(x, wg, wu, wd, sg.to(torch.bfloat16), su, sd)
    with pytest.raises(ValueError, match="is on cpu"):
        kernel.ffn_int8(x, wg.cpu(), wu, wd, sg, su, sd)
    with pytest.raises(ValueError, match="split_k"):
        kernel.ffn_int8(x, wg, wu, wd, sg, su, sd, split_k=(128, 64))


# -- CUDA graph capture of the decode-path wrappers ----------------------------


def _replays_match_eager(fn, name, replays=3):
    """``fn`` (a wrapper call) eagerly, then warmed up on a side stream,
    captured with ops/cuda/graphs.CapturedCall and replayed: every replay's
    outputs bit-equal to the eager call's; the capture itself counts no
    launch, and each replay adds its one launch under ``name``."""
    from dynamo_tpu_torch.ops.cuda.graphs import CapturedCall, counters

    def total():
        return sum(c.get(name, 0) for c in counters())

    eager = fn()
    eager = eager if isinstance(eager, tuple) else (eager,)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    box = {}
    before = total()
    call = CapturedCall(lambda: box.update(out=fn()), pool=None, stream=stream)
    assert total() == before, "the capture counted launches"
    assert call.launches == 1 and sum(d.get(name, 0) for d in call.deltas) == 1
    for i in range(1, replays + 1):
        for t in (box["out"] if isinstance(box["out"], tuple) else (box["out"],)):
            t.zero_()
        call.replay()
        torch.cuda.synchronize()
        outs = box["out"] if isinstance(box["out"], tuple) else (box["out"],)
        assert all(torch.equal(a, b) for a, b in zip(outs, eager)), f"replay {i} differs"
        assert total() == before + i and call.replays == i


@pytest.mark.parametrize("splits", [1, None], ids=["one-pass", "split"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_attention_replays_bit_equal(kernels, int8, splits):
    B, C, H, KH, D, BS, starts, window, cap = SPLIT_CASES["D128 C1 G4 window 300 softcap 30"]
    c = _case(B, C, H, KH, D, BS, starts, [C] * B, seed=7)
    k, v = (quantize_pool(c["k"]), quantize_pool(c["v"])) if int8 else (c["k"], c["v"])
    if splits is None:
        assert kernels.split_count(c["q"], k) > 1
    _replays_match_eager(
        lambda: kernels.paged_attention_decode(c["q"], k, v, c["tables"], c["start"],
                                               window=window, logit_cap=cap, splits=splits),
        "paged_attention_decode_int8" if int8 else "paged_attention_decode")


def test_int8_matmul_replays_bit_equal(kernels):
    from dynamo_tpu_torch.ops.cuda import int8_matmul as kernel

    c = matmul_case(32, 4096, 1024, device="cuda")
    _replays_match_eager(lambda: kernel.int8_matmul(c["x"], c["q8"], c["s"]), "int8_matmul")


@pytest.mark.parametrize("tied,M,K,V", [(False, 16, 4096, 128256), (True, 32, 1152, 262144)])
def test_lm_head_replays_bit_equal(kernels, tied, M, K, V):
    from dynamo_tpu_torch.ops.cuda import lm_head as kernel

    g = torch.Generator(device="cuda").manual_seed(M + K)
    w = q8_weight(g, V, K, "cuda") if tied else q8_weight(g, K, V, "cuda")
    if tied:
        w["s"] = (torch.rand(V, 1, generator=g, device="cuda") + 0.5) * (K**-0.5 / 73.3)
    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    _replays_match_eager(lambda: kernel.lm_head_int8(x, w["q8"], w["s"], tied=tied),
                         "lm_head_int8")


def test_fused_layer_replays_bit_equal(kernels):
    """The cooperative launch under capture: the workspace's counters are
    zeroed by the kernel on every launch, so each replay is bit-equal."""
    from dynamo_tpu_torch.ops.cuda import fused_layer as kernel

    c, call = make_layer_case("llama3-8b B16", "cuda")
    _replays_match_eager(lambda: run_layer(kernel.fused_decoder_layer, c, call),
                         "fused_decoder_layer")


@pytest.mark.parametrize("kv", [None, "int8"], ids=["bf16-pools", "int8-pools"])
def test_a_replayed_decode_graph_reads_imported_blocks(kernels, kv):
    """KV blocks imported into an engine whose decode graph of the width
    bucket is already captured: the scatter writes into the pools the graph
    holds, so the next request replays that graph (no new capture) over
    the imported pages, prefills the tail alone and gives the exporter's
    greedy stream."""
    import asyncio

    from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.models.config import tiny_config
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.tokens.blocks import compute_block_hashes

    cfg = tiny_config(n_heads=2, n_kv_heads=2, dtype=torch.bfloat16)  # head_dim 64
    args = dict(config=cfg, block_size=16, num_kv_blocks=64, max_num_seqs=4,
                max_model_len=512, decode_steps=4, kv_cache_dtype=kv, seed=5)
    prompt = [int(t) for t in torch.randint(3, 500, (100,), generator=torch.Generator()
                                            .manual_seed(1))]

    async def run():
        src = TorchEngine(TorchEngineArgs(**args))
        dst = TorchEngine(TorchEngineArgs(**args), params=src.runner.params)

        async def stream(engine, p):
            req = PreprocessedRequest(token_ids=p, sampling=SamplingOptions(temperature=0.0),
                                      stop=StopConditions(max_tokens=16))
            return [t async for o in engine.generate(req, Context()) for t in o.token_ids]

        try:
            want = await stream(src, prompt)
            await stream(dst, [t + 1 for t in prompt])  # captures the bucket's graph
            graphs = len(dst.runner.graphs)
            replays = sum(g.replays for g in dst.runner.graphs.values())
            found, wire = await src.export_blocks_wire_async(compute_block_hashes(prompt, 16))
            assert len(found) == 6 and await dst.import_blocks_wire_async(found, wire) == 6
            before = dst.prefill_tokens
            got = await stream(dst, prompt)
            assert got == want
            assert dst.prefill_tokens - before == len(prompt) - 6 * 16
            assert len(dst.runner.graphs) == graphs
            assert sum(g.replays for g in dst.runner.graphs.values()) > replays
        finally:
            await src.stop()
            await dst.stop()

    asyncio.run(run())
