"""The port's int8 KV cache (ops/kv_quant.py, the int8-pool branches of
ops/attention.py), its int8 weight-streaming product (quant.int8_matmul_ref,
quant.qeinsum) and the "auto" KV policy, against the JAX package on the CPU.
Inputs are made from numpy seeds and handed to both.

Tolerances:
  - KV quantization, cache writes, dequantization: bit-equal (both divide
    and round half to even in float32).
  - int8-pool attention: 1e-5 against the XLA oracle, which dequantizes
    the pages first, and 1e-4 against the Pallas kernels in interpret mode
    (as tests/test_torch_ops.py holds bf16 pools): all three compute the
    same function in float32, with the scales folded in at other points or
    the sums taken in other orders.
  - int8_matmul_ref without a scale: 1e-5 relative to the prototype's own
    reference (float32 sums of exact products, in another order); with a
    scale against qeinsum: one bf16 step (2^-8 relative), the product being
    rounded to bf16 on both sides after sums taken in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engines.tpu import JaxEngineArgs
from dynamo_tpu.engines.tpu.runner import DeviceRunner as JaxRunner
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.ops import attention as jattn
from dynamo_tpu.ops import kv_quant as jkv
from dynamo_tpu.ops import quant as jquant
from dynamo_tpu.ops.pallas.paged_attention import (
    paged_attention_decode_kernel,
    paged_attention_kernel,
)
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.ops import kv_quant as tkv
from dynamo_tpu_torch.ops import quant as tquant
from dynamo_tpu_torch.ops.cuda import int8_matmul as tmatmul
from dynamo_tpu_torch.ops.cuda import paged_attention as tkernels
from dynamo_tpu_torch.tools.cases import GEMMA3_MATMUL_SHAPES, MATMUL_SHAPES

T = torch.from_numpy


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# -- quantization ---------------------------------------------------------


@pytest.mark.parametrize("shape,scale,dtype", [((3, 5, 2, 16), 1.0, np.float32),
                                               ((2, 7, 4, 64), 30.0, np.float32),
                                               ((4, 1, 8, 128), 0.01, "bf16")])
def test_quantize_kv_chunk_bit_equal(shape, scale, dtype):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero token head: scale 1e-8 / 127, codes 0
    x[-1, -1, -1, :3] = [scale, -scale, 0.5 * scale]  # codes ±127 and a half-way value
    jx = jnp.asarray(x)
    tx = T(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want_q, want_s = jax.block_until_ready(jkv.quantize_kv_chunk(jx))
    got_q, got_s = tkv.quantize_kv_chunk(tx)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_dequantize_pages_and_pool_bit_equal():
    rng = np.random.default_rng(3)
    q8 = rng.integers(-127, 128, (6, 4, 2, 16)).astype(np.int8)
    s = rng.uniform(0.001, 0.05, (6, 2, 4)).astype(np.float32)
    pool_j = {"q8": jnp.asarray(q8), "s": jnp.asarray(s)}
    pool_t = {"q8": T(q8), "s": T(s)}
    np.testing.assert_array_equal(tkv.dequantize_pages(T(q8), T(s)).numpy(),
                                  np.asarray(jkv.dequantize_pages(jnp.asarray(q8), jnp.asarray(s))))
    np.testing.assert_array_equal(tkv.dequantize_pool(pool_t, torch.float32).numpy(),
                                  _np(jkv.dequantize_pool(pool_j, jnp.float32)))
    got = tkv.dequantize_pool(pool_t).float().numpy()  # bf16 by default, as JAX
    np.testing.assert_array_equal(got, _np(jkv.dequantize_pool(pool_j)))
    assert tkv.is_quantized_pool(pool_t) and not tkv.is_quantized_pool(T(s))


def _int8_pool(NB, BS, KH, D, fill=0.0, rng=None):
    if rng is None:
        return {"q8": np.zeros((NB, BS, KH, D), np.int8), "s": np.full((NB, KH, BS), fill, np.float32)}
    return {"q8": rng.integers(-127, 128, (NB, BS, KH, D)).astype(np.int8),
            "s": rng.uniform(0.5, 1.5, (NB, KH, BS)).astype(np.float32) * (2.5 / 127)}


def _jpool(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _tpool(p):
    return tattn.copy_to_sink_pool({k: T(v) for k, v in p.items()})


def test_write_chunk_to_cache_int8_drops_padding_and_overshoot():
    """Codes and scales land where the JAX function puts them, bit for bit;
    padding positions and positions past the table's capacity are dropped
    from both the codes and the scales."""
    rng = np.random.default_rng(5)
    NB, BS, KH, D = 12, 4, 2, 8
    pool = _int8_pool(NB, BS, KH, D, rng=rng)  # non-zero: untouched slots must stay
    B, C = 3, 6  # capacity 8 tokens per row
    chunk = (rng.standard_normal((B, C, KH, D)) * 3).astype(np.float32)
    tables = np.array([[3, 7], [1, 10], [5, 0]], np.int32)
    start = np.array([0, 5, 6], np.int32)  # row 1: 5..10 crosses capacity 8
    lens = np.array([4, 6, 1], np.int32)  # row 0 padding past 4
    want = jax.block_until_ready(jattn.write_chunk_to_cache(
        _jpool(pool), jnp.asarray(chunk), jnp.asarray(tables), jnp.asarray(start),
        jnp.asarray(lens)))
    got = tattn.write_chunk_to_cache(_tpool(pool), T(chunk), T(tables), T(start), T(lens))
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    changed = {tuple(ix) for ix in np.argwhere((got["q8"].numpy() != pool["q8"]).any(axis=(2, 3)))}
    changed_s = {(b, t) for b, _, t in np.argwhere(got["s"].numpy() != pool["s"])}
    want_slots = {(3, 0), (3, 1), (3, 2), (3, 3), (10, 1), (10, 2), (10, 3), (0, 2)}
    assert changed == want_slots and changed_s == want_slots
    # a shared write index gives the same pool
    index = tattn.cache_write_index(T(tables), T(start), T(lens), C, BS, NB)
    again = tattn.write_chunk_to_cache(_tpool(pool), T(chunk), T(tables), T(start), T(lens), index)
    assert torch.equal(again["q8"], got["q8"]) and torch.equal(again["s"], got["s"])


# -- attention over int8 pools ----------------------------------------------


INT8_CASES = [
    # seed, B, C, H, KH, D, BS, P, starts, lens, window, cap
    (10, 3, 1, 14, 2, 64, 16, 5, [0, 37, 70], [1, 1, 1], 0, 0.0),  # decode, G=7
    (11, 2, 5, 8, 2, 32, 8, 6, [3, 40], [5, 5], 0, 0.0),  # C <= 8
    (12, 3, 8, 8, 8, 32, 8, 6, [0, 13, 30], [8, 3, 6], 0, 0.0),  # ragged chunk
    (13, 2, 24, 14, 2, 64, 16, 5, [16, 40], [24, 9], 0, 0.0),  # C*G > 64
    (14, 3, 4, 8, 2, 32, 8, 8, [10, 33, 50], [4, 4, 2], 12, 0.0),  # window
    (15, 2, 6, 8, 2, 32, 8, 8, [5, 40], [6, 6], 0, 5.0),  # softcap
    (16, 2, 3, 8, 2, 32, 8, 8, [20, 41], [3, 2], 9, 5.0),  # both
]


def _int8_case(seed, B, C, H, KH, D, BS, P, starts, lens):
    rng = np.random.default_rng(seed)
    NB = B * P + 3
    return dict(
        q=rng.standard_normal((B, C, H, D)).astype(np.float32),
        k=_int8_pool(NB, BS, KH, D, rng=rng), v=_int8_pool(NB, BS, KH, D, rng=rng),
        tables=rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32),
        start=np.asarray(starts, np.int32), lens=np.asarray(lens, np.int32),
    )


def _jax_args(c):
    return (jnp.asarray(c["q"]), _jpool(c["k"]), _jpool(c["v"]), jnp.asarray(c["tables"]),
            jnp.asarray(c["start"]), jnp.asarray(c["lens"]))


def _torch_args(c):
    return T(c["q"]), _tpool(c["k"]), _tpool(c["v"]), T(c["tables"]), T(c["start"]), T(c["lens"])


def _assert_valid_rows(got, want, lens, atol):
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=atol, rtol=atol)


@pytest.mark.parametrize("seed,B,C,H,KH,D,BS,P,starts,lens,window,cap", INT8_CASES)
def test_int8_paged_attention_ref_matches_xla(seed, B, C, H, KH, D, BS, P, starts, lens, window, cap):
    c = _int8_case(seed, B, C, H, KH, D, BS, P, starts, lens)
    want = _np(jattn._paged_attention_xla(*_jax_args(c), window, logit_cap=cap))
    got = tattn.paged_attention_ref(*_torch_args(c), window=window, logit_cap=cap)
    _assert_valid_rows(got.numpy(), want, lens, 1e-5)
    # on CPU tensors paged_attention routes int8 pools through the wrappers'
    # plain path, and counts no launch
    tkernels.reset_launch_counts()
    routed = tattn.paged_attention(*_torch_args(c), window=window, logit_cap=cap)
    _assert_valid_rows(routed.numpy(), want, lens, 1e-5)
    assert not any(tkernels.int8_launch_counts.values())


@pytest.mark.parametrize("seed,B,C,H,KH,D,BS,P,starts,lens,window,cap",
                         [c for c in INT8_CASES if c[2] <= 8 and c[2] * (c[3] // c[4]) <= 64])
def test_int8_decode_plain_matches_pallas_decode_kernel(seed, B, C, H, KH, D, BS, P, starts, lens,
                                                        window, cap):
    c = _int8_case(seed, B, C, H, KH, D, BS, P, starts, [C] * B)
    q, k, v, tables, start, _ = _jax_args(c)
    want = jax.block_until_ready(paged_attention_decode_kernel(
        q, k, v, tables, start, window, interpret=True, batch_block=B if B % 2 else 2,
        logit_cap=cap))
    q_t, k_t, v_t, tables_t, start_t, _ = _torch_args(c)
    got = tkernels.paged_attention_decode(q_t, k_t, v_t, tables_t, start_t,
                                          window=window, logit_cap=cap)
    _assert_valid_rows(got.numpy(), _np(want), [C] * B, 1e-4)


@pytest.mark.parametrize("seed,B,C,H,KH,D,BS,P,starts,lens,window,cap", INT8_CASES)
def test_int8_chunk_plain_matches_pallas_chunk_kernel(seed, B, C, H, KH, D, BS, P, starts, lens,
                                                      window, cap):
    c = _int8_case(seed, B, C, H, KH, D, BS, P, starts, lens)
    want = jax.block_until_ready(
        paged_attention_kernel(*_jax_args(c), window, interpret=True, logit_cap=cap))
    got = tkernels.paged_attention_chunk(*_torch_args(c), window=window, logit_cap=cap)
    _assert_valid_rows(got.numpy(), _np(want), lens, 1e-4)


def test_int8_attention_after_writes_tracks_bf16_pools():
    """End to end through the write path: the same history written into a
    float32 pool and an int8 pool gives attention outputs within the int8
    rounding error (~1/254 of each token's absmax), on both sides."""
    rng = np.random.default_rng(7)
    B, C, H, KH, D, BS, P = 2, 3, 8, 2, 32, 8, 4
    NB = B * P + 2
    tables = rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32)
    hist = rng.standard_normal((B, BS * P, KH, D)).astype(np.float32)
    full = np.full((B,), BS * P, np.int32)
    zero = np.zeros((B,), np.int32)
    kf, vf = np.zeros((NB, BS, KH, D), np.float32), np.zeros((NB, BS, KH, D), np.float32)
    k8, v8 = _tpool(_int8_pool(NB, BS, KH, D)), _tpool(_int8_pool(NB, BS, KH, D))
    for pool, scale in ((k8, 1.0), (v8, 0.5)):
        tattn.write_chunk_to_cache(pool, T(hist * scale), T(tables), T(zero), T(full))
    kf, vf = tattn.copy_to_sink_pool(T(kf)), tattn.copy_to_sink_pool(T(vf))
    tattn.write_chunk_to_cache(kf, T(hist), T(tables), T(zero), T(full))
    tattn.write_chunk_to_cache(vf, T(hist * 0.5), T(tables), T(zero), T(full))
    q = T(rng.standard_normal((B, C, H, D)).astype(np.float32))
    start = T(np.array([5, 20], np.int32))
    lens = T(np.array([3, 3], np.int32))
    out8 = tattn.paged_attention_ref(q, k8, v8, T(tables), start, lens)
    outf = tattn.paged_attention_ref(q, kf, vf, T(tables), start, lens)
    assert float((out8 - outf).abs().max()) < 0.05


# -- the int8 weight-streaming product ---------------------------------------


@pytest.mark.parametrize("M,K,N", [(16, 256, 128), (5, 512, 96), (64, 128, 1024), (3, 1024, 64)])
def test_int8_matmul_ref_matches_the_prototype_reference(M, K, N):
    """Without a scale: the prototype's function, float32 sums of bf16 x
    times the codes (_prof_stream.py:38-48, reproduced here: the script draws
    470 MB of weights and benchmarks when imported)."""
    rng = np.random.default_rng(M + K + N)
    x = jnp.asarray(rng.standard_normal((M, K)).astype(np.float32)).astype(jnp.bfloat16)
    w = rng.integers(-127, 127, size=(K, N)).astype(np.int8)
    want = jax.block_until_ready(jax.lax.dot_general(
        x, jnp.asarray(w).astype(x.dtype), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32))
    xt = T(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    got = tquant.int8_matmul_ref(xt, T(w))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(want)).max()))
    # the wrapper on CPU tensors is the plain version, and counts no launch
    tmatmul.reset_launch_counts()
    assert torch.equal(tmatmul.int8_matmul(xt, T(w)), got)
    assert tmatmul.launch_counts == {"int8_matmul": 0}


@pytest.mark.parametrize("spec,xs,K,N", [("bcd,dh->bch", (4, 1, 256), 256, 384),
                                         ("bch,hd->bcd", (2, 3, 128), 128, 256),
                                         ("bcf,fd->bcd", (8, 1, 512), 512, 128)])
def test_int8_matmul_ref_with_scale_matches_jax_qeinsum(spec, xs, K, N):
    rng = np.random.default_rng(K + N)
    w = jquant.quantize_q8((rng.standard_normal((K, N)) * 0.05).astype(np.float32), (0,))
    x = jnp.asarray(rng.standard_normal(xs).astype(np.float32)).astype(jnp.bfloat16)
    want = _np(jquant.qeinsum(spec, x, {k: jnp.asarray(v) for k, v in w.items()}))
    xt = T(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    got = tquant.int8_matmul_ref(xt, T(w["q8"]), T(w["s"]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-8, atol=1e-6)
    # qeinsum routes these decode-sized bf16 products to the kernel's wrapper
    # (its plain version on the CPU): the same bits as the reference
    routed = tquant.qeinsum(spec, xt, {"q8": T(w["q8"]), "s": T(w["s"])})
    assert torch.equal(routed, got)


def test_qeinsum_sends_only_decode_sized_bf16_products_to_the_kernel(monkeypatch):
    calls = []
    real = tmatmul.int8_matmul
    monkeypatch.setattr(tmatmul, "int8_matmul", lambda *a: calls.append(a[0].shape) or real(*a))
    rng = np.random.default_rng(0)
    w = {k: T(v) for k, v in tquant.quantize_q8(rng.standard_normal((64, 32)).astype(np.float32),
                                                (0,)).items()}
    limit = tquant.INT8_MATMUL_MAX_ROWS
    for shape, routed in (((limit, 1, 64), True), ((2, limit // 2, 64), True),
                          ((limit + 1, 1, 64), False), ((1, 512, 64), False)):
        x = torch.randn(shape).to(torch.bfloat16)
        calls.clear()
        y = tquant.qeinsum("bcd,dh->bch", x, w)
        assert bool(calls) == routed, shape
        assert y.shape == (*shape[:2], 32) and y.dtype == torch.bfloat16
    calls.clear()
    tquant.qeinsum("bcd,dh->bch", torch.randn(2, 1, 64), w)  # float32 model: not the kernel's
    assert not calls


# Clusters of S blocks (blocks, for S = 1) an H100 SXM holds at once, at
# one and at two blocks an SM, as the card reports them
# (tools/int8_stream_probe.py's capacity line): a cluster's blocks share a
# GPC, and 132 SMs do not split evenly into clusters of 3 to 8.
H100_CAPACITY = {**{(s, 1): n for s, n in
                    {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}.items()},
                 **{(s, 2): n for s, n in
                    {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30}.items()}}


def test_int8_matmul_plan_fills_whole_waves_with_whole_chunks():
    """The launch plan covers K with at most 8 non-empty 128-deep splits (a
    tile's splits are one thread block cluster), is a pure function of its
    arguments, keeps a big product of few tiles in one wave of what the card
    holds, and at the Llama-3-8B and Gemma-3-1B shapes picks the split
    counts that the card timed fastest."""
    shapes = [(K, N) for K, N, _ in (*MATMUL_SHAPES.values(), *GEMMA3_MATMUL_SHAPES.values())]
    for M in (1, 13, 32, 33, 64, 200):
        for K, N in shapes + [(200, 16), (136, 1008), (8, 48)]:
            splits, split_k = tmatmul.plan(M, K, N, 132, H100_CAPACITY)
            assert split_k % 128 == 0 and splits * split_k >= K > (splits - 1) * split_k
            assert 1 <= splits <= tmatmul.MAX_SPLITS
            assert (splits, split_k) == tmatmul.plan(M, K, N, 132, dict(H100_CAPACITY))
            rows = tmatmul.block_rows(M)
            tiles = -(-N // tmatmul.TILE_N) * -(-M // tmatmul.ROWS_PER_BLOCK)
            b = tmatmul.blocks_per_sm(rows, split_k // 128)
            if K >= 4096 and tiles <= 39:  # a big product of few tiles: one wave
                assert tiles <= H100_CAPACITY[(splits, b)], (M, K, N, splits)
    # Llama-3-8B at the int8-KV engine's 32 rows: q/o 32 tiles in 3 splits
    # (39 clusters of 3 fit at one block an SM), k/v 8 tiles in 8, gate/up
    # 112 tiles unsplit (one wave), down 32 tiles in 3
    plan = {label: tmatmul.plan(32, K, N, 132, H100_CAPACITY)
            for label, (K, N, _) in MATMUL_SHAPES.items()}
    assert plan == {"q/o 4096x4096": (3, 1408), "k/v 4096x1024": (8, 512),
                    "gate/up 4096x14336": (1, 4096), "down 14336x4096": (3, 4864)}
    # Gemma-3-1B: the small products split as far as their chunks allow
    plan = {label: tmatmul.plan(32, K, N, 132, H100_CAPACITY)
            for label, (K, N, _) in GEMMA3_MATMUL_SHAPES.items()}
    assert plan == {"q 1152x1024": (5, 256), "k/v 1152x256": (5, 256),
                    "gate/up 1152x6912": (2, 640), "o 1024x1152": (8, 128),
                    "down 6912x1152": (8, 896)}
    # shared memory decides the blocks an SM: two for 32 rows and a small x
    assert tmatmul.blocks_per_sm(32, 5) == 2 and tmatmul.blocks_per_sm(32, 11) == 1
    assert tmatmul.blocks_per_sm(64, 1) == 1
    # without the card's table, slots · b // S
    assert tmatmul.plan(32, 4096, 4096, 132) == tmatmul.plan(
        32, 4096, 4096, 132, {(s, b): 132 * b // s for s in range(1, 9) for b in (1, 2)})


# -- the "auto" KV policy -----------------------------------------------------


def test_kv_cache_dtype_auto_policy_matches_jax():
    """The three cases of tests/test_kv_int8.py:215-240 resolve alike:
    bf16 at short context with a roomy pool, int8 at long context, int8
    under pool pressure; the int8 pools are allocated."""

    def resolve(**kw):
        jargs = JaxEngineArgs(config=jconfig.tiny_config(), block_size=4, max_num_seqs=2,
                              kv_cache_dtype="auto", **kw)
        JaxRunner(jargs)
        targs = TorchEngineArgs(config=tconfig.tiny_config(), block_size=4, max_num_seqs=2,
                                kv_cache_dtype="auto", device="cpu", cuda_graphs=False, **kw)
        engine = TorchEngine(targs)
        assert targs.kv_cache_dtype == jargs.kv_cache_dtype
        return targs.kv_cache_dtype, engine.runner

    got, r = resolve(max_model_len=64, num_kv_blocks=64)
    assert got is None and isinstance(r.k_cache[0], torch.Tensor)
    got, r = resolve(max_model_len=1024, num_kv_blocks=1024)
    assert got == "int8" and tkv.is_quantized_pool(r.k_cache[0])
    c = tconfig.tiny_config()
    assert r.k_cache[0]["q8"].shape == (1024, 4, c.n_kv_heads, c.head_dim_)
    assert r.k_cache[0]["q8"].dtype == torch.int8
    assert r.k_cache[0]["s"].shape == (1024, c.n_kv_heads, 4)
    got, _ = resolve(max_model_len=64, num_kv_blocks=4)
    assert got == "int8"


def test_kv_quant_auto_ctx_knob_is_read_from_the_environment(monkeypatch):
    monkeypatch.setenv("DYN_TPU_KV_QUANT_AUTO_CTX", "2048")
    args = TorchEngineArgs(config=tconfig.tiny_config(), block_size=4, max_num_seqs=2,
                           max_model_len=1024, num_kv_blocks=1024, kv_cache_dtype="auto",
                           device="cpu", cuda_graphs=False)
    TorchEngine(args)
    assert args.kv_cache_dtype is None  # 1024 < 2048 and no pressure
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        TorchEngine(TorchEngineArgs(config=tconfig.tiny_config(), kv_cache_dtype="fp8",
                                    device="cpu", cuda_graphs=False))
