"""The port's ops (dynamo_tpu_torch/ops) against the JAX package's on the
same numpy inputs, on the CPU in float32.

Tolerances: 1e-5 for elementwise ops (rope, rms-norm, act), where the two
frameworks evaluate the same float32 expression; 1e-4 for attention, where
the float32 reductions run in different orders over up to a few hundred
keys. The Pallas kernels run in interpret mode, as tests/test_pallas_kernel.py
runs them; rows past a sequence's chunk length are padding and are not
compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.ops import attention as jattn
from dynamo_tpu.ops import rope as jrope
from dynamo_tpu.ops import sampling as jsampling
from dynamo_tpu.ops.pallas.paged_attention import (
    paged_attention_decode_kernel,
    paged_attention_kernel,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.ops import rope as trope
from dynamo_tpu_torch.ops import sampling as tsampling
from dynamo_tpu_torch.ops.cuda import paged_attention as tkernels

T = torch.from_numpy


def _np(x):
    return np.asarray(x)


# -- elementwise ----------------------------------------------------------


@pytest.mark.parametrize("head_dim,theta,scale", [(16, 10000.0, 1.0), (64, 1e6, 1.0), (32, 1e4, 8.0)])
def test_rope_matches_jax(head_dim, theta, scale):
    rng = np.random.default_rng(head_dim)
    pos = rng.integers(0, 5000, (3, 7)).astype(np.int32)
    x = rng.standard_normal((3, 7, 4, head_dim)).astype(np.float32)
    jc, js = jax.block_until_ready(jrope.rope_table(jnp.asarray(pos), head_dim, theta, scale))
    tc, ts = trope.rope_table(T(pos), head_dim, theta, scale)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=1e-5)
    want = jax.block_until_ready(jrope.apply_rope(jnp.asarray(x), jc, js))
    got = trope.apply_rope(T(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


@pytest.mark.parametrize("unit_offset", [False, True])
def test_rms_norm_matches_jax(unit_offset):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 96)) * 3).astype(np.float32)
    w = rng.standard_normal(96).astype(np.float32)
    want = jax.block_until_ready(
        jllama._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, unit_offset))
    got = tllama._rms_norm(T(x), T(w), 1e-6, unit_offset)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


def test_rms_norm_bf16_rounds_before_the_weight():
    """Cast to x's dtype, THEN multiply by w (llama.py:272-276): in bf16 the
    port must give the JAX package's bits."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jax.block_until_ready(
        jllama._rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1e-5))
    got = tllama._rms_norm(T(x).bfloat16(), T(w).bfloat16(), 1e-5)
    np.testing.assert_array_equal(got.float().numpy(), _np(want.astype(jnp.float32)))


@pytest.mark.parametrize("act_fn", ["silu", "gelu_tanh"])
def test_act_matches_jax(act_fn):
    x = np.linspace(-6, 6, 301, dtype=np.float32)
    want = jax.block_until_ready(jllama._act(jnp.asarray(x), act_fn))
    got = tllama._act(T(x), act_fn)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


@pytest.mark.parametrize("spec,xs,ws", [
    ("bcd,dh->bch", (2, 3, 8), (8, 5)),  # the model's products (matmul path)
    ("bch,hd->bcd", (2, 3, 5), (5, 8)),
    ("bcd,hd->bch", (2, 3, 8), (5, 8)),  # not a plain product: einsum path
])
def test_qeinsum_matches_jax(spec, xs, ws):
    from dynamo_tpu.ops import quant as jquant
    from dynamo_tpu_torch.ops import quant as tquant

    rng = np.random.default_rng(len(spec))
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    want = jax.block_until_ready(jquant.qeinsum(spec, jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(tquant.qeinsum(spec, T(x), T(w)).numpy(), _np(want), atol=1e-5)


# -- cache writes ---------------------------------------------------------


def test_write_chunk_to_cache_drops_padding_and_overshoot():
    """Padding positions (c >= chunk_lens) and positions past the table's
    capacity are dropped, never clamped onto a live page."""
    rng = np.random.default_rng(5)
    NB, BS, KH, D = 12, 4, 2, 8
    cache = rng.standard_normal((NB, BS, KH, D)).astype(np.float32)
    B, C, P = 3, 6, 2  # capacity 8 tokens per row
    chunk = rng.standard_normal((B, C, KH, D)).astype(np.float32)
    tables = np.array([[3, 7], [1, 10], [5, 0]], np.int32)
    start = np.array([0, 5, 6], np.int32)  # row 1: 5..10 crosses capacity 8
    lens = np.array([4, 6, 1], np.int32)  # row 0 padding past 4
    want = jax.block_until_ready(jattn.write_chunk_to_cache(
        jnp.asarray(cache), jnp.asarray(chunk), jnp.asarray(tables), jnp.asarray(start),
        jnp.asarray(lens)))
    got = tattn.write_chunk_to_cache(tattn.copy_to_sink_pool(T(cache)), T(chunk), T(tables),
                                     T(start), T(lens))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    # Row 0 writes positions 0..3 (block 3); row 1 positions 5..7 (block 10
    # slots 1..3) — 8..10 lie past its capacity and are dropped, not clamped
    # onto slot 3; row 2 position 6 (block 0 slot 2).
    changed = {tuple(ix) for ix in np.argwhere((got.numpy() != cache).any(axis=(2, 3)))}
    assert changed == {(3, 0), (3, 1), (3, 2), (3, 3), (10, 1), (10, 2), (10, 3), (0, 2)}


# -- attention ------------------------------------------------------------


def _paged_case(seed, B, C, H, KH, D, BS, P, starts, lens):
    rng = np.random.default_rng(seed)
    NB = B * P + 3
    return dict(
        q=rng.standard_normal((B, C, H, D)).astype(np.float32),
        k=rng.standard_normal((NB, BS, KH, D)).astype(np.float32),
        v=rng.standard_normal((NB, BS, KH, D)).astype(np.float32),
        tables=rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32),
        start=np.asarray(starts, np.int32),
        lens=np.asarray(lens, np.int32),
    )


def _torch_args(c):
    return T(c["q"]), T(c["k"]), T(c["v"]), T(c["tables"]), T(c["start"]), T(c["lens"])


def _jax_args(c):
    return tuple(jnp.asarray(c[n]) for n in ("q", "k", "v", "tables", "start", "lens"))


def _assert_valid_rows(got, want, lens, atol=1e-4):
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=atol, rtol=1e-4)


PAGED_CASES = [
    # seed, B, C, H, KH, D, BS, P, starts, lens, window, cap
    (0, 3, 1, 14, 2, 64, 16, 5, [0, 37, 70], [1, 1, 1], 0, 0.0),  # decode, G=7
    (1, 2, 5, 14, 2, 64, 16, 5, [3, 60], [5, 5], 0, 0.0),  # C <= 8, G=7
    (2, 3, 8, 8, 8, 32, 8, 6, [0, 13, 30], [8, 3, 6], 0, 0.0),  # ragged chunk
    (3, 2, 24, 14, 2, 64, 16, 5, [16, 40], [24, 9], 0, 0.0),  # C*G > 64
    (4, 3, 4, 14, 2, 64, 16, 5, [10, 33, 70], [4, 4, 2], 12, 0.0),  # window
    (5, 2, 6, 8, 2, 32, 8, 8, [5, 40], [6, 6], 0, 5.0),  # softcap
    (6, 2, 7, 8, 2, 32, 8, 8, [20, 41], [7, 4], 9, 5.0),  # both
]


@pytest.mark.parametrize("seed,B,C,H,KH,D,BS,P,starts,lens,window,cap", PAGED_CASES)
def test_paged_attention_ref_matches_xla(seed, B, C, H, KH, D, BS, P, starts, lens, window, cap):
    c = _paged_case(seed, B, C, H, KH, D, BS, P, starts, lens)
    want = jax.block_until_ready(jattn._paged_attention_xla(*_jax_args(c), window, logit_cap=cap))
    got = tattn.paged_attention_ref(*_torch_args(c), window=window, logit_cap=cap)
    _assert_valid_rows(got.numpy(), _np(want), lens)
    # paged_attention on CPU tensors routes through the wrappers' plain path
    routed = tattn.paged_attention(*_torch_args(c), window=window, logit_cap=cap)
    _assert_valid_rows(routed.numpy(), _np(want), lens)


@pytest.mark.parametrize("seed,B,C,H,KH,D,BS,P,starts,lens,window,cap",
                         [c for c in PAGED_CASES if c[2] <= 8 and c[2] * (c[3] // c[4]) <= 64])
def test_decode_plain_matches_pallas_decode_kernel(seed, B, C, H, KH, D, BS, P, starts, lens, window, cap):
    c = _paged_case(seed, B, C, H, KH, D, BS, P, starts, [C] * B)
    q, k, v, tables, start, _ = _jax_args(c)
    want = jax.block_until_ready(paged_attention_decode_kernel(
        q, k, v, tables, start, window, interpret=True, batch_block=2, logit_cap=cap))
    q_t, k_t, v_t, tables_t, start_t, _ = _torch_args(c)
    got = tkernels.paged_attention_decode(q_t, k_t, v_t, tables_t, start_t,
                                          window=window, logit_cap=cap)
    _assert_valid_rows(got.numpy(), _np(want), [C] * B)


@pytest.mark.parametrize("seed,B,C,H,KH,D,BS,P,starts,lens,window,cap", PAGED_CASES)
def test_chunk_plain_matches_pallas_chunk_kernel(seed, B, C, H, KH, D, BS, P, starts, lens, window, cap):
    c = _paged_case(seed, B, C, H, KH, D, BS, P, starts, lens)
    want = jax.block_until_ready(
        paged_attention_kernel(*_jax_args(c), window, interpret=True, logit_cap=cap))
    got = tkernels.paged_attention_chunk(*_torch_args(c), window=window, logit_cap=cap)
    _assert_valid_rows(got.numpy(), _np(want), lens)


def test_routing_matches_jax_rule(monkeypatch):
    """C <= 8 and C*G <= 64 → decode kernel, else the chunk kernel
    (attention.py:95-121); on CPU no launch is counted."""
    calls = []
    real_d, real_c = tkernels.paged_attention_decode, tkernels.paged_attention_chunk
    monkeypatch.setattr(tkernels, "paged_attention_decode",
                        lambda *a, **k: calls.append("decode") or real_d(*a, **k))
    monkeypatch.setattr(tkernels, "paged_attention_chunk",
                        lambda *a, **k: calls.append("chunk") or real_c(*a, **k))
    tkernels.reset_launch_counts()
    for C, H, KH, want in [(1, 14, 2, "decode"), (8, 16, 2, "decode"), (9, 2, 2, "chunk"),
                           (5, 14, 1, "chunk"), (5, 32, 2, "chunk"), (4, 32, 2, "decode")]:
        c = _paged_case(0, 2, C, H, KH, 32, 8, 4, [3, 10], [C, C])
        tattn.paged_attention(*_torch_args(c))
        assert calls[-1] == want, (C, H, KH)
    assert tkernels.launch_counts == {"paged_attention_decode": 0, "paged_attention_chunk": 0}


@pytest.mark.parametrize("H,KH,window,cap", [(4, 4, 0, 0.0), (14, 2, 0, 0.0), (4, 4, 5, 0.0), (8, 2, 3, 30.0)])
def test_dense_chunk_attention_matches_jax(H, KH, window, cap):
    rng = np.random.default_rng(H + window)
    B, C, D = 3, 16, 32
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    k = rng.standard_normal((B, C, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, C, KH, D)).astype(np.float32)
    lens = np.array([16, 9, 1], np.int32)
    want = jax.block_until_ready(jattn.dense_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), window=window,
        logit_cap=cap))
    got = tattn.dense_chunk_attention(T(q), T(k), T(v), T(lens), window=window, logit_cap=cap)
    _assert_valid_rows(got.numpy(), _np(want), lens)
    assert torch.isfinite(got).all()  # padding rows stay finite (the -1e30 sentinel)


# -- sampling -------------------------------------------------------------


def _sample_both(logits, temp, topk, topp, minp=None, seed=0, salts=None, pos=None):
    B = logits.shape[0]
    salts = np.arange(B, dtype=np.int32) if salts is None else salts
    pos = np.full(B, 5, np.int32) if pos is None else pos
    jkeys = jsampling.fold_row_keys(jax.random.PRNGKey(seed), jnp.asarray(salts), jnp.asarray(pos))
    want = jax.block_until_ready(jsampling.sample_tokens(
        jnp.asarray(logits), None, jnp.asarray(temp), jnp.asarray(topk), jnp.asarray(topp),
        None if minp is None else jnp.asarray(minp), row_keys=jkeys,
    ))
    tkeys = tsampling.fold_row_keys(seed, T(salts), T(pos))
    got = tsampling.sample_tokens(T(logits), T(temp), T(topk), T(topp),
                                  None if minp is None else T(minp), row_keys=tkeys)
    return got.numpy(), _np(want)


def test_greedy_sampling_matches_jax_exactly():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((6, 1000)).astype(np.float32)
    logits[2, 10] = logits[2, 500] = logits[2].max() + 1.0  # tie: first index wins
    zeros = np.zeros(6, np.float32)
    got, want = _sample_both(logits, zeros, np.zeros(6, np.int32), np.ones(6, np.float32))
    np.testing.assert_array_equal(got, want)
    assert got[2] == 10


@pytest.mark.parametrize("filt", ["top_k", "top_p", "min_p"])
def test_filters_that_leave_one_candidate_agree(filt):
    """Each filter set so that one candidate survives: both packages must
    pick it, whatever their noise."""
    rng = np.random.default_rng(9)
    B, V = 8, 300
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    temp = np.ones(B, np.float32)
    topk = np.zeros(B, np.int32)
    topp = np.ones(B, np.float32)
    minp = None
    if filt == "top_k":
        topk[:] = 1
    elif filt == "top_p":
        topp[:] = 1e-6
    else:
        minp = np.ones(B, np.float32)
    for seed in range(3):
        got, want = _sample_both(logits, temp, topk, topp, minp, seed=seed)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, logits.argmax(-1))


def test_sampling_noise_is_a_function_of_seed_salt_and_position():
    salts = T(np.array([0, 1, 2, 3], np.int32))
    pos = T(np.array([7, 7, 9, 9], np.int32))
    a = tsampling.row_gumbel(tsampling.fold_row_keys(3, salts, pos), 64)
    b = tsampling.row_gumbel(tsampling.fold_row_keys(3, salts, pos), 64)
    assert torch.equal(a, b)
    # one row alone draws what it drew inside the batch
    solo = tsampling.row_gumbel(tsampling.fold_row_keys(3, salts[2:3], pos[2:3]), 64)
    assert torch.equal(solo[0], a[2])
    # another seed, salt or position draws other noise
    assert not torch.equal(tsampling.row_gumbel(tsampling.fold_row_keys(4, salts, pos), 64), a)
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[2], a[3])
    pos2 = T(np.array([8, 7, 9, 9], np.int32))
    c = tsampling.row_gumbel(tsampling.fold_row_keys(3, salts, pos2), 64)
    assert not torch.equal(c[0], a[0]) and torch.equal(c[1:], a[1:])
    # Gumbel-shaped: mean near the Euler-Mascheroni constant
    many = tsampling.row_gumbel(tsampling.fold_row_keys(0, torch.arange(2000), torch.zeros(2000)), 64)
    assert torch.isfinite(many).all()
    assert abs(float(many.mean()) - 0.5772) < 0.02


def test_temperature_sampling_follows_the_distribution():
    """Sampled rows at temperature 1 over two candidates land in proportion
    to their probabilities (the noise is Gumbel; bits differ from JAX)."""
    n = 4000
    logits = torch.full((n, 50), -30.0)
    logits[:, 3] = 0.0
    logits[:, 7] = float(np.log(3.0))  # p = 0.75
    keys = tsampling.fold_row_keys(1, torch.arange(n), torch.full((n,), 11))
    toks = tsampling.sample_tokens(logits, torch.ones(n), torch.zeros(n, dtype=torch.int32),
                                   torch.ones(n), row_keys=keys)
    frac = float((toks == 7).float().mean())
    assert abs(frac - 0.75) < 0.03
    assert set(toks.tolist()) <= {3, 7}
