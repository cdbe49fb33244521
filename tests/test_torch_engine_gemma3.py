"""The Gemma-3 path of the port with int8 KV pools at head_dim 256 against the
JAX package, on the CPU: a Gemma-3 miniature (head_dim 256, 4 query heads and
1 KV head, qk-norm, dual-frequency RoPE, GeGLU, unit-offset norms,
post-norms, embedding scale, query_scale 256, a tied head, and a 24-key
window on two of its three layers, the third global).

1. ``paged_attention_ref`` over int8 pools at D 256 against both Pallas
   kernels in interpret mode: G 4, a window whose first visible key sits
   inside a page, a global case, and C·G > 64.
2. ``forward_paged`` (a first chunk, then chunks that read the pages) and
   ``decode_multi`` over int8 pools against the JAX functions on the same
   float32 weights, at contexts past the window.
3. ``TorchEngine(device="cpu", quantization="int8", kv_cache_dtype="int8")``
   greedy streams against ``JaxEngine`` with the same settings
   (``use_megakernel=False``) on the same int8 weights, with a prefix hit,
   token for token. The activations are float32: XLA on the CPU keeps bf16
   intermediates in float32 unless excess precision is off, so bf16
   streams of the two part at near ties (a bf16 miniature's first stream
   parted at its second token).

The miniature's embedding table is scaled by 0.1 from its init: at init
scale the √d-scaled embedding dominates the residual over the layers'
unit-RMS outputs, and the greedy stream only repeats its input token
whatever attention computes.

Tolerances: attention outputs 1e-4 against the Pallas kernels (as
tests/test_torch_kv_quant.py: float32 with the scales folded in at the same
points, sums in other orders); logits 1e-4; cache codes within one code and
at least 99.9 % equal (as tests/test_torch_engine_int8kv.py: a value within
float32 rounding of a code boundary may land on either side); scales, each
a token head's absmax / 127, to 1e-5 relative, as
tests/test_torch_engine_gemma.py holds the bf16 pools at head_dim 256 (a
later layer's K and V carry the float32 rounding of the layers before
them: 2.4e-6 relative seen here); greedy tokens exact. Every JAX output is
awaited (``jax.block_until_ready``) before the port's step runs.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.quantize import quantize_params
from dynamo_tpu.ops.pallas.paged_attention import (
    paged_attention_decode_kernel,
    paged_attention_kernel,
)
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.ops.cuda import paged_attention as tkernels
from dynamo_tpu_torch.ops.kv_quant import is_quantized_pool
from dynamo_tpu_torch.runtime import context as tcontext

T = torch.from_numpy

WINDOW = 24
GEMMA3_MINI = dict(
    name="gemma3-mini", d_model=64, n_layers=3, n_heads=4, n_kv_heads=1, head_dim=256, d_ff=128,
    act_fn="gelu_tanh", rmsnorm_unit_offset=True, post_norms=True, embed_scale=True,
    qk_norm=True, query_scale=256.0, sliding_window=WINDOW, sliding_window_pattern=3,
    rope_theta=1000000.0, rope_local_theta=10000.0, tie_word_embeddings=True,
    max_position_embeddings=8192,
)


def _mini_tree(jc, seed):
    """The JAX miniature's weights as numpy: the embedding scaled by 0.1 and
    the norm weights moved off their init value (0 under unit offset, 1 for
    qk-norm) so that a missed offset or norm shows."""
    tree = jax.tree.map(np.asarray, jllama.init_params(jc, jax.random.PRNGKey(seed)))
    tree["embed"] = tree["embed"] * np.asarray(0.1, tree["embed"].dtype)
    rng = np.random.default_rng(seed)
    for key in ("attn_norm", "mlp_norm", "attn_post_norm", "mlp_post_norm", "q_norm", "k_norm"):
        w = tree["layers"][key]
        tree["layers"][key] = (w.astype(np.float32) + rng.standard_normal(w.shape) * 0.1
                               ).astype(w.dtype)
    return tree


# -- int8-pool attention at D 256 against the Pallas kernels --------------------

INT8_D256_CASES = [
    # seed, B, C, H, KH, BS, P, starts, lens, window
    (20, 3, 1, 4, 1, 8, 12, [0, 37, 70], [1, 1, 1], WINDOW),  # decode, G 4: key 14 in page 1
    (21, 3, 1, 4, 1, 16, 6, [0, 40, 90], [1, 1, 1], 0),  # decode, a global layer
    (22, 2, 3, 4, 1, 8, 12, [29, 61], [3, 3], WINDOW),  # decode route, C·G = 12
    (23, 2, 20, 4, 1, 8, 12, [45, 3], [20, 9], WINDOW),  # chunk, C·G = 80 > 64
    (24, 2, 17, 4, 1, 16, 6, [50, 0], [17, 17], 0),  # chunk, C·G = 68, global
]


def _int8_pool(rng, NB, BS, KH, D):
    return {"q8": rng.integers(-127, 128, (NB, BS, KH, D)).astype(np.int8),
            "s": rng.uniform(0.5, 1.5, (NB, KH, BS)).astype(np.float32) * (2.5 / 127)}


def _case(seed, B, C, H, KH, BS, P, starts, lens, D=256):
    rng = np.random.default_rng(seed)
    NB = B * P + 3
    return dict(
        q=rng.standard_normal((B, C, H, D)).astype(np.float32),
        k=_int8_pool(rng, NB, BS, KH, D), v=_int8_pool(rng, NB, BS, KH, D),
        tables=rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32),
        start=np.asarray(starts, np.int32), lens=np.asarray(lens, np.int32),
    )


def _args(c, wrap):
    pool = lambda p: {k: wrap(v) for k, v in p.items()}  # noqa: E731
    return (wrap(c["q"]), pool(c["k"]), pool(c["v"]), wrap(c["tables"]), wrap(c["start"]),
            wrap(c["lens"]))


def _assert_valid_rows(got, want, lens):
    for b, n in enumerate(lens):  # rows past a chunk length are padding
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seed,B,C,H,KH,BS,P,starts,lens,window", INT8_D256_CASES)
def test_int8_d256_plain_matches_both_pallas_kernels(seed, B, C, H, KH, BS, P, starts, lens,
                                                     window):
    """The chunk kernel on every case; the decode kernel where the routing
    sends it (C <= 8 and C·G <= 64). The wrappers on CPU tensors run the
    plain version, paged_attention_ref, and count no launch."""
    c = _case(seed, B, C, H, KH, BS, P, starts, lens)
    want = jax.block_until_ready(
        paged_attention_kernel(*_args(c, jnp.asarray), window, interpret=True))
    tkernels.reset_launch_counts()
    got = tkernels.paged_attention_chunk(*_args(c, T), window=window)
    _assert_valid_rows(got.numpy(), np.asarray(want), lens)
    if C <= 8 and C * (H // KH) <= 64:
        c = _case(seed, B, C, H, KH, BS, P, starts, [C] * B)
        q, k, v, tables, start, _ = _args(c, jnp.asarray)
        want = jax.block_until_ready(paged_attention_decode_kernel(
            q, k, v, tables, start, window, interpret=True, batch_block=B if B % 2 else 2))
        q, k, v, tables, start, _ = _args(c, T)
        got = tkernels.paged_attention_decode(q, k, v, tables, start, window=window)
        _assert_valid_rows(got.numpy(), np.asarray(want), [C] * B)
    assert not any(tkernels.int8_launch_counts.values())


# -- the model over int8 pools -------------------------------------------------


def _assert_pools_agree_then_sync(t_pools, j_pools):
    """Codes within one and scales close; then the port's pools take the
    JAX pools' codes and scales, so that the next step of both reads one
    history. A code on the other side of a rounding boundary is allowed,
    but carried on it moves every later row that reads it: one value code
    of the last layer off by one moved a later row's logits by 5.3e-4."""
    for tp, jp in zip(t_pools, j_pools):
        assert is_quantized_pool(tp)
        codes = tp["q8"].numpy().astype(np.int32) - np.asarray(jp["q8"]).astype(np.int32)
        assert np.abs(codes).max() <= 1
        assert (codes == 0).mean() > 0.999
        np.testing.assert_allclose(tp["s"].numpy(), np.asarray(jp["s"]), rtol=1e-5, atol=0)
        for name in ("q8", "s"):
            tp[name].copy_(T(np.array(jp[name])))


def test_forward_paged_and_decode_multi_with_int8_pools_match_jax_past_the_window():
    jc = jconfig.tiny_config(**GEMMA3_MINI)
    tc = tconfig.tiny_config(**GEMMA3_MINI)
    assert jc.layer_windows() == tc.layer_windows() == [WINDOW, WINDOW, 0]
    tree = _mini_tree(jc, 8)
    params = jax.tree.map(jnp.asarray, tree)
    tp = params_from_jax(tree, tc, "cpu")
    rng = np.random.default_rng(3)
    B, NB, BS, P = 3, 64, 4, 16
    tables = rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32)
    jk, jv = jllama.init_kv_cache(jc, NB, BS, layered=True, kv_dtype="int8")
    tk, tv = tllama.init_kv_cache(tc, NB, BS, "cpu", kv_dtype="int8")
    start = np.zeros(B, np.int32)
    # A first chunk longer than the window (dense attention, pools written),
    # then chunks that read the pages past it: C = 9 takes the chunk route,
    # C = 2 the decode route (C·G = 8).
    for C, lens, first in ((30, [30, 20, 5], True), (9, [9, 9, 3], False), (2, [2, 2, 1], False)):
        toks = rng.integers(0, jc.vocab_size, (B, C)).astype(np.int32)
        lens = np.asarray(lens, np.int32)
        jl, jk, jv = jax.block_until_ready(jllama.forward_paged(
            params, jc, jnp.asarray(toks), jnp.asarray(start), jnp.asarray(lens),
            jnp.asarray(tables), jk, jv, first_chunk=first))
        tl, tk, tv = tllama.forward_paged(tp, tc, T(toks), T(start), T(lens), T(tables), tk, tv,
                                          first_chunk=first)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        _assert_pools_agree_then_sync(tk, jk)
        _assert_pools_agree_then_sync(tv, jv)
        start = start + lens
    assert start.tolist() == [41, 31, 9]

    # A greedy burst from past the window: row 2 inactive, row 1 runs past
    # its table's capacity (64) and its overshoot writes are dropped.
    pos = np.array([start[0], 61, 0], np.int32)
    active = np.array([1, 1, 0], np.int32)
    tok0 = np.array([5, 9, 0], np.int32)
    zeros = np.zeros(B, np.float32)
    out = jax.block_until_ready(jllama.decode_multi(
        params, jc, jnp.asarray(tok0), jnp.asarray(pos), jnp.asarray(active), jnp.asarray(tables),
        jk, jv, jax.random.PRNGKey(0), jnp.asarray(zeros), jnp.zeros(B, jnp.int32),
        jnp.ones(B, jnp.float32), num_steps=6, salts=jnp.arange(B, dtype=jnp.int32),
        want_logprobs=True,
    ))
    t = tllama.decode_multi(
        tp, tc, T(tok0), T(pos), T(active), T(tables), tk, tv, 0, T(zeros),
        torch.zeros(B, dtype=torch.int32), torch.ones(B), num_steps=6, salts=torch.arange(B),
        want_logits=True,
    )
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(out[0]))
    t_logp = torch.log_softmax(t.logits, dim=-1).gather(-1, t.tokens[..., None])[..., 0]
    np.testing.assert_allclose(t_logp[:2].numpy(), np.asarray(out[1])[:2], atol=1e-4)
    assert bool(t.finite.all())
    _assert_pools_agree_then_sync(tk, out[2])
    _assert_pools_agree_then_sync(tv, out[3])


# -- engine ---------------------------------------------------------------

ARGS = dict(block_size=4, num_kv_blocks=96, max_num_seqs=4, max_model_len=8192,
            prefill_chunk=16, decode_steps=4)
PROMPTS = [list(np.random.default_rng(40 + i).integers(3, 500, n)) for i, n in
           enumerate((70, 12, 33, 9))]  # 70 > window + prefill_chunk


async def _serve(engine, proto, context):
    async def one(prompt, max_tokens=12):
        req = proto.PreprocessedRequest(
            token_ids=[int(t) for t in prompt], request_id="r",
            sampling=proto.SamplingOptions(temperature=0.0),
            stop=proto.StopConditions(max_tokens=max_tokens),
        )
        toks, reason = [], None
        async for out in engine.generate(req, context.Context()):
            assert out.error is None, out.error
            toks += out.token_ids
            reason = out.finish_reason
        return toks, reason.value

    try:
        out = await asyncio.gather(*(one(p) for p in PROMPTS))
        out.append(await one(PROMPTS[0], 20))  # a prefix hit: cached int8 pages past the window
        return out
    finally:
        await engine.stop()


async def test_int8_weights_int8_kv_streams_match_jax_engine_past_the_window():
    jc = jconfig.tiny_config(**GEMMA3_MINI)
    tc = tconfig.tiny_config(**GEMMA3_MINI)
    q, _ = quantize_params(jax.tree.map(jnp.asarray, _mini_tree(jc, 9)))
    q = jax.block_until_ready(q)
    je = JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=1, quantization="int8",
                                 kv_cache_dtype="int8", use_megakernel=False, **ARGS), params=q)
    te = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, quantization="int8",
                                     kv_cache_dtype="int8", **ARGS),
                     params=params_from_jax(jax.tree.map(np.asarray, q), tc, "cpu"))
    assert not te.runner.use_megakernel
    assert is_quantized_pool(te.runner.k_cache[0]) and is_quantized_pool(je.runner.k_cache[0])
    want = await _serve(je, jproto, jcontext)
    got = await _serve(te, tproto, tcontext)
    assert got == want
    assert [len(t) for t, _ in got] == [12, 12, 12, 12, 20]
    assert all(r == "length" for _, r in got)
    # the streams are not the input token repeated: attention shapes them
    assert all(len(set(t)) > 1 for t, _ in got)
    assert te.stats()["nonfinite_logit_rows"] == 0 and te.stats()["mk_fused_bursts"] == 0
    # the prefix hit prefilled only the tail past its cached blocks
    assert sum(map(len, PROMPTS)) < te.prefill_tokens < sum(map(len, PROMPTS)) + 8
