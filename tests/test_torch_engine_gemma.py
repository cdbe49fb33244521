"""The Gemma-2 path of the port at head_dim 256 against the JAX package, on
the CPU in float32: a Gemma-2 miniature (head_dim 256, 4 query and 2 KV
heads, GeGLU, unit-offset norms, post-norms, embedding scale, softcaps
50/30, query_scale 256, a 24-key window on every other layer).

1. ``forward_paged`` (a first chunk, then chunks that read the pages) and
   ``decode_multi`` against the JAX functions on the same weights
   (``params_from_jax``), at contexts past the window, so that it masks in
   a later chunk and in decode.
2. ``TorchEngine(device="cpu")`` greedy streams against
   ``JaxEngine(pipeline_depth=1)``, token for token, at the model's own
   ``max_model_len`` (8,192); a 70-token prompt is prefilled in five chunks
   of 16, so the window masks inside later chunks and in decode.
3. ``paged_attention_ref`` at D 256 against both Pallas kernels in
   interpret mode, with window and softcap.

Tolerances: 1e-4 on logits and attention outputs (float32 sums in other
orders over up to a few hundred terms, as tests/test_torch_llama.py and
tests/test_torch_ops.py); the K/V pools to 1e-5 absolute plus 1e-5
relative (later layers' K and V, up to ~6 in size, carry the float32
rounding of the layers before them: 1.03e-5 at 2.2 seen); greedy tokens
exact.
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
from dynamo_tpu_torch.runtime import context as tcontext

T = torch.from_numpy

WINDOW = 24
GEMMA2_MINI = dict(
    name="gemma2-mini", d_model=64, n_layers=4, n_heads=4, n_kv_heads=2, head_dim=256, d_ff=128,
    act_fn="gelu_tanh", rmsnorm_unit_offset=True, post_norms=True, embed_scale=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0, query_scale=256.0,
    sliding_window=WINDOW, sliding_window_every=2, tie_word_embeddings=True,
    rope_theta=10000.0, max_position_embeddings=8192,
)


@pytest.fixture(scope="module")
def models():
    """Both configs and the JAX weights, with the norm weights moved off
    their init value (0 under unit offset) so that a missed offset shows."""
    jc = jconfig.tiny_config(**GEMMA2_MINI)
    tc = tconfig.tiny_config(**GEMMA2_MINI)
    assert jc.layer_windows() == tc.layer_windows() == [WINDOW, 0, WINDOW, 0]
    tree = jax.tree.map(np.asarray, jllama.init_params(jc, jax.random.PRNGKey(7)))
    rng = np.random.default_rng(0)
    for key in ("attn_norm", "mlp_norm", "attn_post_norm", "mlp_post_norm"):
        tree["layers"][key] = tree["layers"][key] + (
            rng.standard_normal(tree["layers"][key].shape) * 0.1).astype(np.float32)
    tree["final_norm"] = tree["final_norm"] + (
        rng.standard_normal(tree["final_norm"].shape) * 0.1).astype(np.float32)
    return jc, tc, jax.tree.map(jnp.asarray, tree), tree


def test_forward_paged_and_decode_multi_match_jax_past_the_window(models):
    """Each JAX step has finished before the port's step runs: with JAX's
    asynchronous dispatch still computing beside it, the port's first-chunk
    logits were seen to move by up to 6e-4 in about one process of 16."""
    jc, tc, params, tree = models
    tp = params_from_jax(tree, tc, "cpu")
    rng = np.random.default_rng(1)
    B, NB, BS, P = 3, 64, 4, 16
    tables = rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32)
    jk, jv = jllama.init_kv_cache(jc, NB, BS, layered=True)
    tk, tv = tllama.init_kv_cache(tc, NB, BS, "cpu")
    start = np.zeros(B, np.int32)
    # A first chunk longer than the window (dense attention), then chunks
    # that read the pages past it: C = 9 takes the chunk route, C = 2 the
    # decode route (C·G = 4).
    for C, lens, first in ((30, [30, 20, 5], True), (9, [9, 9, 3], False), (2, [2, 2, 1], False)):
        toks = rng.integers(0, jc.vocab_size, (B, C)).astype(np.int32)
        lens = np.asarray(lens, np.int32)
        jl, jk, jv = jax.block_until_ready(jllama.forward_paged(
            params, jc, jnp.asarray(toks), jnp.asarray(start), jnp.asarray(lens),
            jnp.asarray(tables), jk, jv, first_chunk=first))
        tl, tk, tv = tllama.forward_paged(tp, tc, T(toks), T(start), T(lens), T(tables), tk, tv,
                                          first_chunk=first)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        assert (tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)).all()
        for l in range(jc.n_layers):
            np.testing.assert_allclose(tk[l].numpy(), np.asarray(jk[l]), atol=1e-5, rtol=1e-5)
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
    for l in range(jc.n_layers):
        np.testing.assert_allclose(tk[l].numpy(), np.asarray(out[2][l]), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tv[l].numpy(), np.asarray(out[3][l]), atol=1e-5, rtol=1e-5)


# -- engine ---------------------------------------------------------------

ARGS = dict(block_size=4, num_kv_blocks=96, max_num_seqs=4, max_model_len=8192,
            prefill_chunk=16, decode_steps=4)
PROMPTS = [list(np.random.default_rng(30 + i).integers(3, 500, n)) for i, n in
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
        out.append(await one(PROMPTS[0], 20))  # a prefix hit: its pages reread past the window
        return out
    finally:
        await engine.stop()


async def test_greedy_streams_match_jax_engine_past_the_window(models):
    jc, tc, params, tree = models
    je = JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=1, **ARGS), params=params)
    te = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, **ARGS),
                     params=params_from_jax(tree, tc, "cpu"))
    assert not te.runner.use_megakernel
    want = await _serve(je, jproto, jcontext)
    got = await _serve(te, tproto, tcontext)
    assert got == want
    assert [len(t) for t, _ in got] == [12, 12, 12, 12, 20]
    assert all(r == "length" for _, r in got)
    assert te.stats()["nonfinite_logit_rows"] == 0
    # the prefix hit prefilled only the tail past its cached blocks
    assert sum(map(len, PROMPTS)) < te.prefill_tokens < sum(map(len, PROMPTS)) + 8


# -- the plain version at D 256 against the Pallas kernels ---------------------

D256_CASES = [
    # seed, B, C, H, KH, BS, P, starts, lens, window, cap
    (0, 3, 1, 4, 2, 16, 6, [0, 37, 70], [1, 1, 1], 0, 0.0),  # decode, G 2
    (1, 3, 2, 4, 2, 16, 6, [20, 37, 70], [2, 2, 2], WINDOW, 50.0),  # decode route, window
    (2, 2, 4, 4, 1, 8, 10, [5, 61], [4, 4], WINDOW, 0.0),  # Gemma-3 heads (G 4)
    (3, 3, 20, 4, 2, 16, 6, [0, 30, 60], [20, 11, 1], WINDOW, 50.0),  # chunk, window
    (4, 2, 17, 4, 1, 8, 10, [40, 3], [17, 9], WINDOW, 30.0),  # chunk, C·G = 68
]


def _case(seed, B, C, H, KH, BS, P, starts, lens, D=256):
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


def _args(c, wrap):
    return tuple(wrap(c[n]) for n in ("q", "k", "v", "tables", "start", "lens"))


def _assert_valid_rows(got, want, lens):
    for b, n in enumerate(lens):  # rows past a chunk length are padding
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seed,B,C,H,KH,BS,P,starts,lens,window,cap", D256_CASES)
def test_d256_plain_matches_both_pallas_kernels(seed, B, C, H, KH, BS, P, starts, lens, window,
                                                cap):
    """The chunk kernel on every case; the decode kernel where the JAX
    routing sends it (C <= 8 and C·G <= 64). The wrappers on CPU tensors run
    the plain version, paged_attention_ref."""
    c = _case(seed, B, C, H, KH, BS, P, starts, lens)
    got = tkernels.paged_attention_chunk(*_args(c, T), window=window, logit_cap=cap).numpy()
    want = paged_attention_kernel(*_args(c, jnp.asarray), window, interpret=True, logit_cap=cap)
    _assert_valid_rows(got, np.asarray(want), lens)
    if C <= 8 and C * (H // KH) <= 64:
        c = _case(seed, B, C, H, KH, BS, P, starts, [C] * B)
        q, k, v, tables, start, _ = _args(c, jnp.asarray)
        want = np.asarray(paged_attention_decode_kernel(q, k, v, tables, start, window,
                                                        interpret=True, batch_block=2,
                                                        logit_cap=cap))
        q, k, v, tables, start, _ = _args(c, T)
        got = tkernels.paged_attention_decode(q, k, v, tables, start, window=window,
                                              logit_cap=cap)
        _assert_valid_rows(got.numpy(), want, [C] * B)
