"""The port with int8 KV pools against the JAX package on the same weights,
on the CPU: the model (``forward_paged`` over a first chunk, later chunks
and ``decode_multi`` bursts) with float32 weights, then the engine with int8
weights and int8 KV — ``TorchEngine(device="cpu", quantization="int8",
kv_cache_dtype="int8")`` against ``JaxEngine`` with the same settings, the
fused layer off — whose greedy streams must be identical. Last, the fused
layer's gate refuses int8 KV pools.

Tolerances: logits 1e-4 (float32 sums in other orders; the int8 attention
folds the scales in at the TPU kernel's points where the JAX XLA path
dequantizes the pages first). Cache codes may differ by one code where a
key or value lands within float32 rounding of a code boundary; scales to
1e-6 relative.
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
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.ops.kv_quant import is_quantized_pool
from dynamo_tpu_torch.runtime import context as tcontext

T = torch.from_numpy


def _models(**over):
    jc = jconfig.tiny_config(**over)
    tc = tconfig.tiny_config(**over)
    params = jllama.init_params(jc, jax.random.PRNGKey(4))
    return jc, tc, params, params_from_jax(jax.tree.map(np.asarray, params), tc, "cpu")


def _assert_pools_agree(t_pools, j_pools):
    for tp, jp in zip(t_pools, j_pools):
        assert is_quantized_pool(tp)
        codes = tp["q8"].numpy().astype(np.int32) - np.asarray(jp["q8"]).astype(np.int32)
        assert np.abs(codes).max() <= 1
        assert (codes == 0).mean() > 0.999
        np.testing.assert_allclose(tp["s"].numpy(), np.asarray(jp["s"]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("over", [{}, dict(n_heads=4, n_kv_heads=2, head_dim=32, sliding_window=6,
                                           sliding_window_every=2, attn_logit_softcap=20.0)])
def test_forward_paged_and_decode_multi_with_int8_pools_match_jax(over):
    jc, tc, params, tp = _models(**over)
    rng = np.random.default_rng(1)
    B, NB, BS = 3, 40, 4
    tables = rng.permutation(NB)[: B * 8].reshape(B, 8).astype(np.int32)
    jk, jv = jllama.init_kv_cache(jc, NB, BS, layered=True, kv_dtype="int8")
    tk, tv = tllama.init_kv_cache(tc, NB, BS, "cpu", kv_dtype="int8")
    assert tk[0]["q8"].shape == jk[0]["q8"].shape and tk[0]["s"].shape == jk[0]["s"].shape
    start = np.zeros(B, np.int32)
    # a first chunk (dense attention, pools written), then chunks that read
    # the pages: C = 9 takes the chunk route, C = 2 the decode route
    for C, lens, first in ((11, [11, 7, 2], True), (9, [9, 4, 1], False), (2, [2, 2, 1], False)):
        toks = rng.integers(0, jc.vocab_size, (B, C)).astype(np.int32)
        lens = np.asarray(lens, np.int32)
        jl, jk, jv = jax.block_until_ready(jllama.forward_paged(
            params, jc, jnp.asarray(toks), jnp.asarray(start), jnp.asarray(lens),
            jnp.asarray(tables), jk, jv, first_chunk=first))
        tl, tk, tv = tllama.forward_paged(tp, tc, T(toks), T(start), T(lens), T(tables), tk, tv,
                                          first_chunk=first)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        _assert_pools_agree(tk, jk)
        _assert_pools_agree(tv, jv)
        start = start + lens

    # a greedy burst: row 2 inactive, row 1 past its table's capacity (32)
    pos = np.array([start[0], 30, 0], np.int32)
    active = np.array([1, 1, 0], np.int32)
    tok0 = np.array([5, 9, 0], np.int32)
    zeros = np.zeros(B, np.float32)
    out = jax.block_until_ready(jllama.decode_multi(
        params, jc, jnp.asarray(tok0), jnp.asarray(pos), jnp.asarray(active), jnp.asarray(tables),
        jk, jv, jax.random.PRNGKey(0), jnp.asarray(zeros), jnp.zeros(B, jnp.int32),
        jnp.ones(B, jnp.float32), num_steps=5, salts=jnp.arange(B, dtype=jnp.int32),
        want_logprobs=True,
    ))
    t = tllama.decode_multi(
        tp, tc, T(tok0), T(pos), T(active), T(tables), tk, tv, 0, T(zeros),
        torch.zeros(B, dtype=torch.int32), torch.ones(B), num_steps=5, salts=torch.arange(B),
        want_logits=True,
    )
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(out[0]))
    t_logp = torch.log_softmax(t.logits, dim=-1).gather(-1, t.tokens[..., None])[..., 0]
    np.testing.assert_allclose(t_logp[:2].numpy(), np.asarray(out[1])[:2], atol=1e-4)
    assert bool(t.finite.all())
    _assert_pools_agree(tk, out[2])
    _assert_pools_agree(tv, out[3])


# -- engine ---------------------------------------------------------------

# A two-layer bf16 miniature at the 8B's head layout (head_dim 128, GQA 2).
CFG = dict(name="int8kv-mini", d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
           vocab_size=512, head_dim=128, rope_theta=10000.0)
ARGS = dict(block_size=16, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            prefill_chunk=32, decode_steps=4)
PROMPTS = [list(np.random.default_rng(20 + i).integers(3, 500, n)) for i, n in
           enumerate((12, 45, 9, 30))]  # 45 > prefill_chunk: a later chunk reads the pages


async def _serve(engine, proto, context):
    async def one(prompt, max_tokens=10):
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
        out.append(await one(PROMPTS[1], 14))  # a prefix hit: cached int8 pages
        return out
    finally:
        await engine.stop()


async def test_int8_weights_int8_kv_streams_match_jax_engine():
    jc = jconfig.ModelConfig(**CFG, dtype=jnp.bfloat16)
    tc = tconfig.ModelConfig(**CFG)
    q, _ = quantize_params(jllama.init_params(jc, jax.random.PRNGKey(6)))
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
    assert all(r == "length" for _, r in got) and len(got[-1][0]) == 14
    assert te.stats()["nonfinite_logit_rows"] == 0 and te.stats()["mk_fused_bursts"] == 0


def test_megakernel_gate_refuses_int8_kv():
    tc = tconfig.ModelConfig(**CFG)
    with pytest.raises(ValueError, match="int8 KV pools; the fused layer reads bf16 pools"):
        TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, quantization="int8",
                                    kv_cache_dtype="int8", use_megakernel=True, **ARGS))
    # None: the gate says no under int8 KV (and on the CPU)
    e = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, quantization="int8",
                                    kv_cache_dtype="int8", **ARGS))
    assert not e.runner.use_megakernel
    assert e.runner.k_cache[0]["q8"].dtype == torch.int8
    # the fused path itself refuses int8 pools rather than misreading them
    with pytest.raises(ValueError, match="bf16 pools"):
        tllama.forward_paged(e.runner.params, tc, torch.zeros(1, 1, dtype=torch.long),
                             torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
                             torch.zeros(1, 8, dtype=torch.int32), e.runner.k_cache,
                             e.runner.v_cache, use_megakernel=True)
