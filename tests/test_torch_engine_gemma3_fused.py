"""Gemma-3 with int8 weights over bf16 pools through the fused decoder layer
(ROADMAP A1) on the CPU: a Gemma-3 miniature at head_dim 256 (4 query heads
and 1 KV head, qk-norm, dual-frequency RoPE with the local table on the
windowed layers, GeGLU, unit-offset norms, post-norms, embedding scale,
query_scale 256, a tied int8 head, and a 24-key window on two of its three
layers) served by ``TorchEngine(device="cpu", quantization="int8",
use_megakernel=True)`` at pipeline depth 2, whose decode takes the fused
layer's plain version (ops/fused_layer.fused_decoder_layer_ref) every
step.

Its greedy streams, over contexts that straddle the window (a window's
first visible key inside a page of 8), are held token for token, each
token's logprob within a stated tolerance, against ``JaxEngine`` with its
megakernel gate on (the Pallas fused layer, in interpret mode, compiled
with XLA's excess precision off as the TPU rounds) on the same int8
weights, and against the port's own unfused decode
(``use_megakernel=False``) on the same weights, up to a near tie
(``_agree``): with bf16 activations this random model is chaotic, and two
streams computed in other summation orders part at the first step whose
best tokens lie within the tolerance; each stream may part there once, and
at least half of all tokens are compared exactly. Fused bursts are
counted. The miniature's embedding is
scaled by 0.1 × EMBED_SCALE and its norms moved off their init values
(tests/test_torch_engine_gemma3.py), its final norm's gain HEAD_GAIN:
attention decides the stream, and a missed offset or norm shows.
"""

import asyncio
import contextlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models.quantize import quantize_params
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.runtime import context as tcontext

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_engine_gemma3 import GEMMA3_MINI, _mini_tree  # noqa: E402

# The fused layer needs d_model and d_ff in 128-column tiles and bf16 pools.
MINI = dict(GEMMA3_MINI, name="gemma3-fused-mini", d_model=256, d_ff=512)
ARGS = dict(block_size=8, num_kv_blocks=96, max_num_seqs=4, max_model_len=160,
            prefill_chunk=32, decode_steps=4)
# 10 tokens decode from inside the window across its edge; 45 and 70
# prefill past it (in chunks of 32) and decode with the window's first key
# inside a page
PROMPTS = [[int(t) for t in np.random.default_rng(40 + i).integers(3, 500, n)]
           for i, n in enumerate((10, 45, 70, 19))]
MAX_TOKENS = 24
# times _mini_tree's 0.1: at d_model 256 the √d-scaled embedding still
# decided every greedy token (each stream repeated its input token)
EMBED_SCALE = 0.1
# the final norm's gain: with the tied head, the small embedding would
# leave the logits within a few tenths of each other
HEAD_GAIN = 8.0
# logprob tolerances. Against JAX's kernel (the same rounding points, XLA's
# excess precision off): the sums run in other orders, so a bf16
# intermediate may round to its neighbour (2^-8 relative) and the logits,
# bf16 products times the head's gain, move by up to ~0.045 (measured).
# Against the unfused layers, which round elsewhere (the fused layer keeps
# q, k and v in float32 through qk-norm and RoPE): up to ~0.13.
TOL_JAX, TOL_UNFUSED = 0.05, 0.15


@contextlib.contextmanager
def _strict_jit():
    """While on, every top-level ``jax.jit`` call the JAX engine makes is
    compiled with XLA's excess precision off (as tests/test_torch_fused_layer.py
    compiles the kernel): on the CPU XLA otherwise keeps bf16 intermediates
    in float32, where the TPU kernel (and the port) round them. Calls traced
    inside another jit are left to it."""
    real = jax.jit

    def jit(fn=None, **kw):
        if fn is None:
            return lambda f: jit(f, **kw)
        jitted, compiled = real(fn, **kw), {}

        def call(*args, **kwargs):
            leaves, tree = jax.tree.flatten((args, kwargs))
            if any(isinstance(x, jax.core.Tracer) for x in leaves):
                return jitted(*args, **kwargs)
            key = (tree, tuple((x.shape, str(x.dtype)) if hasattr(x, "shape") else x
                               for x in leaves))
            if key not in compiled:
                compiled[key] = jitted.lower(*args, **kwargs).compile(
                    compiler_options={"xla_allow_excess_precision": False})
            return compiled[key](*args, **kwargs)

        return call

    jax.jit = jit
    try:
        yield
    finally:
        jax.jit = real


async def _serve(engine, proto, context):
    """Each prompt's greedy stream and, a token, its logprob and the top 5
    ((id, logprob) pairs)."""
    async def one(prompt):
        req = proto.PreprocessedRequest(
            token_ids=list(prompt), request_id="r",
            sampling=proto.SamplingOptions(temperature=0.0, logprobs=5),
            stop=proto.StopConditions(max_tokens=MAX_TOKENS))
        toks, logprobs = [], []
        async for out in engine.generate(req, context.Context()):
            assert out.error is None, out.error
            toks += out.token_ids
            logprobs += [[(e.token_id, e.logprob) for e in entry] for entry in out.logprobs]
        return toks, logprobs

    try:
        return await asyncio.gather(*(one(p) for p in PROMPTS))
    finally:
        await engine.stop()


def _agree(got, want, tol):
    """Tokens of ``got``'s streams equal to ``want``'s before they part. The
    two agree token for token, each token's logprob within TOL, until a
    step whose top two ``want`` ranks within TOL of each other (a near tie:
    bf16 activations rounded in other orders may pick either); there the
    token ``got`` picks is one of those two, and the comparison of that
    stream ends (the model is chaotic past it)."""
    same = 0
    for (g, glp), (w, wlp) in zip(got, want):
        assert len(g) == len(w) == MAX_TOKENS
        for k in range(MAX_TOKENS):
            top = dict(wlp[k][1:])
            if g[k] != w[k]:
                assert g[k] in top and top[w[k]] - top[g[k]] <= tol, (k, g[k], w[k], top)
                break
            assert abs(glp[k][0][1] - wlp[k][0][1]) <= tol, (k, glp[k], wlp[k])
            same += 1
    return same


async def test_gemma3_int8_fused_over_bf16_pools_matches_jax_megakernel_and_unfused():
    jc = jconfig.tiny_config(**MINI, dtype=jnp.bfloat16)
    tc = tconfig.tiny_config(**MINI, dtype=tconfig.ModelConfig().dtype)
    tree = _mini_tree(jc, 5)
    tree["embed"] = tree["embed"] * np.asarray(EMBED_SCALE, tree["embed"].dtype)
    tree["final_norm"] = np.full_like(tree["final_norm"], HEAD_GAIN - 1.0)  # unit offset
    q, _ = quantize_params(jax.tree.map(jnp.asarray, tree))
    q = jax.block_until_ready(q)
    tree = jax.tree.map(np.asarray, q)
    with _strict_jit():
        je = JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=2, quantization="int8",
                                     use_megakernel=True, **ARGS), params=q)
        assert je.runner.use_megakernel
        want = await _serve(je, jproto, jcontext)

    got = {}
    for fused in (True, False):
        te = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                         quantization="int8", use_megakernel=fused, **ARGS),
                         params=params_from_jax(tree, tc, "cpu"))
        assert te.runner.use_megakernel == fused
        got[fused] = await _serve(te, tproto, tcontext)
        stats = te.stats()
        assert stats["nonfinite_logit_rows"] == 0
        assert (stats["mk_fused_bursts"] > 0) == fused
    assert je.stats()["mk_fused_bursts"] > 0
    # most tokens are compared exactly (a stream parts at most once)
    total = MAX_TOKENS * len(PROMPTS)
    assert _agree(got[True], want, TOL_JAX) >= total // 2
    assert _agree(got[False], got[True], TOL_UNFUSED) >= total // 2
    # attention shapes the streams: they are not one token repeated
    assert all(len(set(toks)) >= 4 for toks, _ in want), want
