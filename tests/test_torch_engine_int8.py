"""TorchEngine with int8 weights through the fused decoder layer
(device="cpu": the layer's plain version) against JaxEngine's int8 XLA path
on the same weights: greedy streams must be identical. Then the gate: an
ineligible config with use_megakernel=True raises instead of running
another path, and only int8 quantization is taken."""

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
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.runtime import context as tcontext

# A two-layer miniature the fused layer takes (head_dim 128, GQA 2).
CFG = dict(name="int8-mini", d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
           vocab_size=512, head_dim=128, rope_theta=10000.0)
ARGS = dict(block_size=16, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            prefill_chunk=32, decode_steps=4)
PROMPTS = [list(np.random.default_rng(i).integers(3, 500, n)) for i, n in enumerate((12, 45, 9))]


async def _serve(engine, proto, context):
    async def one(prompt):
        req = proto.PreprocessedRequest(
            token_ids=[int(t) for t in prompt], request_id="r",
            sampling=proto.SamplingOptions(temperature=0.0),
            stop=proto.StopConditions(max_tokens=10),
        )
        toks, reason = [], None
        async for out in engine.generate(req, context.Context()):
            assert out.error is None, out.error
            toks += out.token_ids
            reason = out.finish_reason
        return toks, reason.value

    try:
        return await asyncio.gather(*(one(p) for p in PROMPTS))
    finally:
        await engine.stop()


async def test_int8_fused_layer_streams_match_jax_engine():
    jc = jconfig.ModelConfig(**CFG, dtype=jnp.bfloat16)
    tc = tconfig.ModelConfig(**CFG)
    q, _ = quantize_params(jllama.init_params(jc, jax.random.PRNGKey(3)))
    je = JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=1, quantization="int8",
                                 use_megakernel=False, **ARGS), params=q)
    te = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, quantization="int8",
                                     use_megakernel=True, **ARGS),
                     params=params_from_jax(jax.tree.map(np.asarray, q), tc, "cpu"))
    assert te.runner.use_megakernel and not je.runner.use_megakernel
    want = await _serve(je, jproto, jcontext)
    got = await _serve(te, tproto, tcontext)
    assert got == want
    assert all(len(t) == 10 and r == "length" for t, r in got)
    assert te.stats()["mk_fused_bursts"] > 0
    assert te.stats()["nonfinite_logit_rows"] == 0


def test_megakernel_gate_raises_instead_of_running_another_path():
    tiny = tconfig.tiny_config(dtype=torch.bfloat16)  # head_dim 32: not taken
    with pytest.raises(ValueError, match="head_dim 32"):
        TorchEngine(TorchEngineArgs(config=tiny, device="cpu", cuda_graphs=False, quantization="int8",
                                    use_megakernel=True, **ARGS))
    with pytest.raises(ValueError, match="bf16 pools"):
        TorchEngine(TorchEngineArgs(config=tconfig.ModelConfig(**CFG, dtype=torch.float32),
                                    device="cpu", cuda_graphs=False, quantization="int8", use_megakernel=True,
                                    **ARGS))
    mini = tconfig.ModelConfig(**CFG)
    with pytest.raises(ValueError, match="int8"):  # bf16 weights
        TorchEngine(TorchEngineArgs(config=mini, device="cpu", cuda_graphs=False, use_megakernel=True, **ARGS))
    with pytest.raises(ValueError, match="quantization"):
        TorchEngine(TorchEngineArgs(config=mini, device="cpu", cuda_graphs=False, quantization="fp8", **ARGS))
    # None: on when eligible and on the card, so off on the CPU; the int8
    # weights are made directly in int8.
    e = TorchEngine(TorchEngineArgs(config=mini, device="cpu", cuda_graphs=False, quantization="int8", **ARGS))
    assert not e.runner.use_megakernel and e.stats()["mk_fused_bursts"] == 0
    assert e.runner.params["layers"][0]["wq"]["q8"].dtype == torch.int8
