"""TorchEngine (device="cpu") against JaxEngine on the same tiny weights:
greedy token streams must be identical, with the same finish reasons, for
concurrent requests, a prompt longer than prefill_chunk, a prefix-cache hit,
EOS and max_tokens stops, a cancellation and preemption-by-recompute. Then
the port alone: sampled streams that do not depend on batch or preemption,
stop ids, min_tokens and ignore_eos, and a device step that fails."""

import asyncio
import types

import jax
import numpy as np
import pytest

from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.runtime import context as tcontext

ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            prefill_chunk=32, decode_steps=4)


def _api(proto, context):
    return types.SimpleNamespace(proto=proto, Context=context.Context)


JAX_API = _api(jproto, jcontext)
TORCH_API = _api(tproto, tcontext)


@pytest.fixture(scope="module")
def weights():
    jc = jconfig.tiny_config()
    params = jllama.init_params(jc, jax.random.PRNGKey(5))
    return jc, params, jax.tree.map(np.asarray, params)


def _engines(weights, **over):
    jc, params, tree = weights
    tc = tconfig.tiny_config()
    args = {**ARGS, **over}
    je = JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=1, **args), params=params)
    te = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, **args),
                     params=params_from_jax(tree, tc, "cpu"))
    return (je, JAX_API), (te, TORCH_API)


def _req(api, prompt, max_tokens=12, eos=()):
    p = api.proto
    return p.PreprocessedRequest(
        token_ids=[int(t) for t in prompt], request_id="r",
        sampling=p.SamplingOptions(temperature=0.0),
        stop=p.StopConditions(max_tokens=max_tokens), eos_token_ids=list(eos),
    )


async def _one(engine, api, prompt, cancel_after=None, **kw):
    ctx = api.Context()
    toks, reason = [], None
    async for out in engine.generate(_req(api, prompt, **kw), ctx):
        assert out.error is None, out.error
        toks += out.token_ids
        reason = out.finish_reason
        if cancel_after is not None and len(toks) >= cancel_after:
            ctx.stop_generating()
    return toks, reason.value


PROMPTS = [list(np.random.default_rng(i).integers(3, 500, n)) for i, n in
           enumerate((12, 70, 9, 33, 20))]  # 70 > prefill_chunk


async def _serve(engine, api):
    try:
        out = {"concurrent": await asyncio.gather(*(_one(engine, api, p) for p in PROMPTS))}
        # the same prompt again: its full blocks come from the prefix cache
        hits0 = engine.prefill_tokens
        out["prefix_hit"] = await _one(engine, api, PROMPTS[1])
        out["prefix_prefilled"] = engine.prefill_tokens - hits0
        stream = out["concurrent"][3][0]
        out["eos"] = await _one(engine, api, PROMPTS[3], max_tokens=40, eos=[stream[5]])
        out["max_tokens"] = await _one(engine, api, PROMPTS[4], max_tokens=3)
        out["full"] = await _one(engine, api, PROMPTS[2], max_tokens=40)
        out["cancel"] = await _one(engine, api, PROMPTS[2], max_tokens=40, cancel_after=1)
        return out
    finally:
        await engine.stop()


async def test_greedy_streams_match_jax_engine(weights):
    (je, ja), (te, ta) = _engines(weights)
    want = await _serve(je, ja)
    got = await _serve(te, ta)
    assert got["concurrent"] == want["concurrent"]
    assert all(len(t) == 12 and r == "length" for t, r in got["concurrent"])
    assert got["prefix_hit"] == want["prefix_hit"] == want["concurrent"][1]
    assert got["prefix_prefilled"] < len(PROMPTS[1]) // 2  # most blocks were reused
    assert got["eos"] == want["eos"]
    assert got["eos"][1] == "eos" and got["eos"][0][-1] == want["concurrent"][3][0][5]
    assert got["max_tokens"] == want["max_tokens"] and len(got["max_tokens"][0]) == 3
    assert got["full"] == want["full"]
    for toks, reason in (got["cancel"], want["cancel"]):
        assert reason == "cancelled"
        assert toks == want["full"][0][: len(toks)]


async def test_preemption_by_recompute_keeps_streams(weights):
    """A pool too small for every running sequence: the youngest is
    preempted, re-prefilled from its tokens so far, and continues with the
    same greedy stream as the JAX engine gives."""
    (je, ja), (te, ta) = _engines(weights, num_kv_blocks=40, max_num_seqs=4)
    prompts = [list(np.random.default_rng(50 + i).integers(3, 500, 20)) for i in range(4)]

    async def run(engine, api):
        try:
            return await asyncio.gather(*(_one(engine, api, p, max_tokens=40) for p in prompts))
        finally:
            await engine.stop()

    want = await run(je, ja)
    got = await run(te, ta)
    assert te.preemptions > 0
    assert got == want
    assert all(len(t) == 40 for t, _ in got)


def _torch_engine(weights, **over):
    _, _, tree = weights
    tc = tconfig.tiny_config()
    return TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, **{**ARGS, **over}),
                       params=params_from_jax(tree, tc, "cpu"))


async def test_sampled_stream_does_not_depend_on_batch_or_preemption(weights):
    """Sampling noise is keyed (seed, sequence salt, token index): a sampled
    request draws the same tokens alone, inside a busy batch, and after
    being preempted and recomputed."""
    p = tproto

    def sampled(prompt):
        return p.PreprocessedRequest(
            token_ids=[int(t) for t in prompt],
            sampling=p.SamplingOptions(temperature=0.8, top_k=20, top_p=0.9),
            stop=p.StopConditions(max_tokens=30),
        )

    async def collect(engine, req):
        toks = []
        async for out in engine.generate(req, tcontext.Context()):
            toks += out.token_ids
        return toks

    prompts = [PROMPTS[0]] + [list(np.random.default_rng(70 + i).integers(3, 500, 20))
                              for i in range(3)]

    async def batch(**over):
        engine = _torch_engine(weights, **over)
        try:
            outs = await asyncio.gather(*(collect(engine, sampled(pr)) for pr in prompts))
        finally:
            await engine.stop()
        return outs, engine.preemptions

    roomy, n_roomy = await batch()
    tight, n_tight = await batch(num_kv_blocks=40)  # crowds the pool: preemptions
    assert n_roomy == 0 and n_tight > 0
    assert tight == roomy
    alone = _torch_engine(weights)  # the first request alone has the same salt
    try:
        assert await collect(alone, sampled(PROMPTS[0])) == roomy[0]
    finally:
        await alone.stop()
    assert all(len(t) == 30 for t in roomy)
    assert len(set(map(tuple, roomy))) == len(roomy)  # rows draw their own noise


async def test_stop_ids_min_tokens_and_ignore_eos(weights):
    engine = _torch_engine(weights)
    p = tproto

    async def run(**stop):
        eos = stop.pop("eos", [])
        req = p.PreprocessedRequest(token_ids=[int(t) for t in PROMPTS[4]],
                                    sampling=p.SamplingOptions(temperature=0.0),
                                    stop=p.StopConditions(**stop), eos_token_ids=eos)
        toks, reason = [], None
        async for out in engine.generate(req, tcontext.Context()):
            toks += out.token_ids
            reason = out.finish_reason
        return toks, reason.value

    try:
        full, _ = await run(max_tokens=20)
        target = full[6]
        first = full.index(target)
        toks, reason = await run(max_tokens=20, stop_token_ids=[target])
        assert (toks, reason) == (full[: first + 1], "stop")
        # min_tokens holds the stop back until the 8th token
        toks, reason = await run(max_tokens=20, stop_token_ids=[target], min_tokens=first + 2)
        later = [i for i, t in enumerate(full) if t == target and i + 1 >= first + 2]
        assert (toks, reason) == ((full[: later[0] + 1], "stop") if later else (full, "length"))
        toks, reason = await run(max_tokens=20, eos=[target], ignore_eos=True)
        assert (toks, reason) == (full, "length")
    finally:
        await engine.stop()


@pytest.mark.parametrize("step", ["run_step", "run_decode"])
async def test_a_failing_device_step_fails_streams_instead_of_falling_back(weights, step):
    """A prefill or decode step that raises (a kernel that does not build or
    launch) ends every stream with an error and refuses later requests: the
    engine never carries on some other way, and no stream hangs."""
    engine = _torch_engine(weights)

    def broken(*a, **k):
        raise RuntimeError("paged_attention_decode launch failed: cudaError 1")

    # decode bursts reach the card through decode_dispatch (run_decode is
    # its synchronous form)
    setattr(engine.runner, "decode_dispatch" if step == "run_decode" else step, broken)
    try:
        outs = [out async for out in engine.generate(_req(TORCH_API, PROMPTS[0]), tcontext.Context())]
        assert bool(outs[0].token_ids) == (step == "run_decode")
        assert outs[-1].finish_reason.value == "error" and "cudaError 1" in outs[-1].error
        assert engine.pool.free_blocks == engine.args.num_kv_blocks  # blocks released
        late = [out async for out in engine.generate(_req(TORCH_API, PROMPTS[1]), tcontext.Context())]
        assert [o.finish_reason.value for o in late] == ["error"] and "engine failed" in late[0].error
    finally:
        await engine.stop()


async def test_request_errors_match_jax_engine(weights):
    (je, ja), (te, ta) = _engines(weights)
    for engine, api in ((je, ja), (te, ta)):
        try:
            outs = []
            for prompt in ([], list(range(3, 200))):  # empty; longer than max_model_len
                async for out in engine.generate(_req(api, prompt), api.Context()):
                    outs.append((out.finish_reason.value, bool(out.error)))
            assert outs == [("error", True), ("error", True)]
        finally:
            await engine.stop()
