"""``TorchEngine.generate()`` serves neutral processor values (the ones the
JAX admission treats as off) as the plain request: the same stream, and the
request stays on the plain decode variant. (The processors themselves are
held against JaxEngine in tests/test_torch_engine_procs.py.)
"""

import asyncio

from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.protocols.common import (
    FinishReason,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.runtime.context import Context

ARGS = dict(block_size=4, num_kv_blocks=32, max_num_seqs=2, max_model_len=64, prefill_chunk=16,
            decode_steps=2)
PROMPT = [5, 17, 99, 3, 250, 41, 7]


async def _collect(engine, sampling):
    req = PreprocessedRequest(token_ids=PROMPT, request_id="r", sampling=sampling,
                              stop=StopConditions(max_tokens=6))
    outs = [out async for out in engine.generate(req, Context())]
    return outs


def _engine():
    return TorchEngine(TorchEngineArgs(config=tconfig.tiny_config(), device="cpu", cuda_graphs=False, **ARGS))


def test_neutral_values_are_served_as_the_plain_request():
    neutral = SamplingOptions(temperature=0.0, repetition_penalty=1.0, presence_penalty=0.0,
                              frequency_penalty=0.0, min_p=0.0, logit_bias={}, logprobs=None)

    async def run():
        engine = _engine()
        try:
            plain = await _collect(engine, SamplingOptions(temperature=0.0))
            served = await _collect(engine, neutral)
            return plain, served, engine.runner.proc_state
        finally:
            await engine.stop()

    plain, served, proc_state = asyncio.run(run())
    assert proc_state is None  # no processor burst ran
    tokens = [[t for o in outs for t in o.token_ids] for outs in (plain, served)]
    assert all(o.error is None and o.logprobs is None for o in plain + served)
    assert tokens[0] == tokens[1] and len(tokens[0]) == 6
    assert served[-1].finish_reason is FinishReason.LENGTH
