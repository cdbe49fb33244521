"""The engine's tick retry: TorchEngine (device="cpu", no graphs, depth 2)
against JaxEngine (depth 2) on the same tiny weights, each poisoned by its
own package's fault plane. A decode tick poisoned at its dispatch or its
reap aborts the bursts in flight, resyncs the slot state from the host
mirrors and retries: the stream equals the unpoisoned one and JAX's under
the same plan, also for a row whose penalty counts the abort rebuilds from
the emitted history. So does a dispatch that fails inside the runner,
after it wrote the device state or after it enqueued its burst. Five failures in a row end every stream with the
error and refuse new requests, as JAX's; ``clear_kv_blocks`` flushes what
JAX's flushes."""

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
from dynamo_tpu.runtime import fault_names as jfn
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu_torch.engines.gpu import engine as tengine
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.runtime import context as tcontext
from dynamo_tpu_torch.runtime import fault_names as tfn
from dynamo_tpu_torch.runtime import faults as tfaults

JAX = types.SimpleNamespace(proto=jproto, Context=jcontext.Context, faults=jfaults, fn=jfn)
TORCH = types.SimpleNamespace(proto=tproto, Context=tcontext.Context, faults=tfaults, fn=tfn)
ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            prefill_chunk=32, decode_steps=4, pipeline_depth=2)
PROMPT = list(range(40, 56))
MAX_TOKENS = 16
GREEDY = dict(temperature=0.0)
# a row whose bursts run the processor variant: its penalty counts advance
# inside the bursts the abort drops
PENALISED = dict(temperature=0.0, frequency_penalty=0.7, repetition_penalty=1.3)
POINTS = {"dispatch": "ENGINE_TICK_DISPATCH", "reap": "ENGINE_TICK_REAP"}


@pytest.fixture(autouse=True)
def _disarmed():
    """Each package's fault plane is process-global: no plan outlives a test."""
    for api in (JAX, TORCH):
        api.faults.disarm()
    yield
    for api in (JAX, TORCH):
        api.faults.disarm()


@pytest.fixture(scope="module")
def weights():
    jc = jconfig.tiny_config()
    params = jllama.init_params(jc, jax.random.PRNGKey(11))
    return jc, params, jax.tree.map(np.asarray, params)


def _engine(api, weights):
    jc, params, tree = weights
    if api is JAX:
        return JaxEngine(JaxEngineArgs(config=jc, **ARGS), params=params)
    tc = tconfig.tiny_config()
    return TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, **ARGS),
                       params=params_from_jax(tree, tc, "cpu"))


def _req(api, prompt, sampling, max_tokens=MAX_TOKENS):
    p = api.proto
    return p.PreprocessedRequest(token_ids=list(prompt), request_id="r",
                                 sampling=p.SamplingOptions(**sampling),
                                 stop=p.StopConditions(max_tokens=max_tokens))


async def _stream(engine, api, sampling, prompt=PROMPT):
    toks, reason, error = [], None, None
    async for out in engine.generate(_req(api, prompt, sampling), api.Context()):
        toks += out.token_ids
        reason, error = out.finish_reason, out.error or error
    return toks, reason.value, error


async def _run(api, weights, sampling, plan=None):
    """One stream on a fresh engine, under ``plan`` when given; returns the
    stream and the plane's injection trace."""
    engine = _engine(api, weights)
    try:
        if plan is None:
            return await _stream(engine, api, sampling), []
        with api.faults.armed(plan) as plane:
            got = await _stream(engine, api, sampling)
        return got, list(plane.trace)
    finally:
        await engine.stop()


def _plan(api, point, **rule):
    name = getattr(api.fn, POINTS[point])
    return api.faults.FaultPlan(seed=3, rules=(api.faults.FaultRule(point=name, **rule),))


@pytest.mark.parametrize("sampling", [GREEDY, PENALISED], ids=["greedy", "penalised"])
@pytest.mark.parametrize("point", list(POINTS))
async def test_poisoned_tick_stream_equals_unpoisoned_and_jax(weights, point, sampling):
    """Poisoned at hit 2 of the seam: the port's stream equals its own
    unpoisoned stream and JaxEngine's under the same plan, and each plane
    fired once, at the same hit."""
    want, _ = await _run(TORCH, weights, sampling)
    assert len(want[0]) == MAX_TOKENS and want[1] == "length"
    got, trace = await _run(TORCH, weights, sampling, _plan(TORCH, point, at=(2,), kind="error"))
    jgot, jtrace = await _run(JAX, weights, sampling, _plan(JAX, point, at=(2,), kind="error"))
    assert got == jgot == (want[0], "length", None)
    assert trace == [(getattr(tfn, POINTS[point]), 2, 0, "error")]
    assert [t[1:] for t in jtrace] == [t[1:] for t in trace]


def _fail_second_dispatch(engine, when):
    """Make the runner's 2nd ``decode_dispatch`` raise: ``"synced"`` after
    the dispatch applied its penalty resets and its slot and table syncs
    to the device state and before it enqueues the burst; ``"enqueued"``
    after the real call enqueued the burst (its carry and penalty counts
    advance on the device, its handles never reach the engine). Returns
    the list of calls."""
    real, calls = engine.runner.decode_dispatch, []

    def dispatch(*a, **k):
        calls.append(when)
        if len(calls) == 2:
            if when == "enqueued":
                real(*a, **k)
            raise RuntimeError(f"dispatch failed {when}")
        return real(*a, **k)

    engine.runner.decode_dispatch = dispatch
    return calls


@pytest.mark.parametrize("sampling", [GREEDY, PENALISED], ids=["greedy", "penalised"])
@pytest.mark.parametrize("when", ["synced", "enqueued"])
async def test_a_dispatch_failing_inside_the_runner_gives_the_unpoisoned_stream(
        weights, when, sampling):
    """A dispatch that fails after the device state was written, or after
    its burst was enqueued: the abort resyncs every slot from the host
    mirrors and rebuilds the penalty counts, and the retried stream equals
    the unpoisoned one."""
    want, _ = await _run(TORCH, weights, sampling)
    engine = _engine(TORCH, weights)
    try:
        calls = _fail_second_dispatch(engine, when)
        got = await _stream(engine, TORCH, sampling)
    finally:
        await engine.stop()
    assert len(calls) > 2
    assert got == want == (want[0], "length", None)


async def test_penalty_counts_are_rebuilt_from_the_emitted_history(weights, monkeypatch):
    """The reap poison drops processor bursts whose counts already advanced
    on the device: without the abort's rebuild (``runner.proc_reset_slot``
    from the emitted history) the retried stream parts from the unpoisoned
    one — the rebuild is what holds the penalised row above."""
    want, _ = await _run(TORCH, weights, PENALISED)
    monkeypatch.setattr(TorchEngine, "_abort_inflight", _abort_without_rebuild)
    got, trace = await _run(TORCH, weights, PENALISED,
                            _plan(TORCH, "reap", at=(2,), kind="error"))
    assert len(trace) == 1
    assert got[0] != want[0]


def _abort_without_rebuild(self):
    self._inflight.clear()
    self._dirty_state.update(range(self.args.max_num_seqs))
    self._dirty_tables.update(range(self.args.max_num_seqs))


@pytest.mark.parametrize("point", list(POINTS))
async def test_five_failures_in_a_row_fail_terminally_as_jax(weights, point, monkeypatch):
    """Every tick failing: the 5th strike in a row ends the stream with the
    error and a later request is refused, on both engines; each plane
    fired exactly MAX_TICK_FAILURES times (the backoff sleeps are skipped)."""
    assert tengine.MAX_TICK_FAILURES == 5 and tengine.TICK_BACKOFF_CAP_S == 2.0

    sleep = asyncio.sleep

    async def no_backoff(delay, *a, **k):
        await sleep(0)

    outs = {}
    for api in (JAX, TORCH):
        engine = _engine(api, weights)
        monkeypatch.setattr(asyncio, "sleep", no_backoff)
        try:
            with api.faults.armed(_plan(api, point, every=1, kind="error")) as plane:
                first = await _stream(engine, api, GREEDY)
                late = await _stream(engine, api, GREEDY, prompt=PROMPT[:5])
            monkeypatch.setattr(asyncio, "sleep", sleep)
            outs[api is TORCH] = (first, late, len(plane.trace), engine.pool.free_blocks)
        finally:
            monkeypatch.setattr(asyncio, "sleep", sleep)
            await engine.stop()
    (first, late, fired, free), (jfirst, jlate, jfired, jfree) = outs[True], outs[False]
    assert fired == jfired == 5
    assert first[0] == jfirst[0] and len(first[0]) == 1  # the prefill's token only
    assert first[1] == jfirst[1] == "error" and "injected error fault" in first[2]
    assert first[2].startswith("engine failed: ") and jfirst[2].startswith("engine failed: ")
    assert late == ([], "error", first[2]) and jlate[:2] == ([], "error")
    assert free == jfree == ARGS["num_kv_blocks"]


async def test_clear_kv_blocks_flushes_what_jax_flushes(weights):
    """After the same served request, both pools hold the same cached
    blocks; clear_kv_blocks returns that count and leaves none cached."""
    got = {}
    for api in (JAX, TORCH):
        engine = _engine(api, weights)
        try:
            await _stream(engine, api, GREEDY)
            while engine.stats()["active_seqs"] or engine.stats()["inflight_bursts"]:
                await asyncio.sleep(0.01)
            before = engine.pool.cached_blocks
            got[api is TORCH] = (before, engine.clear_kv_blocks(), engine.pool.cached_blocks,
                                 engine.clear_kv_blocks())
        finally:
            await engine.stop()
    assert got[True] == got[False]
    assert got[True][0] > 0 and got[True][1:] == (got[True][0], 0, 0)
