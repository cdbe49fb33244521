"""The port's llm/migration.py side by side with JAX's Migration — the
port's copies of tests/test_faultline.py's migration tests.

The same dying engines behind both give equal outputs, equal re-dispatched
requests (the carried tokens in the prompt, max_tokens and min_tokens
charged), the same metric values per reason and the same flight event
kinds, for every failure class Migration takes (connection, timeout,
disagg, drain, worker_lost, no_instances); the re-prefill cap exhausts at
203 tokens on both; and a TorchEngine and a JaxEngine on the same weights
behind the same dying wrapper give token-exact streams, equal to an
unbroken run."""

import asyncio
import types

import jax
import numpy as np
import pytest

from dynamo_tpu.disagg.errors import DisaggTransferError as JDisagg
from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.llm import migration as jmigration
from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu.runtime.component import NoInstancesError as JNoInstances
from dynamo_tpu.runtime.drain import WorkerDrainingError as JDraining
from dynamo_tpu.runtime.engine import collect as jcollect
from dynamo_tpu.runtime.liveness import WorkerLostError as JLost
from dynamo_tpu.runtime.network.tcp import StreamDisconnectedError as JDisconnected
from dynamo_tpu_torch.disagg.errors import DisaggTransferError as TDisagg
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm import migration as tmigration
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.runtime import context as tcontext
from dynamo_tpu_torch.runtime.component import NoInstancesError as TNoInstances
from dynamo_tpu_torch.runtime.drain import WorkerDrainingError as TDraining
from dynamo_tpu_torch.runtime.engine import collect as tcollect
from dynamo_tpu_torch.runtime.liveness import WorkerLostError as TLost
from dynamo_tpu_torch.runtime.network.tcp import StreamDisconnectedError as TDisconnected

JAX = types.SimpleNamespace(proto=jproto, Context=jcontext.Context, mig=jmigration,
                            collect=jcollect)
TORCH = types.SimpleNamespace(proto=tproto, Context=tcontext.Context, mig=tmigration,
                              collect=tcollect)
# (reason label, JAX's exception, the port's) for every class Migration takes
FAILURES = {
    "connection": (lambda: ConnectionError("reset"), lambda: ConnectionError("reset")),
    "disconnected": (lambda: JDisconnected("worker connection lost"),
                     lambda: TDisconnected("worker connection lost")),
    "timeout": (lambda: asyncio.TimeoutError("deadline"), lambda: asyncio.TimeoutError("deadline")),
    "disagg": (lambda: JDisagg("pull failed"), lambda: TDisagg("pull failed")),
    "drain": (lambda: JDraining("draining"), lambda: TDraining("draining")),
    "worker_lost": (lambda: JLost("declared dead"), lambda: TLost("declared dead")),
    "no_instances": (lambda: JNoInstances("dynamo/backend/generate"),
                     lambda: TNoInstances("dynamo/backend/generate")),
}
LABEL = {"disconnected": "connection"}


def req(api, tokens, max_tokens=16, min_tokens=None):
    p = api.proto
    return p.PreprocessedRequest(
        token_ids=list(tokens), request_id="r",
        sampling=p.SamplingOptions(temperature=0.0),
        stop=p.StopConditions(max_tokens=max_tokens, min_tokens=min_tokens),
    )


def _as_dict(item):
    return item if isinstance(item, dict) else item.to_dict()


class _Scripted:
    """AsyncEngine whose first ``dies`` calls stream ``per_call`` tokens and
    then raise ``exc()``; later calls stream the rest and finish. Records
    every request it receives."""

    def __init__(self, exc, dies=1, per_call=2, total=12):
        self.exc, self.dies, self.per_call, self.total = exc, dies, per_call, total
        self.requests = []
        self.sent = 0

    async def generate(self, request, context):
        self.requests.append(_as_dict(request))
        die = len(self.requests) <= self.dies
        for _ in range(self.per_call if die else self.total - self.sent):
            self.sent += 1
            yield {"token_ids": [100 + self.sent], "finish_reason":
                   "length" if self.sent == self.total else None}
        if die:
            raise self.exc()


async def _migrate(api, exc, limit=3, dies=1, **kw):
    mig = api.mig.Migration(migration_limit=limit)
    engine = _Scripted(exc, dies=dies)
    out = await api.collect(mig.generate(req(api, range(10), **kw), api.Context(), engine))
    return mig, engine, [_as_dict(o) for o in out]


def _events(mig):
    """The flight ring's events, each without its clock reading."""
    return [{k: v for k, v in e.items() if k != "t_mono"} for e in mig.flight.snapshot()]


def _metrics(mig, reason):
    m = mig.metrics
    return (m.migrations.value(reason=reason), m.exhausted.value(), m.reprefill_tokens.value())


@pytest.mark.parametrize("dies", [1, 2, 4], ids=["once", "twice", "past-limit"])
@pytest.mark.parametrize("kind", list(FAILURES))
async def test_dying_engine_migrates_as_jax(kind, dies):
    """The same script under both Migrations: outputs, re-dispatched
    requests, metrics for the failure's reason and flight event kinds are
    equal; past the limit (3) both end on the typed terminal error."""
    jexc, texc = FAILURES[kind]
    reason = LABEL.get(kind, kind)
    jmig, jeng, jout = await _migrate(JAX, jexc, dies=dies, min_tokens=3)
    tmig, teng, tout = await _migrate(TORCH, texc, dies=dies, min_tokens=3)
    assert tout == jout
    assert teng.requests == jeng.requests
    assert _metrics(tmig, reason) == _metrics(jmig, reason)
    assert _events(tmig) == _events(jmig)
    if dies <= 3:
        assert tout[-1]["finish_reason"] == "length" and not tout[-1].get("error")
        assert tmig.metrics.migrations.value(reason=reason) == dies
        # the carried tokens ride the re-dispatched prompt; max and min
        # tokens are charged for them
        last = teng.requests[-1]
        assert last["token_ids"] == list(range(10)) + [101 + i for i in range(2 * dies)]
        assert last["stop"]["max_tokens"] == 16 - 2 * dies
        assert last["stop"]["min_tokens"] == max(3 - 2 * dies, 0)
    else:
        assert tout[-1]["finish_reason"] == "error" and tout[-1]["error_kind"] == reason
        assert tmig.metrics.exhausted.value() == 1


async def test_reprefill_token_cap_exhausts_at_203_tokens_as_jax():
    """A worker that always dies: attempt 1 re-prefills 101 tokens, attempt
    2 102 (203 in all); attempt 3 would pass the 250-token cap, so both
    Migrations stop by cost, long before the 50-attempt limit."""

    class _AlwaysDies:
        async def generate(self, request, context):
            yield {"token_ids": [5]}
            raise ConnectionError("boom")

    outs = []
    for api in (JAX, TORCH):
        mig = api.mig.Migration(migration_limit=50, max_reprefill_tokens=250)
        out = await api.collect(mig.generate(req(api, range(100), max_tokens=40), api.Context(),
                                             _AlwaysDies()))
        last = _as_dict(out[-1])
        assert last["error"] and "re-prefilled" in last["error"]
        outs.append(([_as_dict(o) for o in out], _metrics(mig, "connection"),
                     [e["kind"] for e in mig.flight.snapshot()]))
    assert outs[1] == outs[0]
    assert outs[1][1] == (2, 1, 203)
    assert outs[1][2] == ["migrate", "migrate", "exhausted"]


def test_defaults_and_failure_classes_match_jax():
    assert tmigration.DEFAULT_REPREFILL_CAP == jmigration.DEFAULT_REPREFILL_CAP == 131072
    assert tmigration.Migration().migration_limit == jmigration.Migration().migration_limit
    for kind, (jexc, texc) in FAILURES.items():
        assert tmigration._failure_reason(texc()) == jmigration._failure_reason(jexc())
        assert isinstance(texc(), tmigration.MIGRATABLE)
    assert tmigration._failure_reason(ValueError("x")) == "other"


class _DiesMidStream:
    """AsyncEngine that serves through a real engine but kills the stream
    with ``exc`` after the first burst — once (test_faultline.py)."""

    def __init__(self, engine, exc):
        self._engine = engine
        self._exc = exc
        self.calls = 0

    async def generate(self, request, context):
        self.calls += 1
        die = self.calls == 1
        n = 0
        async for out in self._engine.generate(request, context):
            yield out
            n += 1
            if die and n == 1:
                raise self._exc


@pytest.fixture(scope="module")
def weights():
    jc = jconfig.tiny_config()
    params = jllama.init_params(jc, jax.random.PRNGKey(21))
    return jc, params, jax.tree.map(np.asarray, params)


ENGINE_ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
                   prefill_chunk=32, decode_steps=4, pipeline_depth=2)


def _engine(api, weights):
    jc, params, tree = weights
    if api is JAX:
        return JaxEngine(JaxEngineArgs(config=jc, **ENGINE_ARGS), params=params)
    tc = tconfig.tiny_config()
    return TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                       **ENGINE_ARGS), params=params_from_jax(tree, tc, "cpu"))


def _toks(outs):
    return [t for o in outs for t in (_as_dict(o).get("token_ids") or [])]


async def test_engines_behind_the_same_dying_wrapper_stay_token_exact(weights):
    """Worker dies mid-stream after the first burst; Migration re-dispatches
    with the generated tokens embedded in the prompt. TorchEngine's stream
    equals JaxEngine's behind JAX's Migration and both unbroken runs."""
    prompt = list(range(70, 86))
    got = {}
    for api, exc in ((JAX, JDisconnected("worker died")), (TORCH, TDisconnected("worker died"))):
        oracle, flaky_engine = _engine(api, weights), _engine(api, weights)
        try:
            want = _toks(await api.collect(oracle.generate(req(api, prompt, 12), api.Context())))
            flaky = _DiesMidStream(flaky_engine, exc)
            mig = api.mig.Migration(migration_limit=3)
            out = await api.collect(mig.generate(req(api, prompt, 12), api.Context(), flaky))
            events = mig.flight.snapshot()
            got[api is TORCH] = (want, _toks(out), flaky.calls,
                                 mig.metrics.migrations.value(reason="connection"),
                                 [e["kind"] for e in events], events[0]["carried"])
        finally:
            await oracle.stop()
            await flaky_engine.stop()
    assert got[True] == got[False]
    want, toks, calls, migrated, kinds, carried = got[True]
    assert toks == want and len(want) == 12
    assert (calls, migrated, kinds) == (2, 1, ["migrate"]) and carried > 0
