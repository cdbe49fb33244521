"""Disaggregated prefill and decode in the port (dynamo_tpu_torch/disagg/
handlers.py over TorchEngine's export and import) against the JAX
package's, on the CPU and the same weights:

- PrefillHandler's bootstrap and KvTransferHandler's replies (v2 pool-
  native, v2 with the int8 encoding vetoed, a dense dtype only, v1) shaped
  as JAX's handlers shape them, chunk sizing equal;
- the full flow over the process-local plane (PrefillRouter -> prefill
  worker -> DecodeHandler's pull -> prefix-cached admission): the
  disaggregated greedy stream equals the aggregated one and JAX's, and the
  decode engine prefills less than the prompt; the router falls back
  without prefill workers; a chunked pull is exact; the export's readback
  runs off the device thread;
- across the packages, over discd and TCP: a port prefill worker feeds a
  JAX decode worker and a JAX prefill worker a port decode worker, each
  stream equal to JAX's aggregated stream;
- faults and metrics: an export failing at one chunk resumes from its
  anchor (the same counts as JAX's handler under the same plan);
  failures past BREAKER_OPEN_AFTER open the breaker and the stream falls
  back to local prefill with ``pull_fallbacks`` counted; with the fallback
  off, DisaggTransferError reaches Migration as migratable; a stale
  incarnation's reply is dropped; link bandwidth ages out after its TTL;
  the breaker's state machine and DisaggMetrics' exposition equal JAX's.
"""

import asyncio
import time
import types

import jax
import numpy as np
import pytest

from dynamo_tpu import disagg as jdisagg
from dynamo_tpu.disagg import handlers as jhandlers
from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime import fault_names as jfault_names
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu.runtime.engine import collect as jcollect
from dynamo_tpu_torch import disagg as tdisagg
from dynamo_tpu_torch.disagg import handlers as thandlers
from dynamo_tpu_torch.disagg import wire as twire
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.migration import Migration
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.runtime import fault_names as tfault_names
from dynamo_tpu_torch.runtime import faults as tfaults
from dynamo_tpu_torch.runtime.context import Context as TContext
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import collect as tcollect
from dynamo_tpu_torch.runtime.pipeline import build_pipeline
from dynamo_tpu_torch.tokens.blocks import compute_block_hashes

ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            prefill_chunk=32, decode_steps=4)
PROMPT = list(range(60, 78))  # 18 tokens: 4 full blocks of 4 and a tail
MAX_TOKENS = 10


def _pkg(name, disagg, handlers, proto, Context, collect, faults, fault_names):
    return types.SimpleNamespace(name=name, disagg=disagg, handlers=handlers, proto=proto,
                                 Context=Context, collect=collect, faults=faults,
                                 fault_names=fault_names)


JAX = _pkg("jax", jdisagg, jhandlers, jproto, JContext, jcollect, jfaults, jfault_names)
PORT = _pkg("port", tdisagg, thandlers, tproto, TContext, tcollect, tfaults, tfault_names)


@pytest.fixture(scope="module")
def weights():
    jc = jconfig.tiny_config()
    params = jllama.init_params(jc, jax.random.PRNGKey(3))
    return jc, params, jax.tree.map(np.asarray, params)


def _engine(weights, pkg, kv=None):
    jc, params, tree = weights
    if pkg is JAX:
        return JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=1, kv_cache_dtype=kv, **ARGS),
                         params=params)
    tc = tconfig.tiny_config()
    return TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                       kv_cache_dtype=kv, **ARGS),
                       params=params_from_jax(tree, tc, "cpu"))


def _req(pkg, prompt=PROMPT, max_tokens=MAX_TOKENS):
    p = pkg.proto
    return p.PreprocessedRequest(token_ids=list(prompt), request_id="r",
                                 sampling=p.SamplingOptions(temperature=0.0),
                                 stop=p.StopConditions(max_tokens=max_tokens))


def _tokens(items):
    out = []
    for o in items:
        if isinstance(o, dict):
            assert not o.get("error"), o
            out += o.get("token_ids") or []
        else:
            assert not o.error, o.error
            out += o.token_ids or []
    return out


@pytest.fixture(scope="module")
def aggregated(weights):
    """JAX's aggregated greedy stream of PROMPT (and of the second prompt)."""
    async def run():
        engine = _engine(weights, JAX)
        try:
            return {tuple(p): _tokens(await jcollect(engine.generate(_req(JAX, p), JContext())))
                    for p in (PROMPT, PROMPT2)}
        finally:
            await engine.stop()

    return asyncio.run(run())


PROMPT2 = list(range(200, 222))  # 22 tokens: 5 full blocks and a tail


# -- the handlers' answers against JAX's --------------------------------------


async def test_prefill_bootstrap_matches_jax(weights):
    out = {}
    for pkg in (JAX, PORT):
        engine = _engine(weights, pkg)
        try:
            handler = pkg.disagg.PrefillHandler(engine, worker_id=42)
            items = await pkg.collect(handler.generate(_req(pkg, max_tokens=50), pkg.Context()))
            assert len(items) == 1
            dp = items[0].disaggregated_params
            out[pkg.name] = (items[0].token_ids, items[0].finish_reason.value,
                             items[0].cumulative_tokens, dp.worker_id, dp.prefilled_tokens,
                             {k: v for k, v in dp.kv_transfer.items() if k != "incarnation"},
                             isinstance(dp.kv_transfer["incarnation"], int))
            assert engine.pool.active_blocks == 0 and engine.pool.cached_blocks > 0
        finally:
            await engine.stop()
    assert out["port"] == out["jax"]
    kv = out["port"][5]
    assert kv["block_hashes"] == compute_block_hashes(PROMPT, 4) and kv["wire_dtype"] == "float32"


NEGOTIATIONS = [
    pytest.param({"wire": {"version": 2, "accept": list(thandlers.ACCEPT_WIRE_DTYPES)}},
                 id="v2-native"),
    pytest.param({"wire": {"version": 2, "accept": ["float32"]}}, id="v2-f32-only"),
    pytest.param({"wire": {"version": 2, "accept": ["bfloat16"]}}, id="v2-bf16-only"),
    pytest.param({"wire": {"version": 2}}, id="v2-no-accept"),
    pytest.param({}, id="v1"),
]


def _reply_shape(r):
    """A reply without its bytes: fields, dtype tags and shapes."""
    def arr(d):
        return None if not d else (d["dtype"], list(d["shape"]))

    kv = r.get("kv")
    return {"found": list(r.get("found") or []), "done": r.get("done"),
            "inc": isinstance(r.get("inc"), int), "keys": sorted(r),
            "kv": None if not kv else {"version": kv["version"], "dtype": kv["dtype"],
                                       **{f: arr(kv.get(f)) for f in ("k", "v", "k_scale",
                                                                       "v_scale")}},
            "k": arr(r.get("k")), "v": arr(r.get("v"))}


def _dense(pkg, reply):
    w = pkg.wire_unpack(reply)
    if pkg is PORT:
        return [t.float().numpy() for t in w.to_dense("float32")]
    return [np.asarray(t, np.float32) for t in w.to_dense(np.float32)]


JAX.wire_unpack = jdisagg.unpack_reply
PORT.wire_unpack = twire.unpack_reply


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32-pool", "int8-pool"])
@pytest.mark.parametrize("request_extra", NEGOTIATIONS)
async def test_transfer_negotiation_answers_as_jax(weights, kv, request_extra):
    """The same pull request to each package's KvTransferHandler over its
    engine (the same weights and prompt): the same replies — chunks,
    found hashes, done flags, schema, dtype tags and shapes — and KV
    values within 0.05 (two engines' prefill: near, not bit-equal; int8
    codes may part by a step)."""
    hashes = compute_block_hashes(PROMPT, 4)
    shapes, dense = {}, {}
    for pkg in (JAX, PORT):
        engine = _engine(weights, pkg, kv)
        try:
            await pkg.collect(engine.generate(_req(pkg, max_tokens=2), pkg.Context()))
            handler = pkg.disagg.KvTransferHandler(engine, chunk_bytes=3 * 4096)
            replies = [r async for r in handler.generate(
                {"block_hashes": hashes + [777], **request_extra}, pkg.Context())]
            shapes[pkg.name] = [_reply_shape(r) for r in replies]
            dense[pkg.name] = [_dense(pkg, r) for r in replies]
        finally:
            await engine.stop()
    assert shapes["port"] == shapes["jax"]
    assert len(shapes["port"]) >= 1 and shapes["port"][-1]["done"]
    for mine, theirs in zip(dense["port"], dense["jax"]):
        for a, b in zip(mine, theirs):
            assert a.shape == b.shape and float(np.abs(a - b).max()) < 0.05


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("chunk_bytes", [1, 4096, 10_000, 1 << 20])
@pytest.mark.parametrize("wire_dtype", [None, "int8", "bfloat16", "float32"])
def test_chunk_sizing_equals_jax(weights, kv, chunk_bytes, wire_dtype):
    jc, _, _ = weights
    tc = tconfig.tiny_config()
    j = types.SimpleNamespace(args=JaxEngineArgs(config=jc, kv_cache_dtype=kv, **ARGS))
    t = types.SimpleNamespace(args=TorchEngineArgs(config=tc, kv_cache_dtype=kv, **ARGS))
    assert thandlers.KvTransferHandler(t, chunk_bytes)._blocks_per_chunk(wire_dtype) == \
        jhandlers.KvTransferHandler(j, chunk_bytes)._blocks_per_chunk(wire_dtype)
    assert thandlers._engine_wire_dtype(t) == jhandlers._engine_wire_dtype(j)


# -- the flow over the process-local plane ------------------------------------


class _Flow:
    """A prefill worker (PrefillHandler + KvTransferHandler) and a decode
    worker (DecodeHandler) of the port on one process-local runtime, behind
    a PrefillRouter."""

    def __init__(self, weights, *, chunk_bytes=None, threshold=8, **decode_kw):
        self.rt = DistributedRuntime.detached()
        self.prefill = _engine(weights, PORT)
        self.decode = _engine(weights, PORT)
        self.chunk_bytes, self.threshold, self.decode_kw = chunk_bytes, threshold, decode_kw
        self.served = []

    async def __aenter__(self):
        ns = self.rt.namespace("t")
        pc = self.pc = ns.component("prefill")
        self.exporter = tdisagg.KvTransferHandler(self.prefill, chunk_bytes=self.chunk_bytes)
        self.served.append(await pc.endpoint("generate").serve_endpoint(
            tdisagg.PrefillHandler(self.prefill, worker_id=1).generate, instance_id=1))
        self.served.append(await pc.endpoint("kv").serve_endpoint(
            self.exporter.generate, instance_id=1))

        async def kv_client():
            return await pc.endpoint("kv").client()

        dc = ns.component("backend")
        self.handler = tdisagg.DecodeHandler(self.decode, kv_client_factory=kv_client,
                                             worker_id=2, **self.decode_kw)
        self.served.append(await dc.endpoint("generate").serve_endpoint(
            self.handler.generate, instance_id=2))
        decode_client = await dc.endpoint("generate").client()

        async def prefill_client():
            return await pc.endpoint("generate").client()

        self.pipeline = build_pipeline(
            [tdisagg.PrefillRouter(prefill_client, threshold_tokens=self.threshold)],
            decode_client)
        return self

    async def run(self, prompt=PROMPT, max_tokens=MAX_TOKENS):
        return _tokens(await tcollect(self.pipeline.generate(
            _req(PORT, prompt, max_tokens).to_dict(), TContext())))

    async def __aexit__(self, *exc):
        for s in self.served:
            await s.shutdown(grace_period=1)
        await self.prefill.stop()
        await self.decode.stop()
        await self.rt.shutdown(grace_period=1)


async def test_disaggregated_equals_aggregated(weights, aggregated):
    async with _Flow(weights) as f:
        toks = await f.run()
        assert toks == aggregated[tuple(PROMPT)]
        # the decode engine prefilled the tail and the first token only
        assert f.decode.prefill_tokens < len(PROMPT)
        assert f.prefill.prefill_tokens >= len(PROMPT) - 1
        assert (f.handler.transfers, f.handler.transfer_failures, f.handler.pull_fallbacks) \
            == (1, 0, 0)
        assert f.handler.blocks_pulled == len(PROMPT) // 4
        assert f.handler.wire_bytes_by_dtype == {"float32": f.handler.bytes_pulled}
        assert 1 in f.handler.link_bandwidth()


async def test_prefill_router_falls_back_without_prefill_workers(weights, aggregated):
    rt = DistributedRuntime.detached()
    engine = _engine(weights, PORT)
    ns = rt.namespace("t")
    try:
        dc = ns.component("backend")
        served = await dc.endpoint("generate").serve_endpoint(engine.generate, instance_id=2)
        decode_client = await dc.endpoint("generate").client()

        async def prefill_client():
            return await ns.component("prefill").endpoint("generate").client()

        pipeline = build_pipeline([tdisagg.PrefillRouter(prefill_client, threshold_tokens=8)],
                                  decode_client)
        toks = _tokens(await tcollect(pipeline.generate(_req(PORT).to_dict(), TContext())))
        assert toks == aggregated[tuple(PROMPT)]
        assert engine.prefill_tokens == len(PROMPT)
        await served.shutdown(grace_period=1)
    finally:
        await engine.stop()
        await rt.shutdown(grace_period=1)


async def test_chunked_streamed_transfer(weights, aggregated):
    """chunk_bytes 1: one block a reply message, each imported as it lands
    and chained by its anchor; the stream is exact."""
    async with _Flow(weights, chunk_bytes=1) as f:
        assert f.exporter._blocks_per_chunk() == 1
        chunks = []
        real = f.decode.import_blocks_wire_async

        async def spy(found, wire, *, anchor_parent=None):
            chunks.append((list(found), anchor_parent))
            return await real(found, wire, anchor_parent=anchor_parent)

        f.decode.import_blocks_wire_async = spy
        toks = await f.run(PROMPT2)
        assert toks == aggregated[tuple(PROMPT2)]
        hashes = compute_block_hashes(PROMPT2, 4)
        assert chunks == [([h], hashes[i - 1] if i else None) for i, h in enumerate(hashes)]
        assert (f.handler.transfers, f.handler.transfer_failures) == (1, 0)
        assert f.handler.blocks_pulled == 5 and f.handler.bytes_pulled > 0


async def test_export_readback_overlaps_decode(weights):
    """The export's wait for its copy runs on the transfer thread: a
    generate issued while a slow readback drains finishes first."""
    engine = _engine(weights, PORT)
    real = engine.runner.gather_blocks_wire_readback
    try:
        await tcollect(engine.generate(_req(PORT, PROMPT, 2), TContext()))
        hashes = compute_block_hashes(PROMPT, 4)

        def slow_readback(handles):
            time.sleep(1.2)  # a slow copy
            return real(handles)

        engine.runner.gather_blocks_wire_readback = slow_readback
        t0 = time.monotonic()
        export = asyncio.ensure_future(engine.export_blocks_wire_async(hashes))
        await asyncio.sleep(0.05)  # the dispatch lands first
        out = await tcollect(engine.generate(_req(PORT, list(range(300, 310)), 6), TContext()))
        t_decode = time.monotonic() - t0
        found, _ = await export
        t_export = time.monotonic() - t0
        assert len(_tokens(out)) == 6 and found == hashes
        assert t_decode < t_export, (t_decode, t_export)
    finally:
        engine.runner.gather_blocks_wire_readback = real
        await engine.stop()


# -- across the packages, over discd and TCP ----------------------------------


@pytest.mark.parametrize("prefill_pkg,decode_pkg", [
    pytest.param(PORT, JAX, id="port_prefill-jax_decode"),
    pytest.param(JAX, PORT, id="jax_prefill-port_decode")])
async def test_a_prefill_worker_feeds_the_other_packages_decode_worker(
        weights, aggregated, prefill_pkg, decode_pkg):
    """A prefill worker of one package and a decode worker of the other on
    one discd, each runtime on its own TCP request plane: the decode side's
    PrefillRouter asks the prefill worker, its DecodeHandler pulls the
    blocks over TCP (msgpack of one package, read by the other's) and
    decodes. The stream equals JAX's aggregated one, and the decode engine
    prefilled less than the prompt."""
    from dynamo_tpu.runtime.discovery import discd as jdiscd
    from dynamo_tpu.runtime.distributed import DistributedRuntime as JRuntime
    from dynamo_tpu.runtime.network import tcp as jtcp
    from dynamo_tpu_torch.runtime.discovery import discd as tdiscd
    from dynamo_tpu_torch.runtime.network import tcp as ttcp

    planes = {"jax": (JRuntime, jdiscd, jtcp), "port": (DistributedRuntime, tdiscd, ttcp)}
    srv = tdiscd.DiscdServer()
    port = await srv.start()

    def runtime(pkg):
        rt_cls, discd, tcp = planes[pkg.name]
        return rt_cls(discovery=discd.DiscdDiscovery(f"127.0.0.1:{port}"),
                      request_plane=tcp.TcpRequestPlane())

    prt, drt = runtime(prefill_pkg), runtime(decode_pkg)
    pe, de = _engine(weights, prefill_pkg), _engine(weights, decode_pkg)
    served, clients = [], []
    try:
        pc = prt.namespace("x").component("prefill")
        served.append(await pc.endpoint("generate").serve_endpoint(
            prefill_pkg.disagg.PrefillHandler(pe, worker_id=11).generate, instance_id=11))
        served.append(await pc.endpoint("kv").serve_endpoint(
            prefill_pkg.disagg.KvTransferHandler(pe, chunk_bytes=2 * 2048).generate,
            instance_id=11))
        dpc = drt.namespace("x").component("prefill")
        for ep in ("generate", "kv"):
            cl = await dpc.endpoint(ep).client()
            assert await cl.wait_for_instances(timeout=10) == [11]
            clients.append(cl)
        gen_client, kv_client = clients

        async def kv_factory():
            return kv_client

        async def prefill_factory():
            return gen_client

        handler = decode_pkg.disagg.DecodeHandler(de, kv_client_factory=kv_factory, worker_id=12)
        router = decode_pkg.disagg.PrefillRouter(prefill_factory, threshold_tokens=8)
        items = await asyncio.wait_for(decode_pkg.collect(router.generate(
            _req(decode_pkg), decode_pkg.Context(), handler)), 60)
        assert _tokens(items) == aggregated[tuple(PROMPT)]
        assert de.prefill_tokens < len(PROMPT) <= pe.prefill_tokens + 1
        assert (handler.transfers, handler.transfer_failures, handler.blocks_pulled) == \
            (1, 0, len(PROMPT) // 4)
        assert handler.wire_bytes_by_dtype == {"float32": handler.bytes_pulled}
    finally:
        for cl in clients:
            await cl.close()
        for s in served:
            await s.shutdown(grace_period=1)
        await pe.stop()
        await de.stop()
        await drt.shutdown(grace_period=1)
        await prt.shutdown(grace_period=1)
        await srv.stop()


# -- faults, the breaker and the metrics --------------------------------------


async def _pull_counts(weights, pkg, plan_rule, prompt=PROMPT2, **decode_kw):
    """One disaggregated request of ``pkg`` on its process-local plane (one
    block a chunk) under a fault plan; the stream and the handler's
    counters."""
    from dynamo_tpu.runtime.distributed import DistributedRuntime as JRuntime

    rt = (JRuntime if pkg is JAX else DistributedRuntime).detached()
    pe, de = _engine(weights, pkg), _engine(weights, pkg)
    ns, served = rt.namespace(f"f{pkg.name}"), []
    plan = pkg.faults.FaultPlan(seed=1, rules=(pkg.faults.FaultRule(**plan_rule),)) \
        if plan_rule else pkg.faults.FaultPlan()
    try:
        pc = ns.component("prefill")
        served.append(await pc.endpoint("kv").serve_endpoint(
            pkg.disagg.KvTransferHandler(pe, chunk_bytes=1).generate, instance_id=1))

        async def kv_client():
            return await pc.endpoint("kv").client()

        handler = pkg.disagg.DecodeHandler(de, kv_client_factory=kv_client, worker_id=2,
                                           backoff_base_s=0.0, **decode_kw)
        first = await pkg.collect(pkg.disagg.PrefillHandler(pe, worker_id=1).generate(
            _req(pkg, prompt), pkg.Context()))
        token, dp = first[0].token_ids[0], first[0].disaggregated_params
        req = _req(pkg, list(prompt) + [token], MAX_TOKENS - 1)
        req.disaggregated_params = dp
        with pkg.faults.armed(plan) as plane:
            items = await pkg.collect(handler.generate(req, pkg.Context()))
        counts = dict(transfers=handler.transfers, failures=handler.transfer_failures,
                      by_kind=dict(handler.transfer_failures_by_kind),
                      retries=handler.pull_retries, fallbacks=handler.pull_fallbacks,
                      blocks=handler.blocks_pulled, opens=handler.breaker_opens,
                      injected=dict(plane.injected),
                      decode_prefilled=de.prefill_tokens,
                      flight=[e["kind"] for e in handler.flight.snapshot()])
        return [token] + _tokens(items), counts, handler
    finally:
        for s in served:
            await s.shutdown(grace_period=1)
        await pe.stop()
        await de.stop()
        await rt.shutdown(grace_period=1)


async def test_an_export_failing_at_one_chunk_resumes_from_its_anchor(weights, aggregated):
    """``disagg.kv.export`` fails at the 3rd chunk: the attempt dies with
    two blocks imported, the retry asks only for the rest (from the
    anchor), the stream is exact, and the counts are JAX's handler's under
    the same plan."""
    rule = dict(point="disagg.kv.export", at=(3,), kind="connection")
    got = {}
    for pkg in (JAX, PORT):
        toks, counts, _ = await _pull_counts(weights, pkg, rule)
        assert toks == aggregated[tuple(PROMPT2)]
        got[pkg.name] = counts
    assert got["port"] == got["jax"]
    assert got["port"]["retries"] == 1 and got["port"]["failures"] == 1
    assert got["port"]["blocks"] == 5 and got["port"]["fallbacks"] == 0
    assert got["port"]["injected"] == {"disagg.kv.export": 1}


async def test_failures_past_the_breaker_fall_back_to_local_prefill(weights, aggregated):
    """Every chunk's import fails: three attempts fail, the third opens the
    (src -> this worker) breaker, the pull gives up and the stream is
    served by a local prefill, exact, with ``pull_fallbacks`` counted; the
    breaker is advertised and rendered. JAX's handler counts the same."""
    rule = dict(point="disagg.pull.chunk", every=1, kind="connection")
    got = {}
    for pkg in (JAX, PORT):
        toks, counts, handler = await _pull_counts(weights, pkg, rule, breaker_open_after=3,
                                                   pull_attempts=5)
        assert toks == aggregated[tuple(PROMPT2)]
        got[pkg.name] = counts
        assert handler.open_breaker_srcs() == [1]
        assert f'dynamo_tpu_disagg_breaker_open{{src="1"}} 1' in handler.metrics.render()
    assert got["port"] == got["jax"]
    c = got["port"]
    assert (c["failures"], c["opens"], c["fallbacks"], c["blocks"]) == (3, 1, 1, 0)
    assert c["decode_prefilled"] == len(PROMPT2) + 1  # the whole prompt, locally
    assert c["flight"].count("pull_error") == 3 and c["flight"][-1] == "pull_done"


async def test_with_the_fallback_off_the_failure_reaches_migration(weights, aggregated):
    """A strict decode handler (no local prefill) raises DisaggTransferError
    when its pull fails; Migration counts it under ``disagg`` and
    re-dispatches the stream, which the next worker serves whole."""
    rt = DistributedRuntime.detached()
    pe, de, other = _engine(weights, PORT), _engine(weights, PORT), _engine(weights, PORT)
    ns = rt.namespace("strict")
    served = []
    try:
        pc = ns.component("prefill")
        served.append(await pc.endpoint("generate").serve_endpoint(
            tdisagg.PrefillHandler(pe, worker_id=1).generate, instance_id=1))

        async def broken_kv_client():
            raise ConnectionError("the kv endpoint is gone")

        strict = tdisagg.DecodeHandler(de, kv_client_factory=broken_kv_client, worker_id=2,
                                       fallback_local_prefill=False, pull_attempts=1)

        class Workers:
            """The first dispatch lands on the strict worker, the next on
            a healthy aggregated one."""
            calls = 0

            def generate(self, request, context):
                Workers.calls += 1
                target = strict if Workers.calls == 1 else other
                return target.generate(request, context)

        async def prefill_client():
            return await pc.endpoint("generate").client()

        migration = Migration(3)
        pipeline = build_pipeline([migration, tdisagg.PrefillRouter(prefill_client,
                                                                    threshold_tokens=8)],
                                  Workers())
        toks = _tokens(await tcollect(pipeline.generate(_req(PORT).to_dict(), TContext())))
        assert toks == aggregated[tuple(PROMPT)]
        assert Workers.calls == 2 and strict.pull_fallbacks == 1
        assert 'reason="disagg"} 1' in migration.metrics.render()
        with pytest.raises(tdisagg.DisaggTransferError):
            await strict._pull_blocks(tproto.DisaggregatedParams(
                worker_id=1, kv_transfer={"block_hashes": compute_block_hashes(PROMPT2, 4)}))
    finally:
        for s in served:
            await s.shutdown(grace_period=1)
        for e in (pe, de, other):
            await e.stop()
        await rt.shutdown(grace_period=1)


async def test_a_stale_incarnations_reply_is_dropped(weights, aggregated):
    """A reply stamped with another incarnation than the bootstrap's (a
    restarted prefill worker) is never scattered: the pull fails as a
    connection failure and the stream falls back, exact."""
    async with _Flow(weights) as f:
        first = await tcollect(tdisagg.PrefillHandler(f.prefill, worker_id=1).generate(
            _req(PORT), TContext()))
        token, dp = first[0].token_ids[0], first[0].disaggregated_params
        dp.kv_transfer["incarnation"] += 1
        req = _req(PORT, PROMPT + [token], MAX_TOKENS - 1)
        req.disaggregated_params = dp
        toks = [token] + _tokens(await tcollect(f.handler.generate(req, TContext())))
        assert toks == aggregated[tuple(PROMPT)]
        assert f.handler.blocks_pulled == 0 and f.handler.pull_fallbacks == 1
        assert f.handler.transfer_failures_by_kind == {"connection": f.handler.pull_attempts}


def test_link_bandwidth_entries_age_out():
    dh = thandlers.DecodeHandler(engine=None, worker_id=2)
    dh._observe_link(7, 1 << 20, 1.0)
    assert dh.link_bandwidth() == {7: pytest.approx(float(1 << 20))}
    bw, at = dh._link_bw[7]
    dh._link_bw[7] = (bw, at - thandlers.LINK_BW_TTL_S - 1)
    assert dh.link_bandwidth() == {} and 7 not in dh._link_bw
    dh._observe_link(8, 1 << 20, 1.0)
    dh._observe_link(8, 3 << 20, 1.0)  # the EWMA: 0.25 new + 0.75 old
    assert dh.link_bandwidth() == {8: pytest.approx(1.5 * (1 << 20))}
    text = dh.metrics.render()
    assert 'src="8"' in text and 'src="7"' not in text


def test_circuit_breaker_transitions_equal_jax():
    trace = {}
    for pkg in (JAX, PORT):
        now = [0.0]
        seen = []
        b = pkg.handlers.CircuitBreaker(2, 5.0, clock=lambda: now[0],
                                        on_transition=lambda o, n: seen.append((o, n)))
        steps = []
        for op, dt in (("fail", 0), ("allow", 0), ("fail", 0), ("allow", 1), ("adv", 0),
                       ("allow", 5), ("adv", 0), ("allow", 0), ("fail", 0), ("adv", 0),
                       ("allow", 6), ("abort", 0), ("allow", 6), ("ok", 0), ("allow", 0)):
            now[0] += dt
            out = {"fail": b.record_failure, "ok": b.record_success, "allow": b.allow,
                   "adv": b.advertised, "abort": b.abort_probe}[op]()
            steps.append((op, out, b.state, b.consecutive_failures))
        trace[pkg.name] = (steps, seen)
    assert trace["port"] == trace["jax"]


def test_disagg_metrics_exposition_equals_jax():
    texts = {}
    for pkg in (JAX, PORT):
        m = pkg.handlers.DisaggMetrics()
        breaker = pkg.handlers.CircuitBreaker(1, 30.0)
        breaker.record_failure()
        m.watch_links(lambda: {7: 1.5e9, 9: 2.0e8}, "2")
        m.watch_breakers(lambda b=breaker: {7: b})
        m.transfers.inc()
        m.transfers.inc()
        m.transfer_failures.inc(error_kind="timeout")
        m.transfer_failures.inc(error_kind="connection")
        m.pull_retries.inc()
        m.breaker_transitions.inc(src="7", to="open")
        m.blocks_pulled.inc(187)
        m.bytes_pulled.inc(19_532_776)
        m.kv_wire_bytes.inc(19_532_776, dtype="int8")
        for s in (0.004, 0.25, 3.0):
            m.transfer_duration.observe(s)
        texts[pkg.name] = (m.render(), m.render(openmetrics=True))
    assert texts["port"] == texts["jax"]


def test_decode_handler_knobs_equal_jax():
    for name in ("PULL_MAX_ATTEMPTS", "PULL_BACKOFF_BASE_S", "PULL_BACKOFF_CAP_S",
                 "PULL_DEFAULT_TIMEOUT_S", "BREAKER_OPEN_AFTER", "BREAKER_COOLDOWN_S",
                 "KV_CHUNK_BYTES", "LINK_BW_EWMA_ALPHA", "LINK_BW_TTL_S"):
        assert getattr(thandlers, name) == getattr(jhandlers, name), name
    assert thandlers.ACCEPT_WIRE_DTYPES == jhandlers.ACCEPT_WIRE_DTYPES
    assert sorted(tdisagg.__all__) == sorted(
        n for n in jdisagg.__all__ if "andoff" not in n.lower())
