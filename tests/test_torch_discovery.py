"""Discovery and the frontend's pieces, the port's against JAX's.

``register_llm`` writes JAX's key and doc; the same discovery events into
both packages' ``ModelWatcher`` leave both managers listing the same
models; liveness's dead callback evicts an instance and aborts its streams
into Migration, which finishes them on the other worker; a stream whose
connection drops re-dispatches to the other worker while the first stays
routable for later requests; the busy shed
answers 503 with ``Retry-After: 1`` as JAX's does; the service strips a
client's own ``_pinned_worker`` key and honours the ``x-dynamo-worker``
header as JAX's does, and the preprocessor carries the pin into
``extra``. Last, the whole chain in one process: two port workers
(``worker.__main__.serve_worker`` with weights from ``params_from_jax``)
behind the port's ModelWatcher and HttpService give the SSE texts that two
JaxEngine workers behind JAX's give, at temperature 0, and
``/clear_kv_blocks`` fans out over the ``control`` endpoints and clears
every block the workers cached, as JAX's does."""

import asyncio
import json
import types

import jax
import numpy as np
import pytest

from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.http import HttpService as JHttpService
from dynamo_tpu.http import ModelManager as JModelManager
from dynamo_tpu.llm import discovery as jdisc
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm import preprocessor as jpre
from dynamo_tpu.llm import tokenizer as jtok
from dynamo_tpu.llm.entrypoint import resolve_chat_template as jtemplate
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.router import KvEventPublisher as JKvPub
from dynamo_tpu.router import LoadPublisher as JLoadPub
from dynamo_tpu.runtime.discovery import model_key as jmodel_key
from dynamo_tpu.runtime.distributed import DistributedRuntime as JRuntime
from dynamo_tpu_torch.http import HttpService as THttpService
from dynamo_tpu_torch.http import ModelManager as TModelManager
from dynamo_tpu_torch.llm import discovery as tdisc
from dynamo_tpu_torch.llm import model_card as tcard
from dynamo_tpu_torch.llm import preprocessor as tpre
from dynamo_tpu_torch.llm import tokenizer as ttok
from dynamo_tpu_torch.llm.entrypoint import resolve_chat_template as ttemplate
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.router import LoadPublisher as TLoadPub
from dynamo_tpu_torch.runtime.context import Context as TContext
from dynamo_tpu_torch.runtime.discovery import model_key as tmodel_key
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime as TRuntime
from dynamo_tpu_torch.runtime.liveness import LivenessConfig
from dynamo_tpu_torch.runtime.network.tcp import StreamDisconnectedError
from dynamo_tpu_torch.worker import __main__ as tworker
from tests.test_torch_http_service import Pair, call, frames, mask

JAX = types.SimpleNamespace(disc=jdisc, card=jcard, Runtime=JRuntime, Manager=JModelManager,
                            model_key=jmodel_key, common=jcommon)
TORCH = types.SimpleNamespace(disc=tdisc, card=tcard, Runtime=TRuntime, Manager=TModelManager,
                              model_key=tmodel_key, common=tcommon)
EP = types.SimpleNamespace(namespace="dynamo", component="backend", name="generate")


def _card(api, name="tiny-llama", **over):
    return api.card.ModelDeploymentCard(
        name=name, context_length=256, kv_block_size=16, eos_token_ids=[2],
        runtime_config=api.card.RuntimeConfig(total_kv_blocks=128, kv_block_size=16,
                                              max_num_seqs=4, max_context_len=256),
        **over)


class _Recorder:
    """A runtime that records what register_llm puts under its lease."""

    def __init__(self):
        self.puts = []

    async def put_leased(self, key, doc):
        self.puts.append((key, doc))


async def test_register_llm_key_and_doc_equal_jax():
    got = []
    for api in (JAX, TORCH):
        rt = _Recorder()
        key = await api.disc.register_llm(rt, _card(api), EP, 0x1234, incarnation=0x77)
        got.append((key, rt.puts))
    assert got[1] == got[0]
    assert got[1][0] == "models/dynamo/tiny-llama/0000000000001234"


async def _until(cond, timeout=10.0):
    t0 = asyncio.get_running_loop().time()
    while not cond():
        assert asyncio.get_running_loop().time() - t0 < timeout, "condition never held"
        await asyncio.sleep(0.01)


async def test_the_same_discovery_events_leave_the_same_models_listed():
    """Instances come and go under two models; after each event both
    managers list the same models (a model leaves with its last
    instance)."""
    events = [("put", "tiny-llama", 0x1), ("put", "other", 0x2), ("put", "tiny-llama", 0x3),
              ("delete", "tiny-llama", 0x1), ("delete", "other", 0x2),
              ("delete", "tiny-llama", 0x3), ("put", "other", 0x4)]
    listed = {}
    for api in (JAX, TORCH):
        rt = api.Runtime.detached()
        manager = api.Manager()
        watcher = api.disc.ModelWatcher(rt, manager)
        await watcher.start()
        seen, live = [], set()
        try:
            for op, name, iid in events:
                key = api.model_key("dynamo", name, iid)
                if op == "put":
                    rec = _Recorder()
                    await api.disc.register_llm(rec, _card(api, name), EP, iid, incarnation=iid)
                    await rt.discovery.put(key, rec.puts[0][1])
                    live.add((name, iid))
                else:
                    await rt.discovery.delete(key)
                    live.discard((name, iid))
                want_in = any(n == name for n, _ in live)
                await _until(lambda: (manager.get(name) is not None) == want_in)
                seen.append(manager.names())
        finally:
            await watcher.stop()
            await rt.shutdown(grace_period=1)
        listed[api is TORCH] = seen
    assert listed[True] == listed[False]
    assert listed[True] == [["tiny-llama"], ["other", "tiny-llama"], ["other", "tiny-llama"],
                            ["other", "tiny-llama"], ["tiny-llama"], [], ["other"]]


def test_a_multimodal_card_is_refused_naming_the_roadmap_item():
    async def run():
        rt = TRuntime.detached()
        watcher = tdisc.ModelWatcher(rt, TModelManager())
        rec = _Recorder()
        await tdisc.register_llm(rec, _card(TORCH, model_type="multimodal"), EP, 1)
        with pytest.raises(ValueError, match="ROADMAP A9"):
            await watcher._add_instance("tiny-llama", rec.puts[0][1])
        await rt.shutdown(grace_period=1)

    asyncio.run(run())


class _Counting:
    """A worker engine that streams token ids counting on from the prompt
    length, one every ``gap_s``: a stream re-dispatched with its tokens
    carried continues where it stopped."""

    def __init__(self, gap_s=0.02):
        self.gap_s = gap_s
        self.requests = 0

    async def generate(self, request, context):
        self.requests += 1
        pre = tcommon.PreprocessedRequest.from_dict(request) if isinstance(request, dict) \
            else request
        n0 = len(pre.token_ids)
        for k in range(pre.stop.max_tokens):
            await asyncio.sleep(self.gap_s)
            last = k == pre.stop.max_tokens - 1
            yield tcommon.BackendOutput(token_ids=[3 + (n0 + k) % 200],
                                        finish_reason=tcommon.FinishReason.LENGTH if last
                                        else None)


async def test_a_dead_worker_is_evicted_and_its_stream_migrates():
    """Worker 1 stops reporting load: liveness declares it dead, the client
    drops it and aborts its stream with WorkerLostError, and Migration
    finishes the stream on worker 2 with the tokens carried."""
    rt = TRuntime.detached()
    engines = {1: _Counting(), 2: _Counting()}
    served = []
    for iid, eng in engines.items():
        ep = rt.namespace("dynamo").component("backend").endpoint("generate")
        served.append(await ep.serve_endpoint(eng.generate, instance_id=iid,
                                              metadata={"incarnation": 5}))
        await tdisc.register_llm(rt, _card(TORCH), ep, iid, incarnation=5)
    load = TLoadPub(rt.event_plane, "dynamo", "backend", 2, lambda: {}, interval_s=0.05,
                    incarnation=5)
    manager = TModelManager()
    watcher = tdisc.ModelWatcher(rt, manager, liveness_config=LivenessConfig(
        interval_s=0.05, suspect_after=2, dead_after=4))
    await watcher.start()
    load.start()
    try:
        entry = manager.get("tiny-llama")
        body = {"model": "tiny-llama", "prompt": "hello world", "max_tokens": 40,
                "temperature": 0.0, "_pinned_worker": 1}
        toks, finish = [], None
        async for item in entry.engine.generate(body, TContext()):
            if not isinstance(item, dict):
                toks += item.token_ids
                finish = item.finish_reason or finish
        state = watcher._models["tiny-llama"]
        n0 = len(toks) and toks[0] - 3
        assert finish == tcommon.FinishReason.LENGTH and len(toks) == 40
        assert toks == [3 + (n0 + k) % 200 for k in range(40)]
        assert engines[1].requests == 1 and engines[2].requests == 1
        assert watcher.migration_metrics.migrations.value(reason="worker_lost") == 1
        assert state["client"].instance_ids == [2]
        assert state["liveness"].dead_workers() == [1]
    finally:
        await load.close()
        await watcher.stop()
        for s in served:
            await s.shutdown(grace_period=1)
        await rt.shutdown(grace_period=1)


@pytest.mark.parametrize("workers", [(1, 2), (1,)], ids=["two", "one"])
async def test_a_dropped_stream_skips_its_worker_for_that_request_only(monkeypatch, workers):
    """Worker 1's connection drops before the first item of a request
    pinned to it: Migration re-dispatches that request to worker 2 (the
    Client skips the instance that failed this request), worker 1 stays
    routable, and the next request pinned to it runs there. With worker 1
    alone, the re-dispatch goes back to it."""
    rt = TRuntime.detached()
    engines = {iid: _Counting(gap_s=0.001) for iid in workers}
    served = []
    for iid, eng in engines.items():
        ep = rt.namespace("dynamo").component("backend").endpoint("generate")
        served.append(await ep.serve_endpoint(eng.generate, instance_id=iid))
        await tdisc.register_llm(rt, _card(TORCH), ep, iid)
    real, drops = rt.request_plane_client, []

    class _Dropped:
        async def generate(self, request, context):
            raise StreamDisconnectedError("connection dropped")
            yield

    def once_dropped(instance):
        if instance.instance_id == 1 and not drops:
            drops.append(instance.instance_id)
            return _Dropped()
        return real(instance)

    monkeypatch.setattr(rt, "request_plane_client", once_dropped)
    manager = TModelManager()
    watcher = tdisc.ModelWatcher(rt, manager, enable_liveness=False)
    await watcher.start()
    try:
        entry = manager.get("tiny-llama")
        body = {"model": "tiny-llama", "prompt": "hello world", "max_tokens": 8,
                "temperature": 0.0, "_pinned_worker": 1}
        runs = []
        for _ in range(2):
            toks = []
            async for item in entry.engine.generate(dict(body), TContext()):
                if not isinstance(item, dict):
                    toks += item.token_ids
            runs.append((len(toks), *(e.requests for e in engines.values())))
        assert drops == [1]
        assert runs == ([(8, 0, 1), (8, 1, 1)] if len(workers) == 2 else [(8, 1), (8, 2)])
        assert watcher.migration_metrics.migrations.value(reason="connection") == 1
        assert watcher._models["tiny-llama"]["client"].instance_ids == list(workers)
    finally:
        await watcher.stop()
        for s in served:
            await s.shutdown(grace_period=1)
        await rt.shutdown(grace_period=1)


class _Echo:
    """Records the OpenAI bodies the service hands its model, and answers
    each with one finished output of its protocol module."""

    def __init__(self, common):
        self.common, self.bodies = common, []

    async def generate(self, request, context):
        self.bodies.append(request)
        yield self.common.PostprocessedOutput(text="ok", token_ids=[7], cumulative_tokens=1,
                                              finish_reason=self.common.FinishReason.STOP)


class _Busy:
    """A WorkerLoadMonitor stand-in: every worker busy, or none."""

    def __init__(self, busy):
        self.busy = busy

    def all_busy(self, thresholds):
        return self.busy and thresholds.configured


def _pair(jengine, tengine, monitor):
    pair = Pair([], [])
    for service, engine, api in zip(pair.services, (jengine, tengine), (JAX, TORCH)):
        service.models.register("m", engine, _card(api, "m"), monitor=monitor)
    return pair


@pytest.mark.parametrize("busy", [True, False])
async def test_busy_shed_answers_503_with_retry_after_as_jax(busy):
    jengine, tengine = _Echo(jcommon), _Echo(tcommon)
    body = {"model": "m", "prompt": "hi", "max_tokens": 4}
    async with _pair(jengine, tengine, _Busy(busy)) as pair:
        before = await pair.both("POST", "/v1/completions", body)
        await pair.both("POST", "/busy_threshold", {"model": "m", "waiting_requests_threshold": 1})
        after = await pair.both("POST", "/v1/completions", body)
    (jb, tb), (ja, ta) = before, after
    assert [r[0] for r in (jb, tb)] == [200, 200]
    assert (ta[0], ta[1].get("retry-after"), mask(json.loads(ta[2]))) == \
        (ja[0], ja[1].get("retry-after"), mask(json.loads(ja[2])))
    if busy:
        assert ta[0] == 503 and ta[1]["retry-after"] == "1"
        assert json.loads(ta[2])["error"]["type"] == "service_unavailable"
        assert len(tengine.bodies) == len(jengine.bodies) == 1
    else:
        assert ta[0] == 200 and len(tengine.bodies) == 2


PINS = [("header", {"x-dynamo-worker": "257"}, {}),
        ("header with port", {"x-dynamo-worker": "258:9000"}, {}),
        ("client key stripped", {}, {"_pinned_worker": 300}),
        ("header wins", {"x-dynamo-worker": "259"}, {"_pinned_worker": 301}),
        ("bad header", {"x-dynamo-worker": "abc"}, {"_pinned_worker": 302})]


async def test_pin_is_stripped_and_honoured_as_jax():
    jengine, tengine = _Echo(jcommon), _Echo(tcommon)
    async with _pair(jengine, tengine, None) as pair:
        for _, headers, extra in PINS:
            for r in await pair.both("POST", "/v1/completions",
                                     {"model": "m", "prompt": "hi", "max_tokens": 4, **extra},
                                     headers):
                assert r[0] == 200
    got = [b.get("_pinned_worker") for b in tengine.bodies]
    assert got == [b.get("_pinned_worker") for b in jengine.bodies]
    assert got == [257, 258, None, 259, None]
    # the preprocessor carries the pin into PreprocessedRequest.extra
    extras = []
    for pre, tok, tmpl, api in ((jpre, jtok, jtemplate, JAX), (tpre, ttok, ttemplate, TORCH)):
        card = _card(api)
        p = pre.OpenAIPreprocessor(card, tok.tiny_tokenizer(), tmpl(card))
        extras.append([p.preprocess(dict(b, model="tiny-llama")).extra.get("_pinned_worker")
                       for b in (tengine.bodies if api is TORCH else jengine.bodies)])
    assert extras[1] == extras[0] == got


# -- the chain in one process ---------------------------------------------

WORKER_ARGV = ["--model", "tiny", "--num-kv-blocks", "128", "--max-num-seqs", "4",
               "--max-model-len", "256", "--prefill-chunk", "32", "--decode-steps", "4"]
CHAIN_BODIES = [
    {"model": "tiny-llama", "prompt": "hello world this is a test", "max_tokens": 12},
    {"model": "tiny-llama", "messages": [{"role": "user", "content": "paged attention"}],
     "max_tokens": 10},
    {"model": "tiny-llama", "prompt": " ".join(["the quick brown fox"] * 12), "max_tokens": 9},
    {"model": "tiny-llama", "prompt": "hello world this is a test", "max_tokens": 12},
]


async def _jax_worker(rt, args, params, iid):
    """JAX's worker body (dynamo_tpu/worker/__main__.py) for a JaxEngine on
    ``params``, without the pieces the port's worker refuses."""
    from dynamo_tpu.runtime.liveness import process_incarnation

    jc = jconfig.tiny_config()
    kv_pub = JKvPub(rt.event_plane, "dynamo", "backend", iid)
    engine = JaxEngine(JaxEngineArgs(
        config=jc, block_size=args.block_size, num_kv_blocks=args.num_kv_blocks,
        max_num_seqs=args.max_num_seqs, max_model_len=args.max_model_len,
        prefill_chunk=args.prefill_chunk, decode_steps=args.decode_steps,
        pipeline_depth=args.pipeline_depth), params, on_kv_event=kv_pub.on_kv_event)
    kv_pub.set_snapshot_fn(engine.pool.committed_view)
    load_pub = JLoadPub(rt.event_plane, "dynamo", "backend", iid, engine.stats,
                        total_blocks=args.num_kv_blocks)
    card = jcard.ModelDeploymentCard(
        name=jc.name, context_length=args.max_model_len, kv_block_size=args.block_size,
        eos_token_ids=list(jc.eos_token_ids), runtime_config=jcard.RuntimeConfig(
            total_kv_blocks=args.num_kv_blocks, kv_block_size=args.block_size,
            max_num_seqs=args.max_num_seqs, max_context_len=args.max_model_len))
    component = rt.namespace("dynamo").component("backend")
    await engine.start()

    async def control(request, context):
        op = request.get("op")
        if op == "clear_kv_blocks":
            yield {"cleared": engine.clear_kv_blocks()}
        elif op == "stats":
            yield engine.stats()

    ctl = await component.endpoint("control").serve_endpoint(control, instance_id=iid)
    served = await component.endpoint("generate").serve_endpoint(
        engine.generate, instance_id=iid, metadata={"incarnation": process_incarnation()})
    await jdisc.register_llm(rt, card, component.endpoint("generate"), iid,
                             incarnation=process_incarnation())
    load_pub.start()

    async def close():
        await load_pub.close()
        await kv_pub.close()
        await served.shutdown(grace_period=1)
        await ctl.shutdown(grace_period=1)
        await engine.stop()

    return engine, close


def _sse_text(body):
    """An SSE body's text and finish reason."""
    text, finish = "", None
    for kind, payload in frames(body.decode()):
        if kind == "data" and payload["choices"]:
            ch = payload["choices"][0]
            text += ch.get("text") or (ch.get("delta") or {}).get("content") or ""
            finish = ch.get("finish_reason") or finish
    return text, finish


async def _chain(api, params, monkeypatch):
    """Two workers and the frontend pieces in one process: the streamed
    texts of CHAIN_BODIES, one at a time, then /clear_kv_blocks."""
    rt = api.Runtime.detached()
    args = tworker.build_parser().parse_args(WORKER_ARGV + ["--device", "cpu"])
    closers, engines = [], []
    for iid in (0x101, 0x202):
        if api is TORCH:
            monkeypatch.setenv("DYN_TPU_WORKER_ID", str(iid))
            tc = tconfig.tiny_config()
            w = await tworker.serve_worker(args, rt, params=params_from_jax(params, tc, "cpu"))
            engines.append(w.engine)
            closers.append(w.close)
        else:
            engine, close = await _jax_worker(rt, args, params, iid)
            engines.append(engine)
            closers.append(close)
    manager = api.Manager()
    watcher = api.disc.ModelWatcher(rt, manager)
    await watcher.start()
    service = (THttpService if api is TORCH else JHttpService)(manager, host="127.0.0.1",
                                                               port=0)
    port = await service.start()
    try:
        await _until(lambda: len(watcher._models.get("tiny-llama", {}).get("instances", ()))
                     == 2)
        texts = []
        for body in CHAIN_BODIES:
            path = "/v1/chat/completions" if "messages" in body else "/v1/completions"
            status, _, raw = await asyncio.to_thread(
                call, port, "POST", path, dict(body, stream=True, temperature=0.0))
            assert status == 200
            texts.append(_sse_text(raw))
        await _until(lambda: not any(e.stats()["active_seqs"] or e.stats()["inflight_bursts"]
                                     for e in engines))
        cached = sum(e.pool.cached_blocks for e in engines)
        status, _, raw = await asyncio.to_thread(call, port, "POST", "/clear_kv_blocks")
        cleared = (status, json.loads(raw), cached, sum(e.pool.cached_blocks for e in engines))
        return texts, cleared
    finally:
        await service.stop(grace_period=1)
        await watcher.stop()
        for close in closers:
            await close()
        await rt.shutdown(grace_period=1)


async def test_in_process_chain_gives_jax_texts_and_clears_kv(monkeypatch):
    jc = jconfig.tiny_config()
    params = jllama.init_params(jc, jax.random.PRNGKey(5))
    tree = jax.tree.map(np.asarray, params)
    jtexts, jcleared = await _chain(JAX, params, monkeypatch)
    ttexts, tcleared = await _chain(TORCH, tree, monkeypatch)
    assert ttexts == jtexts
    assert all(t and f == "length" for t, f in ttexts)
    # which worker caches what follows the routing (load-report timing), so
    # each side is held to its own workers' cached blocks
    for status, doc, cached, after in (tcleared, jcleared):
        assert (status, doc, after) == (
            200, {"results": {"tiny-llama": {"cleared_blocks": cached}}}, 0)
        assert cached > 0
