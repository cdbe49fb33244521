"""KV events and load reports of the port against the JAX package's:

  - ``TorchEngine(on_kv_event=)`` and ``JaxEngine(on_kv_event=)`` (both at
    pipeline depth 2) on the same weights and requests — shared prefixes,
    a prefix hit, preemption by recompute on a small pool, cache clears —
    emit the same ``KvEvent`` sequence: kinds, hashes, parents and order,
    the port's on the event loop's thread (a publisher's queue is an
    asyncio one);
  - ``LoadPublisher.snapshot()`` over each engine is equal after the same
    requests (the load-report keys of ``TorchEngine.stats()``);
  - across the packages over the ZMQ event plane (the port's broker): JAX's
    publisher with a JaxEngine and the port's publisher with a TorchEngine
    feed a port ``KvRouter`` and a JAX ``KvRouter`` at once; the indexes
    equal each engine's committed blocks, both routers answer
    ``find_best_match`` alike, and restarted routers rebuild the same
    indexes from the publishers' snapshots.
"""

import asyncio
import threading
import types

import jax
import numpy as np
import pytest

from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.router import publisher as jpublisher
from dynamo_tpu.router import router as jrouter
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu.runtime.events import zmq_plane as jzmq
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.router import publisher as tpublisher
from dynamo_tpu_torch.router import router as trouter
from dynamo_tpu_torch.runtime import context as tcontext
from dynamo_tpu_torch.router.protocols import kv_events_topic, kv_sync_topic, load_topic
from dynamo_tpu_torch.runtime.events import zmq_plane as tzmq
from dynamo_tpu_torch.tokens.blocks import compute_block_hashes
from tests.test_torch_event_plane import get, publisher_holds_subscriptions, until, until_delivered

JAX = types.SimpleNamespace(proto=jproto, Context=jcontext.Context)
TORCH = types.SimpleNamespace(proto=tproto, Context=tcontext.Context)
ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=96,
            prefill_chunk=32, decode_steps=4)
PREFIX = [int(t) for t in np.random.default_rng(1).integers(3, 500, 12)]  # 3 blocks
PROMPTS = [PREFIX + [int(t) for t in np.random.default_rng(10 + i).integers(3, 500, n)]
           for i, n in enumerate((5, 9, 14))] + [
    [int(t) for t in np.random.default_rng(20).integers(3, 500, 23)]]


@pytest.fixture(scope="module")
def weights():
    jc = jconfig.tiny_config()
    params = jllama.init_params(jc, jax.random.PRNGKey(7))
    return jc, tconfig.tiny_config(), params, jax.tree.map(np.asarray, params)


def _torch_engine(weights, on_kv_event=None, **over):
    _, tc, _, tree = weights
    return TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                       pipeline_depth=2, **{**ARGS, **over}),
                       params=params_from_jax(tree, tc, "cpu"), on_kv_event=on_kv_event)


def _jax_engine(weights, on_kv_event=None, **over):
    jc, _, params, _ = weights
    return JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=2, **{**ARGS, **over}),
                     params=params, on_kv_event=on_kv_event)


async def _one(engine, api, prompt, max_tokens=8):
    p = api.proto
    req = p.PreprocessedRequest(
        token_ids=list(prompt), request_id="r", sampling=p.SamplingOptions(temperature=0.0),
        stop=p.StopConditions(max_tokens=max_tokens))
    toks = []
    async for out in engine.generate(req, api.Context()):
        assert out.error is None, out.error
        toks += out.token_ids
    return toks


async def _settle(engine):
    """The bursts still in flight after the last stream ended, reaped."""
    for _ in range(500):
        if not engine.stats()["inflight_bursts"]:
            return
        await asyncio.sleep(0.01)
    raise AssertionError("bursts stayed in flight")


async def _traffic(engine, api, scenario):
    """The scenario's requests; returns the streams."""
    outs = []
    if scenario == "preemption":  # 8 blocks of 4: decode growth preempts
        outs += await asyncio.gather(*(_one(engine, api, p, n) for p, n in zip(
            (list(range(10, 18)), list(range(20, 28))), (14, 18))))
        await _settle(engine)
        return outs
    outs.append(await _one(engine, api, PROMPTS[0]))  # cold
    outs += await asyncio.gather(*(_one(engine, api, p) for p in PROMPTS[1:]))  # prefix hits
    await _settle(engine)
    if scenario == "clear":
        engine.pool.clear()
        outs.append(await _one(engine, api, PROMPTS[2]))
        await _settle(engine)
        engine.pool.clear()
    return outs


def _event_tuples(events):
    return [(e.kind, list(e.block_hashes), e.parent_hash) for e in events]


@pytest.mark.parametrize("scenario", ["prefixes", "clear", "preemption"])
async def test_engines_emit_the_same_kv_events(weights, scenario):
    over = dict(max_num_seqs=2, num_kv_blocks=8, max_model_len=64) if scenario == "preemption" \
        else {}
    got, threads = {}, set()
    for name, make, api in (("jax", _jax_engine, JAX), ("torch", _torch_engine, TORCH)):
        events = []

        def on_kv_event(event, events=events, name=name):
            events.append(event)
            if name == "torch":
                threads.add(threading.get_ident())

        engine = make(weights, on_kv_event, **over)
        try:
            outs = await _traffic(engine, api, scenario)
            stats = engine.stats()
        finally:
            await engine.stop()
        got[name] = (outs, _event_tuples(events), engine.preemptions, stats)
    (j_outs, j_events, j_pre, _), (t_outs, t_events, t_pre, t_stats) = got["jax"], got["torch"]
    assert t_outs == j_outs
    assert t_pre == j_pre
    assert t_events == j_events
    assert threads == {threading.get_ident()}  # the loop runs on this thread
    kinds = {k for k, _, _ in t_events}
    assert "stored" in kinds
    if scenario == "preemption":
        assert t_pre > 0, "scenario no longer preempts"
    if scenario == "clear":
        assert "cleared" in kinds and "removed" in kinds
    if scenario == "prefixes":  # the shared prefix was matched, not recomputed
        assert t_stats["prefill_tokens"] < sum(len(p) for p in PROMPTS)


async def test_load_publisher_snapshots_equal(weights):
    snaps = []
    for make, api, pub_mod in ((_jax_engine, JAX, jpublisher), (_torch_engine, TORCH, tpublisher)):
        engine = make(weights)
        try:
            await _traffic(engine, api, "prefixes")
            lp = pub_mod.LoadPublisher(None, "ns", "comp", 3, engine.stats, incarnation=1)
            busy = [asyncio.ensure_future(_one(engine, api, p, 30)) for p in PROMPTS[:2]]
            while engine.stats()["active_seqs"] < 2:
                await asyncio.sleep(0.001)
            running = lp.snapshot().to_dict()
            await asyncio.gather(*busy)
            await _settle(engine)
            snaps.append((running, lp.snapshot().to_dict()))
        finally:
            await engine.stop()
    assert snaps[0][1] == snaps[1][1]
    # while running the shape agrees (counts move with timing)
    assert snaps[0][0].keys() == snaps[1][0].keys()
    for k in ("active_seqs", "total_blocks", "kv_high_watermark", "draining", "incarnation"):
        assert snaps[0][0][k] == snaps[1][0][k], k
    assert snaps[1][1]["total_blocks"] == ARGS["num_kv_blocks"]
    assert snaps[1][1]["kv_high_watermark"] == 0.95


def _held(router, worker):
    """The hashes a port router's Python radix tree holds for a worker."""
    return set(router.indexer.tree._worker_blocks.get(worker, ()))


async def test_routers_of_both_packages_index_both_packages_workers(weights):
    broker = tzmq.EventBroker()
    broker.start()
    planes = [tzmq.ZmqEventPlane(broker.address), jzmq.ZmqEventPlane(broker.address),
              tzmq.ZmqEventPlane(broker.address), jzmq.ZmqEventPlane(broker.address)]
    t_worker_plane, j_worker_plane, t_router_plane, j_router_plane = planes
    ns, comp = "dynamo", "backend"
    jpub = jpublisher.KvEventPublisher(j_worker_plane, ns, comp, 1)
    tpub = tpublisher.KvEventPublisher(t_worker_plane, ns, comp, 2)
    jeng = _jax_engine(weights, jpub.on_kv_event)
    teng = _torch_engine(weights, tpub.on_kv_event)
    jpub.set_snapshot_fn(jeng.pool.committed_view)
    tpub.set_snapshot_fn(teng.pool.committed_view)
    loads = [jpublisher.LoadPublisher(j_worker_plane, ns, comp, 1, jeng.stats, incarnation=1),
             tpublisher.LoadPublisher(t_worker_plane, ns, comp, 2, teng.stats, incarnation=1)]
    routers = []

    async def start_routers():
        rs = [trouter.KvRouter(types.SimpleNamespace(event_plane=t_router_plane), ns, comp,
                               block_size=4),
              jrouter.KvRouter(types.SimpleNamespace(event_plane=j_router_plane), ns, comp,
                               block_size=4)]
        for r in rs:
            await r.start()
        routers.extend(rs)
        return rs

    topics = {t.encode(): t for t in (kv_events_topic(ns, comp), load_topic(ns, comp),
                                      kv_sync_topic(ns, comp))}

    def at_broker(routers_n):
        """Whether the broker holds each router's KV and load subscriptions
        and each publisher's sync subscription, and nothing more of them."""
        held = {t: broker._xpub._all.get(p, 0) for p, t in topics.items()}
        return held == {kv_events_topic(ns, comp): routers_n, load_topic(ns, comp): routers_n,
                        kv_sync_topic(ns, comp): 2}

    async def subscribed(routers_n):
        """Every subscription at the broker, and every publishing plane
        holding them: what a plane publishes now reaches its subscribers."""
        await until(lambda: at_broker(routers_n), f"{routers_n} routers' subscriptions")
        for plane in planes:
            await publisher_holds_subscriptions(plane, broker.address)

    def caught_up(rs):
        """Whether each router applied the last event of each publisher."""
        want = {(1, 0): jpub._event_id, (2, 0): tpub._event_id}
        return all(r.indexer._last_event_id.get(w) == n for r in rs for w, n in want.items())

    try:
        rs = await start_routers()
        await subscribed(2)
        # JAX's worker takes the prompts sharing PREFIX, the port's the rest
        await _traffic(jeng, JAX, "prefixes")
        for p in (PROMPTS[3], PROMPTS[3][:9] + PREFIX):
            await _one(teng, TORCH, p)
        await _settle(teng)
        for lp in loads:
            await lp.publish_once()
        await until(lambda: caught_up(rs), "the routers applying every event", timeout=10)
        port_router, jax_router = rs
        assert _held(port_router, (1, 0)) == {h for h, _ in jeng.pool.committed_view()}
        assert _held(port_router, (2, 0)) == {h for h, _ in teng.pool.committed_view()}
        assert _held(port_router, (1, 0)) and _held(port_router, (2, 0))
        for _ in range(100):  # the load reports reach both schedulers
            if all(len(r.scheduler.load_view()) == 2 for r in rs):
                break
            await asyncio.sleep(0.01)
        assert port_router.scheduler.load_view() == jax_router.scheduler.load_view()
        queries = PROMPTS + [PROMPTS[3][:9] + PREFIX + [5, 6, 7, 8], PREFIX, [1, 2, 3, 4, 5]]
        answers = [[r.find_best_match(q, [(1, 0), (2, 0)]) for q in queries] for r in rs]
        assert answers[0] == answers[1]
        assert answers[0][0] == ((1, 0), len(PROMPTS[0]) // 4)  # JAX's worker holds it
        assert answers[0][4] == ((2, 0), 21 // 4)  # the port's worker holds it
        for q in queries:
            hashes = compute_block_hashes(q, 4)
            a, b = (r.indexer.find_matches(hashes) for r in rs)
            assert (a.scores, a.matched_blocks) == (b.scores, b.matched_blocks)

        # restarted routers rebuild the same indexes from the snapshots
        for r in rs:
            await r.stop()
        routers.clear()
        await until(lambda: at_broker(0), "the stopped routers' subscriptions leaving the broker")
        rs2 = await start_routers()
        await subscribed(2)
        # The port's router catches up by itself: from its start-up request,
        # or, where that request's answer left a worker before the
        # subscription reached it, from the load reports the workers send
        # each interval.
        for lp in loads:
            await lp.publish_once()
        await until(lambda: caught_up(rs2[:1]), "the restarted port router applying the snapshots",
                    timeout=10)
        # JAX's router asks for the snapshots as it subscribes, without
        # waiting for the subscription (dynamo_tpu/router/router.py), and
        # never again: the test asks once more for it.
        rs2[1]._sync_requested.clear()
        await rs2[1]._request_sync(None)
        await until(lambda: caught_up(rs2), "the restarted JAX router applying the snapshots",
                    timeout=10)
        assert _held(rs2[0], (1, 0)) == _held(port_router, (1, 0))
        assert _held(rs2[0], (2, 0)) == _held(port_router, (2, 0))
        for q in queries:
            hashes = compute_block_hashes(q, 4)
            a, b = (r.indexer.find_matches(hashes) for r in rs2)
            c = port_router.indexer.find_matches(hashes)
            assert (a.scores, a.matched_blocks) == (b.scores, b.matched_blocks) == (
                c.scores, c.matched_blocks)
    finally:
        for r in routers:
            await r.stop()
        for pub in (jpub, tpub):
            await pub.close()
        for engine in (jeng, teng):
            await engine.stop()
        for plane in planes:
            await plane.close()
        await broker.close()


async def test_subscription_ready_says_when_the_subscribe_was_sent():
    """KvRouter.start() waits for its KV subscription's ``ready`` before it
    asks for snapshots: set at once on the memory plane, after the
    SUBSCRIBE on the ZMQ plane, and when a pump that cannot reach its
    broker ends (so a waiter does not hang)."""
    from dynamo_tpu_torch.runtime.events import MemoryEventPlane

    mem = MemoryEventPlane().subscribe("t")
    assert mem.ready.is_set()
    broker = tzmq.EventBroker()
    broker.start()
    plane = tzmq.ZmqEventPlane(broker.address)
    try:
        sub = plane.subscribe("ns.comp.kv_events")
        assert not sub.ready.is_set()
        await asyncio.wait_for(sub.ready.wait(), 5)
        await until_delivered(plane, "ns.comp.kv_events", [sub])  # it reached the publisher
        await plane.publish("ns.comp.kv_events", {"n": 1})
        assert await get(sub, 5) == ("ns.comp.kv_events", {"n": 1})
    finally:
        await plane.close()
        await broker.close()
    gone = tzmq.ZmqEventPlane(broker.address)  # the broker is closed: nothing listens
    try:
        dead = gone.subscribe("t")
        await asyncio.wait_for(dead.ready.wait(), 5)
    finally:
        await gone.close()
