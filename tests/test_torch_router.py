"""The port's KV router (dynamo_tpu_torch/router/) — its copies of
tests/test_router.py's and tests/test_router_approx.py's tests, with
``TorchEngine(device="cpu", cuda_graphs=False)`` on the tiny preset where
those use the mock engine (not ported yet) — and side-by-side runs against
the JAX package's router on the same inputs:

  - randomized stored / removed / cleared / snapshot event sequences (stale
    and out-of-order event ids among them) into both ``KvIndexer``s, whose
    ``find_matches``, gap verdicts and counts must agree after each step;
  - both ``KvScheduler``s with one seed, the same loads and requests,
    making the same choices (temperature 0 pruned and full scan, and
    temperature > 0), with equal decision records and load views;
  - both ``ApproxKvIndexer``s on one clock;
  - ``RouterEvent`` and ``LoadSnapshot`` dicts and the topics;
  - the KV-reuse sketch, the lifecycle ring and the trace context the
    router feeds, against JAX's.
"""

import asyncio
import random

import numpy as np
import pytest

from dynamo_tpu.router import approx as japprox
from dynamo_tpu.router import indexer as jindexer
from dynamo_tpu.router import protocols as jprotocols
from dynamo_tpu.router import scheduler as jscheduler
from dynamo_tpu.runtime import kv_reuse_observe as jkv_reuse
from dynamo_tpu.runtime import lifecycle as jlifecycle
from dynamo_tpu.tokens import radix as jradix
from dynamo_tpu.utils import tracing as jtracing
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models.config import tiny_config
from dynamo_tpu_torch.router import (
    KvEventPublisher,
    KvIndexer,
    KvRouter,
    KvRouterConfig,
    KvScheduler,
    LoadPublisher,
    LoadSnapshot,
    RouterEvent,
)
from dynamo_tpu_torch.router import approx as tapprox
from dynamo_tpu_torch.router import indexer as tindexer
from dynamo_tpu_torch.router import protocols as tprotocols
from dynamo_tpu_torch.router import scheduler as tscheduler
from dynamo_tpu_torch.router.approx import (
    ApproxKvIndexer,
    PruneConfig,
    PruneManager,
)
from dynamo_tpu_torch.runtime import kv_reuse_observe as tkv_reuse
from dynamo_tpu_torch.runtime import lifecycle as tlifecycle
from dynamo_tpu_torch.runtime.component import RouterMode
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import collect
from dynamo_tpu_torch.tokens import radix as tradix
from dynamo_tpu_torch.tokens.blocks import compute_block_hashes
from dynamo_tpu_torch.utils import tracing as ttracing

def ev(worker, kind, hashes, parent=None, eid=0):
    return RouterEvent(
        worker_id=worker, kind=kind, block_hashes=hashes, parent_hash=parent,
        event_id=eid,
    )


class TestIndexer:
    def test_store_and_match(self):
        idx = KvIndexer(block_size=4)
        tokens = list(range(16))
        hashes = compute_block_hashes(tokens, 4)
        idx.apply(ev(1, "stored", hashes))
        idx.apply(ev(2, "stored", hashes[:2]))
        scores = idx.find_matches(hashes)
        assert scores.scores[(1, 0)] == 4
        assert scores.scores[(2, 0)] == 2

    def test_removed_and_cleared(self):
        idx = KvIndexer(block_size=4)
        hashes = compute_block_hashes(list(range(16)), 4)
        idx.apply(ev(1, "stored", hashes))
        idx.apply(ev(1, "removed", hashes[2:]))
        assert idx.find_matches(hashes).scores[(1, 0)] == 2
        idx.apply(ev(1, "cleared", []))
        assert not idx.find_matches(hashes).scores

    def test_remove_worker(self):
        idx = KvIndexer(block_size=4)
        hashes = compute_block_hashes(list(range(16)), 4)
        idx.apply(ev(1, "stored", hashes))
        idx.remove_worker((1, 0))
        assert not idx.find_matches(hashes).scores


class TestScheduler:
    def test_prefers_overlap(self):
        sched = KvScheduler(KvRouterConfig(), seed=0)
        from dynamo_tpu_torch.tokens.radix import OverlapScores

        overlaps = OverlapScores(scores={(1, 0): 8, (2, 0): 0})
        w = sched.select_worker(10, overlaps, [(1, 0), (2, 0)])
        assert w == (1, 0)

    def test_prefers_idle_on_tie(self):
        sched = KvScheduler(KvRouterConfig(), seed=0)
        from dynamo_tpu_torch.tokens.radix import OverlapScores

        sched.update_load(LoadSnapshot(worker_id=1, active_blocks=100, total_blocks=200))
        sched.update_load(LoadSnapshot(worker_id=2, active_blocks=2, total_blocks=200))
        w = sched.select_worker(10, OverlapScores(), [(1, 0), (2, 0)])
        assert w == (2, 0)

    def test_busy_worker_skipped(self):
        sched = KvScheduler(KvRouterConfig(busy_kv_usage=0.9), seed=0)
        from dynamo_tpu_torch.tokens.radix import OverlapScores

        # Worker 1 has full overlap but is nearly out of KV.
        sched.update_load(LoadSnapshot(worker_id=1, active_blocks=195, total_blocks=200))
        sched.update_load(LoadSnapshot(worker_id=2, active_blocks=10, total_blocks=200))
        overlaps = OverlapScores(scores={(1, 0): 10})
        w = sched.select_worker(10, overlaps, [(1, 0), (2, 0)])
        assert w == (2, 0)

    def test_inflight_prediction_spreads_load(self):
        """Routing N identical no-overlap requests back-to-back (no load
        reports in between) must not dogpile one worker."""
        sched = KvScheduler(KvRouterConfig(), seed=0)
        from dynamo_tpu_torch.tokens.radix import OverlapScores

        picks = [
            sched.select_worker(10, OverlapScores(), [(1, 0), (2, 0)])
            for _ in range(4)
        ]
        assert set(picks) == {(1, 0), (2, 0)}

    def test_temperature_sampling_varies(self):
        sched = KvScheduler(KvRouterConfig(router_temperature=50.0), seed=42)
        from dynamo_tpu_torch.tokens.radix import OverlapScores

        picks = set()
        for _ in range(50):
            w = sched.select_worker(4, OverlapScores(scores={(1, 0): 2}), [(1, 0), (2, 0)])
            picks.add(w)
            # reset prediction so sampling stays near-uniform
            for s in sched._workers.values():
                s.inflight_blocks = 0
        assert picks == {(1, 0), (2, 0)}


class TestLinkCost:
    """Link-cost-aware decode placement (disagg): the (src → dst) wire is
    part of the cost model, so prefix overlap can't win blindly."""

    BLOCK_BYTES = 1 << 20  # 1 MiB of KV per block on the wire

    def _sched(self):
        from dynamo_tpu_torch.router import TransferContext  # noqa: F401

        return KvScheduler(KvRouterConfig(), seed=0)

    def test_link_cost_flips_decode_placement(self):
        """Worker 1 has 10/12 blocks of overlap but sits behind a measured
        1 MB/s link from the prefill source; worker 2 has NO overlap on a
        1 GB/s link. Without the link term worker 1 wins; with it, pulling
        2 MiB at 1 MB/s (~2 s) costs more block-equivalents than worker
        2's 12-block re-pull at 1 GB/s — the decision flips."""
        from dynamo_tpu_torch.router import TransferContext
        from dynamo_tpu_torch.tokens.radix import OverlapScores

        overlaps = OverlapScores(scores={(1, 0): 10})
        transfer = TransferContext(src=7, bytes_per_block=self.BLOCK_BYTES)

        sched = self._sched()
        sched.link_costs.set_bandwidth(7, (1, 0), 1e6)   # slow link
        sched.link_costs.set_bandwidth(7, (2, 0), 1e9)   # fast link

        # Control: same state, no transfer context → overlap wins.
        assert (
            sched.select_worker(12, overlaps, [(1, 0), (2, 0)]) == (1, 0)
        )
        sched2 = self._sched()
        sched2.link_costs.set_bandwidth(7, (1, 0), 1e6)
        sched2.link_costs.set_bandwidth(7, (2, 0), 1e9)
        w = sched2.select_worker(
            12, overlaps, [(1, 0), (2, 0)], transfer=transfer
        )
        assert w == (2, 0), w

    def test_pull_from_source_itself_is_free(self):
        """A candidate that IS the prefill source pays no wire cost even
        over an otherwise-slow recorded pair."""
        from dynamo_tpu_torch.router import TransferContext
        from dynamo_tpu_torch.tokens.radix import OverlapScores

        sched = self._sched()
        sched.link_costs.set_bandwidth(1, (2, 0), 1e5)  # terrible link
        w = sched.select_worker(
            8, OverlapScores(), [(1, 0), (2, 0)],
            transfer=TransferContext(src=1, bytes_per_block=self.BLOCK_BYTES),
        )
        assert w == (1, 0)

    def test_unmeasured_pair_quotes_seed_default(self):
        """A never-measured pair must NOT be penalized into losing: the
        seed default is optimistic, so overlap still decides."""
        from dynamo_tpu_torch.router import TransferContext
        from dynamo_tpu_torch.tokens.radix import OverlapScores

        sched = self._sched()
        w = sched.select_worker(
            12, OverlapScores(scores={(1, 0): 10}), [(1, 0), (2, 0)],
            transfer=TransferContext(src=7, bytes_per_block=self.BLOCK_BYTES),
        )
        assert w == (1, 0)

    def test_load_reports_fold_bandwidth_ewma(self):
        """LoadSnapshot.link_bandwidth lands in the scheduler's link-cost
        model as an EWMA per (src, reporting worker), including stringified
        map keys from JSON planes."""
        sched = self._sched()
        sched.update_load(
            LoadSnapshot(
                worker_id=2, total_blocks=100,
                link_bandwidth={"7": 1e6},  # JSON-stringified src key
            )
        )
        assert sched.link_costs.bandwidth(7, (2, 0)) == pytest.approx(1e6)
        sched.update_load(
            LoadSnapshot(
                worker_id=2, total_blocks=100, link_bandwidth={7: 3e6}
            )
        )
        # EWMA, not replacement: 0.25·3e6 + 0.75·1e6
        assert sched.link_costs.bandwidth(7, (2, 0)) == pytest.approx(1.5e6)
        # unrelated pair still quotes the seed default
        assert sched.link_costs.bandwidth(7, (3, 0)) == pytest.approx(
            sched.config.default_link_bandwidth
        )

    def test_remove_worker_drops_link_pairs(self):
        sched = self._sched()
        sched.link_costs.set_bandwidth(7, (2, 0), 1e6)
        sched.link_costs.set_fault(7, (2, 0), True)
        sched.add_worker((2, 0))
        sched.remove_worker((2, 0))
        assert not sched.link_costs.pairs()
        assert not sched.link_costs.faulted(7, (2, 0))

    def test_open_breaker_prices_pair_out_of_placement(self):
        """A load report advertising an open pull breaker (link_faults)
        flips the placement decision away from the higher-overlap worker —
        a FAILING link is demoted harder than a slow one — and the next
        report without the advertisement restores it (the measured EWMA
        survives the fault window)."""
        from dynamo_tpu_torch.router import TransferContext
        from dynamo_tpu_torch.tokens.radix import OverlapScores

        overlaps = OverlapScores(scores={(1, 0): 10})
        transfer = TransferContext(src=7, bytes_per_block=self.BLOCK_BYTES)
        sched = self._sched()
        # Both links fast and measured: overlap decides.
        sched.update_load(LoadSnapshot(
            worker_id=1, total_blocks=100, link_bandwidth={7: 1e9},
        ))
        sched.update_load(LoadSnapshot(
            worker_id=2, total_blocks=100, link_bandwidth={7: 1e9},
        ))
        assert sched.select_worker(
            12, overlaps, [(1, 0), (2, 0)], transfer=transfer
        ) == (1, 0)
        # Worker 1's breaker for src 7 opens: the pair quotes
        # FAULT_BANDWIDTH and the decision flips to the no-overlap worker.
        sched.update_load(LoadSnapshot(
            worker_id=1, total_blocks=100, link_bandwidth={7: 1e9},
            link_faults=[7],
        ))
        assert sched.link_costs.faulted(7, (1, 0))
        assert sched.select_worker(
            12, overlaps, [(1, 0), (2, 0)], transfer=transfer
        ) == (2, 0)
        # Breaker closes (report stops carrying the src): the pair
        # resumes at its surviving EWMA and overlap wins again.
        sched.update_load(LoadSnapshot(
            worker_id=1, total_blocks=100, link_bandwidth={7: 1e9},
        ))
        assert not sched.link_costs.faulted(7, (1, 0))
        assert sched.select_worker(
            12, overlaps, [(1, 0), (2, 0)], transfer=transfer
        ) == (1, 0)

    def test_stringified_link_faults_normalized(self):
        sched = self._sched()
        sched.update_load(LoadSnapshot.from_dict({
            "worker_id": 2, "total_blocks": 100, "link_faults": ["7"],
        }))
        assert sched.link_costs.faulted(7, (2, 0))

    def test_transfer_context_extracted_from_request(self):
        """The picker derives (src, block_bytes) from the disagg bootstrap
        metadata in both dict- and dataclass-shaped requests; requests
        without it route with no link term."""
        from dynamo_tpu_torch.llm.protocols.common import DisaggregatedParams
        from dynamo_tpu_torch.router.router import _transfer_context_of

        dp = DisaggregatedParams(
            worker_id=5, prefilled_tokens=16,
            kv_transfer={"block_hashes": [1], "block_bytes": 4096,
                         "wire_dtype": "int8"},
        )
        req_obj = PreprocessedRequest(
            token_ids=[1, 2], sampling=SamplingOptions(),
            stop=StopConditions(), disaggregated_params=dp,
        )
        ctx = _transfer_context_of(req_obj)
        assert ctx is not None and ctx.src == 5 and ctx.bytes_per_block == 4096
        ctx = _transfer_context_of(req_obj.to_dict())
        assert ctx is not None and ctx.src == 5 and ctx.bytes_per_block == 4096
        req_obj.disaggregated_params = None
        assert _transfer_context_of(req_obj) is None
        # v1 prefill worker: bootstrap without block_bytes → no link term
        dp.kv_transfer = {"block_hashes": [1]}
        req_obj.disaggregated_params = dp
        assert _transfer_context_of(req_obj) is None


def _req(tokens, max_tokens=4):
    return PreprocessedRequest(
        token_ids=list(tokens),
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=max_tokens),
    ).to_dict()


def _engine(block, on_kv_event=None):
    """The tiny preset on the CPU, where tests/test_router.py takes the mock
    engine."""
    args = TorchEngineArgs(config=tiny_config(), device="cpu", cuda_graphs=False,
                           block_size=block, num_kv_blocks=64, max_num_seqs=4,
                           max_model_len=128, prefill_chunk=32, decode_steps=4)
    return TorchEngine(args, on_kv_event=on_kv_event)


async def test_kv_router_e2e_with_torch_workers():
    """Two TorchEngine workers; requests sharing a prefix should follow the
    cache."""
    rt = DistributedRuntime.detached()
    ns, comp = "test", "backend"
    block = 4

    engines = {}
    served = []
    pubs = []
    for wid in (1, 2):
        pub = KvEventPublisher(rt.event_plane, ns, comp, wid)
        eng = _engine(block, pub.on_kv_event)
        engines[wid] = eng
        lp = LoadPublisher(rt.event_plane, ns, comp, wid, eng.stats, total_blocks=64)
        pubs.append((pub, lp))
        ep = rt.namespace(ns).component(comp).endpoint("generate")
        served.append(
            await ep.serve_endpoint(eng.generate, instance_id=wid)
        )

    router = KvRouter(rt, ns, comp, block_size=block)
    await router.start()
    client = await rt.namespace(ns).component(comp).endpoint("generate").client(
        RouterMode.KV
    )
    router.attach(client)
    await client.wait_for_instances()

    try:
        prefix = list(range(100, 116))  # 4 full blocks
        out1 = await collect(client.generate(_req(prefix + [1, 2, 3])))
        assert any(getattr(o, "token_ids", None) for o in out1)
        await router.wait_for_events(1)  # deterministic: no sleep races

        # A second request with the same prefix must go to the same worker.
        hashes = compute_block_hashes(prefix, block)
        scores = router.indexer.find_matches(hashes)
        assert scores.scores
        cached_worker = max(scores.scores, key=lambda w: scores.scores[w])
        picked, overlap = router.find_best_match(
            prefix + [7, 8, 9], [(1, 0), (2, 0)]
        )
        assert picked == cached_worker
        assert overlap >= 3
        # and through the client: the engine there matches the prefix
        before = engines[cached_worker[0]].prefill_tokens
        await collect(client.generate(_req(prefix + [7, 8, 9])))
        assert engines[cached_worker[0]].prefill_tokens - before == 19 - 4 * overlap
    finally:
        await router.stop()
        for s in served:
            await s.shutdown(grace_period=1)
        for pub, lp in pubs:
            await pub.close()
            await lp.close()
        for eng in engines.values():
            await eng.stop()
        await rt.shutdown(grace_period=1)


async def test_load_publisher_snapshot():
    rt = DistributedRuntime.detached()
    stats = {"active_seqs": 3, "free_blocks": 10, "total_blocks": 64,
             "waiting": 1, "generated_tokens": 42}
    lp = LoadPublisher(rt.event_plane, "n", "c", 7, lambda: stats, total_blocks=64)
    snap = lp.snapshot()
    assert snap.active_blocks == 54
    assert snap.kv_usage == 54 / 64
    sub = rt.event_plane.subscribe("n.c.load")
    await lp.publish_once()
    _topic, payload = await asyncio.wait_for(sub.get(), timeout=2)
    assert LoadSnapshot.from_dict(payload).worker_id == 7
    await sub.aclose()
    await rt.shutdown(grace_period=1)


class TestResync:
    """KV-event re-sync (the JetStream replay role): snapshot events rebuild
    a restarted router's index; event-id gaps trigger snapshot requests."""

    def test_indexer_snapshot_replaces_state(self):
        idx = KvIndexer(block_size=4)
        idx.apply(ev(1, "stored", [10, 11], eid=1))
        idx.apply(ev(1, "stored", [99], parent=11, eid=2))
        snap = RouterEvent(
            worker_id=1, kind="snapshot", block_hashes=[10, 11, 12],
            parent_hashes=[None, 10, 11], event_id=7,
        )
        idx.apply(snap)
        scores = idx.find_matches([10, 11, 12])
        assert scores.scores.get((1, 0)) == 3
        # the pre-snapshot block 99 is gone
        assert idx.find_matches([99]).scores == {}

    def test_indexer_drops_stale_after_snapshot(self):
        idx = KvIndexer(block_size=4)
        snap = RouterEvent(
            worker_id=1, kind="snapshot", block_hashes=[10],
            parent_hashes=[None], event_id=5,
        )
        idx.apply(snap)
        # An in-flight pre-snapshot event arrives late: must not re-apply.
        idx.apply(ev(1, "removed", [10], eid=3))
        assert idx.find_matches([10]).scores.get((1, 0)) == 1

    def test_gap_detection(self):
        idx = KvIndexer(block_size=4)
        idx.apply(ev(1, "stored", [10], eid=1))
        assert not idx.has_gap(ev(1, "stored", [11], eid=2))
        assert idx.has_gap(ev(1, "stored", [12], eid=4))  # missed eid 3
        # Unknown worker joining mid-stream counts as a gap too.
        assert idx.has_gap(ev(2, "stored", [20], eid=9))
        assert not idx.has_gap(ev(3, "stored", [30], eid=1))

    async def test_router_restart_resyncs_from_publisher(self):
        """Kill the router mid-traffic; a new router must recover the full
        index from publisher snapshots without replaying traffic."""
        rt = DistributedRuntime.detached()
        ns, comp = "sync", "backend"
        block = 4

        pub = KvEventPublisher(rt.event_plane, ns, comp, 1)
        eng = _engine(block, pub.on_kv_event)
        pub.set_snapshot_fn(eng.pool.committed_view)
        ep = rt.namespace(ns).component(comp).endpoint("generate")
        served = await ep.serve_endpoint(eng.generate, instance_id=1)

        router = KvRouter(rt, ns, comp, block_size=block)
        await router.start()
        try:
            prefix = list(range(200, 216))  # 4 full blocks
            out = await collect(eng.generate(_req(prefix), Context()))
            assert out
            await router.wait_for_events(1)
            hashes = compute_block_hashes(prefix, block)
            assert router.indexer.find_matches(hashes).scores

            # Router dies; a fresh one starts with an empty index.
            await router.stop()
            router2 = KvRouter(rt, ns, comp, block_size=block)
            await router2.start()  # start() broadcasts a sync request
            try:
                await router2.wait_for_events(1, timeout=5)
                scores = router2.indexer.find_matches(hashes)
                assert scores.scores.get((1, 0), 0) >= 4, (
                    "restarted router did not recover the index via snapshot"
                )
            finally:
                await router2.stop()
        finally:
            await served.shutdown(grace_period=1)
            await pub.close()
            await eng.stop()
            await rt.shutdown(grace_period=1)


class TestCandidatePruning:
    """Fleet-scale select_worker: above prune_threshold the
    scheduler scores a pruned candidate set (specials + a bounded
    branch-and-bound walk over the static rank) instead of every worker.
    Under sparse in-flight charges the choice is EXACTLY the full scan's;
    the per-request scored-candidate count must not grow with the fleet."""

    def _mk(self, n_workers, *, prune=True, seed=3):
        cfg = KvRouterConfig() if prune else KvRouterConfig(prune_threshold=0)
        sched = KvScheduler(cfg, seed=seed)
        return sched

    def _feed(self, sched, rng, n_workers):
        """Randomized fleet state: loads, queue depths, some draining /
        busy / saturated workers, a couple of measured links."""
        for wid in range(1, n_workers + 1):
            roll = rng.random()
            sched.update_load(LoadSnapshot(
                worker_id=wid,
                active_blocks=rng.randrange(0, 180),
                total_blocks=200,
                queue_depth=rng.randrange(0, 4),
                draining=roll < 0.05,
                kv_high_watermark=0.9 if roll > 0.93 else 1.0,
            ))
        # A measured (slow) link + an open breaker on two random dsts.
        sched.link_costs.observe(7, (rng.randrange(1, n_workers + 1), 0), 5e5)
        sched.link_costs.set_fault(7, (rng.randrange(1, n_workers + 1), 0), True)

    def test_pruned_matches_full_scan_randomized(self):
        import random as _random

        from dynamo_tpu_torch.router.scheduler import TransferContext
        from dynamo_tpu_torch.tokens.radix import OverlapScores

        for trial in range(30):
            rng_a = _random.Random(1000 + trial)
            rng_b = _random.Random(1000 + trial)
            n = 80
            pruned = self._mk(n)
            full = self._mk(n, prune=False)
            self._feed(pruned, rng_a, n)
            self._feed(full, rng_b, n)
            candidates = [(wid, 0) for wid in range(1, n + 1)]
            rng = _random.Random(2000 + trial)
            for step in range(12):
                overlaps = OverlapScores(scores={
                    (rng.randrange(1, n + 1), 0): rng.randrange(1, 12)
                    for _ in range(rng.randrange(0, 5))
                })
                transfer = (
                    TransferContext(src=7, bytes_per_block=65536)
                    if rng.random() < 0.5 else None
                )
                blocks = rng.randrange(1, 24)
                a = pruned.select_worker(
                    blocks, overlaps, candidates, transfer=transfer
                )
                b = full.select_worker(
                    blocks, overlaps, candidates, transfer=transfer
                )
                assert a == b, (trial, step, a, b)
                # Keep charges SPARSE (the exactness regime): release
                # most charges right away, as completed streams would.
                if rng.random() < 0.8 and a is not None:
                    pruned.complete_request(a, blocks)
                    full.complete_request(b, blocks)
            assert pruned.logit_evals < full.logit_evals

    def test_pruned_cost_is_constant_in_fleet_size(self):
        from dynamo_tpu_torch.tokens.radix import OverlapScores

        import random as _random

        counts = {}
        for n in (50, 200):
            sched = self._mk(n)
            rng = _random.Random(9)
            self._feed(sched, rng, n)
            candidates = [(wid, 0) for wid in range(1, n + 1)]
            for _ in range(100):
                sched.select_worker(10, OverlapScores(), candidates)
            counts[n] = sched.logit_evals / sched.selections
        # 4x the fleet, same per-request scoring work (walk cap + specials).
        assert counts[200] <= counts[50] + 1, counts

    def test_pruned_falls_back_when_no_eligible_candidate(self):
        """All-draining fleet: the pruned path defers to the full scan's
        fallback tiers (least-loaded draining worker still chosen)."""
        from dynamo_tpu_torch.tokens.radix import OverlapScores

        n = 40
        sched = self._mk(n)
        for wid in range(1, n + 1):
            sched.update_load(LoadSnapshot(
                worker_id=wid, active_blocks=wid, total_blocks=200,
                draining=True,
            ))
        w = sched.select_worker(
            10, OverlapScores(), [(wid, 0) for wid in range(1, n + 1)]
        )
        assert w == (1, 0)  # least loaded despite everyone draining

    def test_rank_tracks_reports_and_drops(self):
        from dynamo_tpu_torch.tokens.radix import OverlapScores

        n = 40
        sched = self._mk(n)
        for wid in range(1, n + 1):
            sched.update_load(LoadSnapshot(
                worker_id=wid, active_blocks=wid * 2, total_blocks=400,
            ))
        candidates = [(wid, 0) for wid in range(1, n + 1)]
        assert sched.select_worker(10, OverlapScores(), candidates) == (1, 0)
        # Worker 1 reports heavy + worker 2 crashes (dropped AND evicted
        # from the candidate list, as the liveness fan-out does): the
        # rank cache must follow both.
        sched.update_load(LoadSnapshot(
            worker_id=1, active_blocks=399, total_blocks=400,
        ))
        sched.drop_worker((2, 0))
        candidates = [c for c in candidates if c != (2, 0)]
        w = sched.select_worker(10, OverlapScores(), candidates)
        assert w == (3, 0)


class FakeClock:
    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


class TestPruneManager:
    def test_ttl_expiry(self):
        clock = FakeClock()
        pm = PruneManager(PruneConfig(ttl=10.0), clock=clock)
        pm.insert(["a", "b"], [0, 1])
        assert pm.pop_expired() == []
        clock.now += 11
        assert sorted(pm.pop_expired()) == ["a", "b"]
        assert len(pm) == 0

    def test_refresh_extends_ttl(self):
        clock = FakeClock()
        pm = PruneManager(PruneConfig(ttl=10.0), clock=clock)
        pm.insert(["a"], [0])
        clock.now += 8
        pm.insert(["a"], [0])  # refresh
        clock.now += 5  # 13s after first insert, 5s after refresh
        assert pm.pop_expired() == []  # stale heap entry skipped
        clock.now += 6
        assert pm.pop_expired() == ["a"]

    def test_prune_evicts_soonest_expiring_deepest_first(self):
        clock = FakeClock()
        pm = PruneManager(
            PruneConfig(ttl=100.0, max_tree_size=4, prune_target_ratio=0.5),
            clock=clock,
        )
        # Same expiry — depth breaks the tie, deepest evicted first.
        pm.insert(["d0", "d1", "d2", "d3"], [0, 1, 2, 3])
        evicted = pm.prune(current_size=5)
        assert len(pm) == 2
        assert evicted == ["d0", "d1"]  # heap pops smallest (expiry, depth)
        # Reference semantics: evicts by earliest expiry; within one insert
        # batch every key shares an expiry so lowest depth pops first —
        # but across batches the OLDER batch always goes first:
        pm2 = PruneManager(
            PruneConfig(ttl=100.0, max_tree_size=2, prune_target_ratio=0.5),
            clock=clock,
        )
        pm2.insert(["old"], [5])
        clock.now += 1
        pm2.insert(["new"], [0])
        assert pm2.prune(current_size=3) == ["old"]

    def test_under_limit_no_prune(self):
        pm = PruneManager(PruneConfig(max_tree_size=10))
        pm.insert(["a"], [0])
        assert pm.prune(current_size=5) == []


class TestApproxIndexer:
    def test_decision_creates_matches(self):
        idx = ApproxKvIndexer(block_size=4)
        hashes = compute_block_hashes(list(range(16)), 4)
        idx.process_routing_decision(hashes, (1, 0))
        scores = idx.find_matches(hashes)
        assert scores.scores.get((1, 0)) == len(hashes)

    def test_ttl_ages_out_knowledge(self):
        clock = FakeClock()
        idx = ApproxKvIndexer(4, PruneConfig(ttl=30.0), clock=clock)
        hashes = compute_block_hashes(list(range(16)), 4)
        idx.process_routing_decision(hashes, (1, 0))
        clock.now += 31
        scores = idx.find_matches(hashes)
        assert scores.scores.get((1, 0), 0) == 0
        assert idx.stats.expired == len(hashes)

    def test_size_prune_bounds_tree(self):
        idx = ApproxKvIndexer(
            4, PruneConfig(ttl=1e9, max_tree_size=8, prune_target_ratio=0.5)
        )
        for i in range(6):
            hashes = compute_block_hashes(
                [100 * i + j for j in range(12)], 4
            )
            idx.process_routing_decision(hashes, (i, 0))
        assert idx.tree.num_blocks <= 8

    def test_remove_worker(self):
        idx = ApproxKvIndexer(4)
        hashes = compute_block_hashes(list(range(8)), 4)
        idx.process_routing_decision(hashes, (7, 0))
        idx.remove_worker((7, 0))
        assert idx.find_matches(hashes).scores.get((7, 0), 0) == 0


class _FakeRuntime:
    class _Plane:
        def subscribe(self, topic):
            raise AssertionError(f"approx mode must not subscribe to {topic}")

    event_plane = _Plane()


async def test_router_approx_mode_prefers_prior_worker():
    """Second identical request must route to the worker the first one
    chose — the decision record IS the index in approximate mode."""

    class _LoadOnlyPlane:
        def __init__(self):
            self.topics = []

        def subscribe(self, topic):
            self.topics.append(topic)

            class _Sub:
                async def aclose(self):
                    pass

                def __aiter__(self):
                    return self

                async def __anext__(self):
                    import asyncio

                    await asyncio.Event().wait()  # never yields

            return _Sub()

    class _RT:
        event_plane = _LoadOnlyPlane()

    router = KvRouter(_RT(), "ns", "backend", block_size=4, use_kv_events=False)
    await router.start()
    try:
        assert all("kv" not in t for t in _RT.event_plane.topics)
        tokens = list(range(32))
        w1, overlap1 = router.find_best_match(tokens, [(1, 0), (2, 0)])
        assert overlap1 == 0
        router.release(w1, 8)
        w2, overlap2 = router.find_best_match(tokens, [(1, 0), (2, 0)])
        assert w2 == w1
        assert overlap2 == len(compute_block_hashes(tokens, 4))
    finally:
        await router.stop()


# -- side by side with the JAX package's router ------------------------------


def _chains(rng, n_seqs=12, block=4):
    """Token sequences sharing prefixes (a tree of chains) and their block
    hashes."""
    seqs = []
    for _ in range(n_seqs):
        if seqs and rng.random() < 0.6:
            base = rng.choice(seqs)
            cut = rng.randrange(0, len(base) + 1)
            seq = base[:cut] + [rng.randrange(0, 500) for _ in range(rng.randrange(1, 20))]
        else:
            seq = [rng.randrange(0, 500) for _ in range(rng.randrange(4, 40))]
        seqs.append(seq)
    return [compute_block_hashes(s, block) for s in seqs]


def _random_events(rng, chains, n_events=120):
    """Events from three workers: stored runs of a chain after their parent,
    removed subsets, clears, snapshots of the worker's view, and now and
    then an event id that repeats, goes back or jumps (stale, late, gap)."""
    held = {w: {} for w in (1, 2, 3)}  # worker -> {hash: parent}
    eid = {w: 0 for w in held}
    out = []
    for _ in range(n_events):
        w = rng.choice(list(held))
        roll = rng.random()
        kind, kw = None, {}
        if roll < 0.55:
            chain = rng.choice([c for c in chains if c] or [[]])
            if not chain:
                continue
            a = rng.randrange(0, len(chain))
            b = rng.randrange(a + 1, len(chain) + 1)
            parent = chain[a - 1] if a else None
            kind, kw = "stored", dict(block_hashes=chain[a:b], parent_hash=parent)
            for i in range(a, b):
                held[w][chain[i]] = chain[i - 1] if i else None
        elif roll < 0.8 and held[w]:
            gone = rng.sample(sorted(held[w]), rng.randrange(1, len(held[w]) + 1))
            kind, kw = "removed", dict(block_hashes=gone)
            for h in gone:
                held[w].pop(h, None)
        elif roll < 0.88:
            kind = "cleared"
            held[w] = {}
        else:
            view = list(held[w].items())
            kind = "snapshot"
            kw = dict(block_hashes=[h for h, _ in view], parent_hashes=[p for _, p in view])
        r = rng.random()
        if r < 0.05:
            e = eid[w]  # a duplicate
        elif r < 0.08:
            e = max(eid[w] - 2, 0)  # late
        elif r < 0.12:
            e = eid[w] + 3  # a gap
        else:
            e = eid[w] + 1
        eid[w] = max(eid[w], e)
        out.append(dict(worker_id=w, kind=kind, event_id=e, **kw))
    return out


def _scores(o):
    return dict(o.scores), o.matched_blocks


@pytest.mark.parametrize("seed", range(6))
def test_indexers_agree_on_random_event_sequences(seed):
    rng = random.Random(seed)
    chains = _chains(rng)
    j, t = jindexer.KvIndexer(4), tindexer.KvIndexer(4)
    queries = chains + [c[: len(c) // 2] for c in chains] + [[1, 2, 3]]
    for d in _random_events(rng, chains):
        jev, tev = jprotocols.RouterEvent(**d), tprotocols.RouterEvent(**d)
        assert j.has_gap(jev) == t.has_gap(tev), d
        j.apply(jev)
        t.apply(tev)
        assert j.events_applied == t.events_applied
        for q in queries:
            assert _scores(j.find_matches(q)) == _scores(t.find_matches(q)), (d, q)
        for w in (1, 2, 3):
            assert j.worker_block_count((w, 0)) == t.worker_block_count((w, 0))
    for w in (1, 3):
        j.remove_worker((w, 0))
        t.remove_worker((w, 0))
        for q in queries:
            assert _scores(j.find_matches(q)) == _scores(t.find_matches(q))


def test_radix_trees_agree_with_jax_python_tree():
    rng = random.Random(7)
    chains = _chains(rng, n_seqs=20)
    j, t = jradix.RadixTree(), tradix.RadixTree()
    for d in _random_events(rng, chains, 200):
        w = (d["worker_id"], 0)
        for tree in (j, t):
            if d["kind"] == "stored":
                tree.store(w, d["block_hashes"], d["parent_hash"])
            elif d["kind"] == "removed":
                tree.remove(w, d["block_hashes"])
            elif d["kind"] == "cleared":
                tree.clear_worker(w)
        assert (j.num_blocks, j.workers) == (t.num_blocks, t.workers)
        for q in chains:
            assert _scores(j.find_matches(q)) == _scores(t.find_matches(q))
            assert j.find_matches(q).best() == t.find_matches(q).best()


def _feed_loads(sched, proto, rng, n):
    for wid in range(1, n + 1):
        roll = rng.random()
        sched.update_load(proto.LoadSnapshot(
            worker_id=wid, active_blocks=rng.randrange(0, 180), total_blocks=200,
            queue_depth=rng.randrange(0, 4), draining=roll < 0.05,
            kv_high_watermark=0.9 if roll > 0.93 else 1.0,
            budget_state=rng.choice((0, 0, 0, 2, 3)),
            link_bandwidth={7: rng.choice((5e5, 1e9))} if roll < 0.2 else None,
            link_faults=[7] if 0.2 <= roll < 0.25 else None,
            incarnation=1,
        ))


@pytest.mark.parametrize("temperature,n_workers,prune", [
    (0.0, 80, True),   # above prune_threshold: the pruned selection
    (0.0, 80, False),  # the full scan (prune_threshold 0)
    (0.0, 6, True),    # below the threshold
    (0.7, 12, True),   # softmax sampling from the shared seed
])
def test_schedulers_make_the_same_choices(temperature, n_workers, prune):
    pairs = []
    for mod, proto, radix in ((jscheduler, jprotocols, jradix),
                              (tscheduler, tprotocols, tradix)):
        cfg = mod.KvRouterConfig(router_temperature=temperature,
                                 prune_threshold=32 if prune else 0)
        sched = mod.KvScheduler(cfg, seed=11)
        _feed_loads(sched, proto, random.Random(5), n_workers)
        pairs.append((sched, mod, proto, radix))
    (js, *_), (ts, *_) = pairs
    rng = random.Random(99)
    cands = [(w, 0) for w in range(1, n_workers + 1)]
    for step in range(60):
        scores = {(rng.randrange(1, n_workers + 1), 0): rng.randrange(1, 12)
                  for _ in range(rng.randrange(0, 5))}
        src = rng.random() < 0.4
        blocks = rng.randrange(1, 24)
        picks = [sched.select_worker(
            blocks, radix.OverlapScores(scores=scores), cands,
            transfer=mod.TransferContext(src=7, bytes_per_block=65536) if src else None)
            for sched, mod, _, radix in pairs]
        assert picks[0] == picks[1], step
        assert js.last_decision == ts.last_decision
        if step % 3 == 0 and picks[0] is not None:
            js.complete_request(picks[0], blocks)
            ts.complete_request(picks[1], blocks)
        if step % 10 == 9:  # reports land, and a worker goes
            for sched, _, proto, _ in pairs:
                _feed_loads(sched, proto, random.Random(step), n_workers)
                sched.drop_worker((step, 0))
    assert (js.logit_evals, js.selections) == (ts.logit_evals, ts.selections)
    assert js.load_view() == ts.load_view()
    assert js.link_costs.pairs() == ts.link_costs.pairs()


def test_approx_indexers_agree():
    class Clock:
        now = 1000.0

        def __call__(self):
            return self.now

    clock = Clock()
    cfg = dict(ttl=30.0, max_tree_size=24, prune_target_ratio=0.5)
    j = japprox.ApproxKvIndexer(4, japprox.PruneConfig(**cfg), clock=clock)
    t = tapprox.ApproxKvIndexer(4, tapprox.PruneConfig(**cfg), clock=clock)
    rng = random.Random(3)
    chains = _chains(rng, n_seqs=16)
    for step in range(80):
        chain = rng.choice(chains)
        w = (rng.randrange(1, 4), 0)
        roll = rng.random()
        for idx in (j, t):
            if roll < 0.7:
                idx.process_routing_decision(chain, w)
            elif roll < 0.8:
                idx.remove_worker(w)
        clock.now += rng.choice((0.5, 2.0, 11.0))
        for q in chains:
            assert _scores(j.find_matches(q)) == _scores(t.find_matches(q)), step
        assert vars(j.stats) == vars(t.stats)
        assert j.tree.num_blocks == t.tree.num_blocks
        assert len(j.prune_manager) == len(t.prune_manager)


def test_router_protocols_equal_jax():
    for d in (
        dict(worker_id=3, kind="stored", block_hashes=[2**64 - 1, 5], parent_hash=9,
             dp_rank=1, event_id=4),
        dict(worker_id=3, kind="snapshot", block_hashes=[1, 2], parent_hashes=[None, 1],
             event_id=7),
        dict(worker_id=1, kind="cleared"),
    ):
        j, t = jprotocols.RouterEvent(**d), tprotocols.RouterEvent(**d)
        assert j.to_dict() == t.to_dict()
        assert tprotocols.RouterEvent.from_dict(j.to_dict()).to_dict() == t.to_dict()
        assert j.worker == t.worker
    snap = dict(worker_id=2, dp_rank=1, active_seqs=3, waiting=1, active_blocks=40,
                total_blocks=200, generated_tokens=99, queue_depth=2, kv_high_watermark=0.95,
                link_bandwidth={"7": 1e6}, link_faults=["7"], draining=True, incarnation=12,
                prefill_budget_tokens=64, budget_state=2, unknown_key=1)
    j = jprotocols.LoadSnapshot.from_dict(snap)
    t = tprotocols.LoadSnapshot.from_dict(snap)
    assert j.to_dict() == t.to_dict()
    assert (j.kv_usage, j.worker) == (t.kv_usage, t.worker)
    assert jprotocols.LoadSnapshot(worker_id=1).to_dict() == tprotocols.LoadSnapshot(
        worker_id=1).to_dict()
    for fn in ("kv_events_topic", "load_topic", "kv_sync_topic"):
        assert getattr(jprotocols, fn)("ns", "comp") == getattr(tprotocols, fn)("ns", "comp")
    assert (jprotocols.KV_EVENTS_TOPIC, jprotocols.LOAD_TOPIC, jprotocols.KV_SYNC_TOPIC) == (
        tprotocols.KV_EVENTS_TOPIC, tprotocols.LOAD_TOPIC, tprotocols.KV_SYNC_TOPIC)


def test_kv_reuse_sketches_agree(monkeypatch):
    import time

    now = [1.0e9]
    monkeypatch.setattr(time, "time", lambda: now[0])
    rng = random.Random(4)
    planes = [mod.KvReusePlane(capacity=8, half_life_s=30.0) for mod in (jkv_reuse, tkv_reuse)]
    for step in range(200):
        anchor, tokens = rng.randrange(0, 30), rng.randrange(16, 400)
        worker = (rng.randrange(1, 4), 0)
        for plane in planes:
            if step % 3:
                plane.note_router_match(anchor, tokens=tokens, worker=worker)
            else:
                plane.note_request(anchor=anchor, cached_tokens=tokens * (step % 2),
                                   recomputed_tokens=tokens, worker=worker)
            if step % 50 == 49:
                plane.drop_worker(worker)
            plane.note_prefill_cost(0.001 * (step % 7 + 1), 100)
        now[0] += rng.choice((0.1, 1.0, 7.0))
    assert planes[0].snapshot(top_k=8) == planes[1].snapshot(top_k=8)
    assert planes[0].sketch.top_scores(8) == planes[1].sketch.top_scores(8)


def test_lifecycle_and_trace_context_agree():
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    j, t = jtracing.parse_traceparent(tp), ttracing.parse_traceparent(tp)
    assert (j.trace_id, j.span_id, j.sampled) == (t.trace_id, t.span_id, t.sampled)
    assert j.to_traceparent() == t.to_traceparent() == tp
    for bad in ("", "00-" + "0" * 32 + "-" + "cd" * 8 + "-01", "zz"):
        assert jtracing.parse_traceparent(bad) is None and ttracing.parse_traceparent(bad) is None
    rings = []
    for mod in (jlifecycle, tlifecycle):
        ring = mod.RequestLifecycle(max_recent=4, max_slow=2, slow_threshold_s=0.0)
        for i in range(6):
            ring.record(f"r{i}", "received")
            ring.record(f"r{i}", "routed", worker=i % 2, overlap_blocks=i, reason=None)
            if i % 2:
                ring.record(f"r{i}", "done")
        rings.append(ring)

    def shape(ring):
        return [(tl.request_id, tl.done, [(e.name, e.attrs) for e in tl.events])
                for tl in ring.timelines()] + [tl.request_id for tl in ring.slow_timelines()]

    assert shape(rings[0]) == shape(rings[1])


def test_router_span_records_the_decision_as_jax():
    """The picker's span attributes (router.select_worker) are the
    scheduler's decision record, the same in both packages."""
    got = []
    from dynamo_tpu.runtime.context import Context as JContext

    for tracer_mod, sched_mod, radix, ctx in (
            (jtracing, jscheduler, jradix, JContext()),
            (ttracing, tscheduler, tradix, Context())):
        sched = sched_mod.KvScheduler(sched_mod.KvRouterConfig(), seed=0)
        sched.select_worker(10, radix.OverlapScores(scores={(2, 0): 4}), [(1, 0), (2, 0)])
        with tracer_mod.span("router.select_worker", ctx) as sp:
            sp.attributes.update({k: v for k, v in sched.last_decision.items()
                                  if v is not None})
        d = sp.to_dict()
        got.append((d["name"], d["attributes"], len(d["trace_id"]), len(d["span_id"])))
    assert got[0] == got[1]
