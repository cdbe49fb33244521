"""KvScheduler: the worker-selection cost model — the port's copy of
dynamo_tpu/router/scheduler.py.

Reference parity: lib/llm/src/kv_router/scheduler.rs — the engine-agnostic
algorithm (scheduler.rs:497–566): for each candidate worker

    potential_prefill_blocks = request_blocks − overlap_blocks(worker)
    potential_decode_blocks  = current active blocks (reported + in-flight)
    logit = overlap_weight × potential_prefill_blocks + potential_decode_blocks

then pick the minimum, or softmax-sample over −logit/temperature when
``router_temperature > 0`` (scheduler.rs softmax_sample :426). In-flight
requests routed between load reports are tracked locally (sequence.rs's
active-sequence prediction, simplified to block deltas with TTL decay).

Link-cost extension (the NetKV/FlowKV decode-placement insight, PAPERS.md):
when a request carries KV that must be PULLED from a source worker (disagg
decode placement), prefix overlap is not free compute avoided — every
overlap-miss block also rides the (src → candidate) link. The logit gains
an estimated transfer cost in block-equivalents:

    logit += link_cost_weight × prefill_blocks_per_s
             × (miss_blocks × bytes_per_block) / bandwidth(src, candidate)

so a high-overlap candidate behind a slow link LOSES to a low-overlap
candidate on a fast one whenever re-prefilling is cheaper than the wire.
Per-pair bandwidth is an EWMA seeded from the decode workers' own measured
pull rates (disagg/handlers.py), shipped router-ward in load reports.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from dynamo_tpu_torch.router.protocols import LoadSnapshot, WorkerKey
from dynamo_tpu_torch.runtime.liveness import IncarnationFence
from dynamo_tpu_torch.tokens.radix import OverlapScores
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class KvRouterConfig:
    """(ref: scheduler.rs:137 KvRouterConfig)"""

    overlap_score_weight: float = 1.0
    router_temperature: float = 0.0
    # Forget in-flight load predictions after this long without a report.
    inflight_ttl_s: float = 30.0
    # Soft-skip workers above this KV usage unless all are (busy gating).
    busy_kv_usage: float = 0.95
    # Overload deflection: block-equivalents charged per request sitting
    # in a candidate's admission queue (LoadSnapshot.queue_depth). A
    # queued request is work the candidate has ACCEPTED but not started —
    # deeper queue, later start, regardless of current KV usage. 0
    # disables (pre-overload-plane behavior).
    queue_depth_weight: float = 4.0
    # Budget deflection (tick budgeter): extra weight on the prefill-
    # blocks term for workers whose budgeter advertises ITL pressure
    # (LoadSnapshot.budget_state ADAPTIVE/FLOOR) — their per-tick prefill
    # budget is squeezed, so new prefill queues behind the budget instead
    # of starting. The term is NON-NEGATIVE by construction (the pruned
    # path's static lower bound stays valid: actual logit ≥ bound). 0
    # disables (pre-budgeter behavior; unbudgeted workers report state 0
    # and are never charged).
    budget_pressure_weight: float = 2.0
    # -- link-cost term (disagg decode placement) --------------------------
    # Multiplier on the transfer-cost block-equivalents; 0 disables the
    # term entirely (pure overlap+load cost, the pre-link behavior).
    link_cost_weight: float = 1.0
    # Converts estimated transfer SECONDS into the logit's block units: how
    # many blocks a worker prefills per second. The default is deliberately
    # conservative (a modest chip at a 16-token block); the planner's
    # observed rates can overwrite it at runtime.
    prefill_blocks_per_s: float = 64.0
    # Seed bandwidth for never-measured (src, dst) pairs. Intra-cluster
    # DCN-class default; measured EWMAs replace it after the first pull.
    default_link_bandwidth: float = 1e9
    # EWMA weight for bandwidth observations folded in from load reports.
    link_ewma_alpha: float = 0.25
    # -- candidate pruning (fleet-scale selection) -------------------------
    # Above this many candidates (and at temperature 0) select_worker
    # prunes instead of scoring every worker: overlap-carrying and
    # link-differentiated candidates are always scored, then a
    # branch-and-bound walk over a (static_cost, worker) rank cache —
    # maintained on load reports — scores rank entries until the next
    # entry's static lower bound can no longer beat the best scored logit
    # (EXACT argmin, the common case) or ``prune_walk_limit`` entries
    # have been scored (bounded best-of-K among the statically
    # least-loaded, reached only when in-flight charges are dense across
    # the whole fleet; suboptimality is then bounded by one report
    # interval's worth of charges). Per-request cost: O(overlap + link +
    # walk) instead of O(workers). 0 disables pruning entirely.
    prune_threshold: int = 32
    prune_walk_limit: int = 8


class LinkCostModel:
    """Per-(src worker id, dst WorkerKey) transfer-bandwidth EWMA.

    Measured at the decode workers' pull paths (disagg/handlers.py), shipped
    here via LoadSnapshot.link_bandwidth, and read by select_worker to price
    a candidate's overlap-miss transfer. Unobserved pairs quote the seed
    default — optimistic, so the link term only demotes a candidate once a
    slow link has actually been SEEN (a never-used pair shouldn't lose to
    speculation)."""

    # Effective bandwidth quoted for a pair whose breaker is open: low
    # enough that any realistic transfer estimate dwarfs re-prefill cost
    # (pricing the pair out), finite so the logit math stays well-formed
    # and an all-faulted candidate set still produces a choice.
    FAULT_BANDWIDTH = 1e3

    def __init__(self, default_bandwidth: float = 1e9, alpha: float = 0.25) -> None:
        self.default_bandwidth = float(default_bandwidth)
        self.alpha = float(alpha)
        self._bw: Dict[Tuple[int, WorkerKey], float] = {}
        # (src, dst) pairs whose decode-side pull breaker is open — set
        # from LoadSnapshot.link_faults, cleared when a report stops
        # carrying the src (breaker closed or half-open window reached).
        self._faults: set = set()
        # src → dsts with a non-default quote (measured EWMA or fault):
        # the pruned selection path reads this per request, so it must be
        # a lookup, not a scan over every measured pair in the fleet.
        self._by_src: Dict[int, set] = {}

    def _index_add(self, src: int, dst: WorkerKey) -> None:
        self._by_src.setdefault(src, set()).add(dst)

    def _index_check(self, src: int, dst: WorkerKey) -> None:
        """Drop (src, dst) from the src index when NEITHER a measurement
        nor a fault keeps it special."""
        if (src, dst) in self._bw or (src, dst) in self._faults:
            return
        dsts = self._by_src.get(src)
        if dsts is not None:
            dsts.discard(dst)
            if not dsts:
                del self._by_src[src]

    def observe(self, src: int, dst: WorkerKey, bytes_per_s: float) -> None:
        if bytes_per_s <= 0:
            return
        key = (src, dst)
        prev = self._bw.get(key)
        self._bw[key] = (
            bytes_per_s if prev is None
            else self.alpha * bytes_per_s + (1 - self.alpha) * prev
        )
        self._index_add(src, dst)

    def set_bandwidth(self, src: int, dst: WorkerKey, bytes_per_s: float) -> None:
        """Pin a pair's bandwidth directly (operator override, tests)."""
        self._bw[(src, dst)] = float(bytes_per_s)
        self._index_add(src, dst)

    def bandwidth(self, src: int, dst: WorkerKey) -> float:
        if (src, dst) in self._faults:
            return self.FAULT_BANDWIDTH
        return self._bw.get((src, dst), self.default_bandwidth)

    def set_fault(self, src: int, dst: WorkerKey, faulted: bool) -> None:
        """Mark/clear a (src, dst) pair as breaker-open. A faulted pair
        quotes FAULT_BANDWIDTH regardless of its measured EWMA — the EWMA
        survives, so a healed pair resumes at its last honest estimate."""
        if faulted:
            self._faults.add((src, dst))
            self._index_add(src, dst)
        else:
            self._faults.discard((src, dst))
            self._index_check(src, dst)

    def sync_faults(self, dst: WorkerKey, srcs) -> None:
        """Replace dst's faulted-src set with what its load report carries
        (the report is authoritative for its own breakers)."""
        want = {int(s) for s in srcs}
        was = {(s, d) for (s, d) in self._faults if d == dst}
        self._faults = {
            (s, d) for (s, d) in self._faults if d != dst
        } | {(s, dst) for s in want}
        for s in want:
            self._index_add(s, dst)
        for s, d in was:
            if s not in want:
                self._index_check(s, d)

    def faulted(self, src: int, dst: WorkerKey) -> bool:
        return (src, dst) in self._faults

    def seconds(self, src: int, dst: WorkerKey, nbytes: int) -> float:
        """Estimated wire seconds to move ``nbytes`` src → dst. Pulling
        from yourself is free (the blocks are already resident)."""
        if nbytes <= 0 or dst[0] == src:
            return 0.0
        return nbytes / max(self.bandwidth(src, dst), 1e-9)

    def pairs(self) -> Dict[Tuple[int, WorkerKey], float]:
        """Measured pairs (for the router's per-pair gauges)."""
        return dict(self._bw)

    def special_dsts(self, src: int):
        """Destinations whose (src, dst) pair quotes something OTHER than
        the seed default (measured EWMA or an open breaker) — the only
        workers the link term can differentiate, hence the only ones the
        pruned candidate path must score individually. One dict lookup:
        per-request cost must not scan the fleet's full pair set."""
        return self._by_src.get(src, ())

    def drop_worker(self, worker: WorkerKey) -> None:
        self._bw = {
            k: v for k, v in self._bw.items()
            if k[1] != worker and k[0] != worker[0]
        }
        self._faults = {
            k for k in self._faults
            if k[1] != worker and k[0] != worker[0]
        }
        self._by_src.pop(worker[0], None)
        for src, dsts in list(self._by_src.items()):
            dsts.discard(worker)
            if not dsts:
                del self._by_src[src]


@dataclass
class TransferContext:
    """Disagg placement context for one selection: KV for every
    overlap-miss block must be pulled from ``src`` (the prefill worker that
    computed it), at ``bytes_per_block`` serialized wire bytes per block
    (pool-native: int8 payload + scales, or dense — the prefill worker
    advertises it in the bootstrap's kv_transfer metadata)."""

    src: int
    bytes_per_block: int


@dataclass
class WorkerState:
    snapshot: Optional[LoadSnapshot] = None
    # Blocks routed here since the last snapshot (prediction, decays).
    inflight_blocks: int = 0
    inflight_at: float = 0.0
    # Bumped on every load report; stale in-flight releases (charged before
    # the report that already absorbed them) are dropped by comparing this.
    report_gen: int = 0
    # Pruned-selection cache, refreshed per load report (update_load):
    # ``eligible`` = not draining, below busy gating, below the advertised
    # admission watermark — the workers the full scan's tier filters keep
    # whenever any such worker exists; ``static_cost`` = the report-only
    # part of the logit (active blocks + weighted queue depth), the total
    # logit for any zero-overlap uncharged candidate up to a shared
    # constant.
    eligible: bool = True
    static_cost: float = 0.0

    def decode_blocks(self, ttl: float) -> int:
        base = self.snapshot.active_blocks if self.snapshot else 0
        if self.inflight_blocks and time.monotonic() - self.inflight_at < ttl:
            base += self.inflight_blocks
        return base

    def kv_usage(self) -> float:
        return self.snapshot.kv_usage if self.snapshot else 0.0

    def queue_depth(self) -> int:
        return self.snapshot.queue_depth if self.snapshot else 0

    def draining(self) -> bool:
        """The worker advertised a live-handoff drain: it refuses every
        new admission with a typed migratable error, so placing work
        there just costs the stream a bounce."""
        return bool(self.snapshot is not None and self.snapshot.draining)

    def budget_pressure(self) -> float:
        """How hard the worker's tick budgeter is squeezing prefill:
        1.0 at the starvation floor (BUDGET_STATE_FLOOR=3), 0.5 while
        adapting (ADAPTIVE=2), 0 otherwise (off/throughput — literals
        mirror engines/tpu/tick_budget.py BUDGET_STATE_*; the router
        stays engine-import-free). Scales the prefill term: an ITL-
        constrained worker trickles prefill at its floor, so sending a
        big prefill there means queueing behind the budget."""
        if self.snapshot is None:
            return 0.0
        state = self.snapshot.budget_state
        if state == 3:
            return 1.0
        if state == 2:
            return 0.5
        return 0.0

    def saturated(self) -> bool:
        """At/above the worker's advertised admission high watermark:
        the engine will HOLD new admissions (backpressure) rather than
        preempt, so a request routed here queues behind the watermark
        instead of prefilling. Workers that never advertised a watermark
        (< 1.0) are never considered saturated."""
        if self.snapshot is None:
            return False
        wm = self.snapshot.kv_high_watermark
        return wm < 1.0 and self.snapshot.kv_usage >= wm


class KvScheduler:
    def __init__(self, config: Optional[KvRouterConfig] = None, *, seed: Optional[int] = None) -> None:
        self.config = config or KvRouterConfig()
        self._workers: Dict[WorkerKey, WorkerState] = {}
        self._rand = random.Random(seed)
        self.link_costs = LinkCostModel(
            self.config.default_link_bandwidth, self.config.link_ewma_alpha
        )
        # Incarnation fence over load reports: a zombie incarnation's late
        # publish is counted and dropped, a restarted worker's first fresh
        # report triggers drop_worker FIRST so old and new state are never
        # conflated (runtime/liveness.py). Distinct seam label from the
        # liveness tracker's "load_report": both consume the same topic
        # (separate subscriptions), so sharing a label would double-count
        # every zombie packet.
        self._fence = IncarnationFence("router_load")
        # Extra purges drop_worker fans out to (the router registers its
        # radix-indexer removal here, so scheduler.drop_worker stays THE
        # single reconciliation path for a vanished worker).
        self._on_drop: List = []
        # Pruned-selection cache: a (static_cost, worker) rank over
        # eligible workers, rebuilt lazily after load reports.
        self._rank: List[Tuple[float, WorkerKey]] = []
        self._rank_dirty = True
        # Instrumentation: workers actually SCORED (logit computed) across
        # all selections — the soak/bench read this to prove per-request
        # scheduling cost stays bounded as the fleet grows.
        self.logit_evals = 0
        self.selections = 0
        # Last select_worker decision (router span attributes): the picker
        # reads this right after the call on the same event loop.
        self.last_decision: Dict[str, object] = {}

    # -- state maintenance -------------------------------------------------

    def add_drop_callback(self, fn) -> None:
        """``fn(worker: WorkerKey)`` runs inside every drop_worker."""
        self._on_drop.append(fn)

    def update_load(self, snapshot: LoadSnapshot) -> bool:
        """Fold one load report into the cost model. Returns False when
        the report was FENCED (a stale incarnation's packet — counted,
        state untouched)."""
        verdict = self._fence.admit(snapshot.worker, snapshot.incarnation)
        if verdict == "stale":
            logger.warning(
                "dropping stale-incarnation load report from %s "
                "(incarnation %d < newest %d)", snapshot.worker,
                snapshot.incarnation, self._fence.newest(snapshot.worker),
            )
            return False
        if verdict == "rejoined":
            # The worker restarted: purge the previous incarnation's
            # charges/links/faults/radix before this report seeds the
            # fresh state (drop_worker also drops the fence entry, so
            # re-admit the new incarnation afterwards).
            self.drop_worker(snapshot.worker)
            self._fence.admit(snapshot.worker, snapshot.incarnation)
        state = self._workers.setdefault(snapshot.worker, WorkerState())
        state.snapshot = snapshot
        state.inflight_blocks = 0  # report supersedes the prediction
        state.report_gen += 1
        self._refresh_state(state)
        self._rank_dirty = True
        # Fold the worker's measured pull bandwidths (src → B/s, observed
        # at ITS end of each link) into the shared link-cost model.
        for src, bw in (snapshot.link_bandwidth or {}).items():
            self.link_costs.observe(int(src), snapshot.worker, float(bw))
        # Breaker advertisement: the report's link_faults is authoritative
        # for this worker's pairs — carried srcs are priced out, absent
        # srcs (breaker closed / probe window) are restored.
        self.link_costs.sync_faults(
            snapshot.worker, snapshot.link_faults or ()
        )
        return True

    def report_generation(self, worker: WorkerKey) -> int:
        state = self._workers.get(worker)
        return state.report_gen if state is not None else 0

    def _refresh_state(self, state: WorkerState) -> None:
        """Recompute the pruned-selection cache for one worker from its
        snapshot (runs once per load report, not per request)."""
        snap = state.snapshot
        if snap is None:
            # Never-reported worker (a fresh scale-up instance): eligible
            # at zero static cost — exactly how the full scan scores it.
            state.eligible = True
            state.static_cost = 0.0
            return
        usage = snap.kv_usage
        wm = snap.kv_high_watermark
        state.eligible = (
            not snap.draining
            and usage < self.config.busy_kv_usage
            and not (wm < 1.0 and usage >= wm)
        )
        qw = self.config.queue_depth_weight
        state.static_cost = snap.active_blocks + (
            qw * snap.queue_depth if qw > 0 else 0.0
        )

    def _rebuild_rank(self) -> None:
        self._rank = sorted(
            (state.static_cost, w)
            for w, state in self._workers.items()
            if state.eligible
        )
        self._rank_dirty = False

    def add_worker(self, worker: WorkerKey) -> None:
        if worker not in self._workers:
            self._workers[worker] = WorkerState()
            self._rank_dirty = True

    def drop_worker(self, worker: WorkerKey) -> None:
        """THE single reconciliation for a vanished worker (crash, lease
        expiry, rejoin under a new incarnation): atomically releases its
        in-flight charges (the WorkerState prediction), its link-cost
        pairs in BOTH directions, its breaker faults, its incarnation
        fence entry, and — via registered drop callbacks — the router's
        radix/popularity entries. Callers must not purge piecemeal; a
        leak audit (tests/test_liveness.py) asserts zero residue after
        this one call."""
        self._workers.pop(worker, None)
        self._rank_dirty = True
        self.link_costs.drop_worker(worker)
        self._fence.drop(worker)
        for fn in self._on_drop:
            try:
                fn(worker)
            except Exception:
                logger.exception("drop_worker callback failed for %s", worker)

    def remove_worker(self, worker: WorkerKey) -> None:
        """Back-compat alias: removal IS the drop_worker reconciliation."""
        self.drop_worker(worker)

    def workers(self) -> List[WorkerKey]:
        return sorted(self._workers)

    def load_view(self) -> Dict[WorkerKey, Tuple[int, float]]:
        """worker → (predicted decode blocks, kv usage) — the cost-model
        inputs, sampled for the router's per-worker load gauges (the signal
        the planner and FlowKV-style load-aware policies read)."""
        ttl = self.config.inflight_ttl_s
        return {
            w: (state.decode_blocks(ttl), state.kv_usage())
            for w, state in self._workers.items()
        }

    # -- selection ---------------------------------------------------------

    def select_worker(
        self,
        request_blocks: int,
        overlaps: OverlapScores,
        candidates: Optional[Sequence[WorkerKey]] = None,
        *,
        transfer: Optional[TransferContext] = None,
    ) -> Optional[WorkerKey]:
        """Pick the worker with the lowest predicted cost. ``candidates``
        restricts the choice to live instances (router-side instance map).
        ``transfer`` (disagg decode placement) adds the estimated wire cost
        of pulling each candidate's overlap-miss blocks from the source
        worker, so a prefix-overlap win never beats a slow link blindly."""
        cfg = self.config
        self.selections += 1
        evals0 = self.logit_evals

        def note(chosen_w, *, pruned: bool) -> None:
            # O(1) decision record for the router's select span.
            self.last_decision = {
                "worker": chosen_w[0] if chosen_w is not None else None,
                "candidates_scored": self.logit_evals - evals0,
                "overlap_blocks": (
                    overlaps.scores.get(chosen_w, 0)
                    if chosen_w is not None else 0
                ),
                # Dispatch metadata: a positive overlap ships with the
                # request as its speculative-onboard hint (the engine
                # starts the tier walk at enqueue — kv_prefetch.md), so
                # the decision record says whether speculation was armed.
                "prefetch_hint": bool(
                    chosen_w is not None
                    and overlaps.scores.get(chosen_w, 0) > 0
                ),
                "request_blocks": request_blocks,
                "pruned": pruned,
                "transfer_src": transfer.src if transfer is not None else None,
                "link_cost_s": (
                    round(
                        self.link_costs.seconds(
                            transfer.src,
                            chosen_w,
                            max(
                                request_blocks
                                - overlaps.scores.get(chosen_w, 0),
                                0,
                            ) * transfer.bytes_per_block,
                        ),
                        6,
                    )
                    if transfer is not None and chosen_w is not None
                    else None
                ),
            }

        # Fleet-scale fast path: above the prune threshold (and at
        # temperature 0, where selection is a pure argmin) score only the
        # candidates that can actually win instead of every worker.
        if (
            cfg.prune_threshold > 0
            and cfg.router_temperature <= 0.0
            and (len(candidates) if candidates is not None else len(self._workers))
            > cfg.prune_threshold
        ):
            chosen = self._select_pruned(
                request_blocks, overlaps, candidates, transfer
            )
            if chosen is not None:
                self._charge(chosen, request_blocks, overlaps)
                note(chosen, pruned=True)
                return chosen
            # No fully-eligible candidate (fleet-wide drain/saturation):
            # fall through to the full tiered scan, whose fallback tiers
            # still produce a best-effort placement.

        pool: List[WorkerKey] = list(candidates) if candidates is not None else self.workers()
        if not pool:
            note(None, pruned=False)
            return None
        for w in pool:
            self.add_worker(w)

        # Drain deflection FIRST (stronger than busy gating): a draining
        # worker refuses new work outright. When every candidate is
        # draining (full-fleet rolling restart mid-wave), the least-loaded
        # still wins below — the typed refusal + frontend migration is the
        # backstop, not a silent placement failure.
        not_draining = [
            w for w in pool if not self._workers[w].draining()
        ]
        if not_draining:
            pool = not_draining

        not_busy = [
            w for w in pool if self._workers[w].kv_usage() < cfg.busy_kv_usage
        ]
        if not_busy:
            pool = not_busy
        # Overload deflection: a worker at its advertised admission
        # high watermark holds new work (engine backpressure) — prefer
        # any unsaturated candidate; when ALL are saturated the least-
        # loaded still wins below (shedding is the frontend's job).
        unsaturated = [w for w in pool if not self._workers[w].saturated()]
        if unsaturated:
            pool = unsaturated

        logits = self._logits(pool, request_blocks, overlaps, transfer)
        chosen = self._sample(logits, cfg.router_temperature)
        self._charge(chosen, request_blocks, overlaps)
        note(chosen, pruned=False)
        return chosen

    def _logits(
        self,
        pool: Sequence[WorkerKey],
        request_blocks: int,
        overlaps: OverlapScores,
        transfer: Optional[TransferContext],
    ) -> List[Tuple[WorkerKey, float, int]]:
        cfg = self.config
        self.logit_evals += len(pool)
        logits: List[Tuple[WorkerKey, float, int]] = []
        for w in pool:
            overlap = overlaps.scores.get(w, 0)
            prefill = max(request_blocks - overlap, 0)
            decode = self._workers[w].decode_blocks(cfg.inflight_ttl_s)
            logit = cfg.overlap_score_weight * prefill + decode
            if cfg.queue_depth_weight > 0:
                # Accepted-but-unstarted work delays this placement the
                # same way resident decode blocks do.
                logit += cfg.queue_depth_weight * self._workers[w].queue_depth()
            if cfg.budget_pressure_weight > 0 and prefill:
                # Budget deflection: an ITL-constrained budgeter trickles
                # prefill at its squeezed per-tick budget, so every
                # overlap-miss block routed there waits for budget grants.
                # Non-negative, so the pruned path's static lower bound
                # (which omits it) stays a valid lower bound.
                bp = self._workers[w].budget_pressure()
                if bp > 0.0:
                    logit += cfg.budget_pressure_weight * bp * prefill
            if transfer is not None and cfg.link_cost_weight > 0:
                # Overlap-miss blocks must also CROSS the (src → w) link:
                # estimated seconds × prefill-rate = block-equivalents.
                wire_s = self.link_costs.seconds(
                    transfer.src, w, prefill * transfer.bytes_per_block
                )
                logit += (
                    cfg.link_cost_weight * cfg.prefill_blocks_per_s * wire_s
                )
            logits.append((w, logit, overlap))
        return logits

    def _charge(
        self, chosen: WorkerKey, request_blocks: int, overlaps: OverlapScores
    ) -> None:
        """Predict the routed request's load until the next report lands."""
        state = self._workers[chosen]
        state.inflight_blocks += max(
            request_blocks - overlaps.scores.get(chosen, 0), 0
        )
        state.inflight_at = time.monotonic()

    def _select_pruned(
        self,
        request_blocks: int,
        overlaps: OverlapScores,
        candidates: Optional[Sequence[WorkerKey]],
        transfer: Optional[TransferContext],
    ) -> Optional[WorkerKey]:
        """Argmin over a pruned candidate set (temperature 0 only).

        Whenever at least one FULLY-ELIGIBLE candidate exists (not
        draining, below busy gating, below its watermark), the full scan's
        tier filters reduce its pool to exactly the eligible candidates.
        Within that pool, a worker with zero overlap and a seed-default
        link quote has logit

            overlap_weight × request_blocks + link_const
            + static_cost + inflight_charge

        where ``static_cost`` (active blocks + weighted queue depth, from
        the last report) is a LOWER bound on the load part — in-flight
        charges only add. So the argmin is found by (a) scoring every
        overlap-carrying and link-differentiated candidate (measured EWMA
        or open breaker for this src — the only workers whose link term
        differs from the shared constant), then (b) walking the cached
        (static_cost, worker) rank in order, scoring each entry exactly,
        and STOPPING once the next entry's static lower bound exceeds the
        best exact logit seen — every unwalked worker can only be worse.
        Tie-breaks match the full scan: the rank is (cost, worker)-sorted
        and _sample orders by (logit, -overlap, worker).

        The walk is additionally capped at ``prune_walk_limit`` scored
        entries: when in-flight charges are dense across the whole fleet
        (every statically-cheap worker carries routed-but-unreported
        work), the bound cannot fire early and exactness would cost
        O(workers) again — the cap degrades selection to the best of the
        K statically-least-loaded workers (plus all specials), whose
        suboptimality is bounded by the charges one report interval can
        accumulate. Equivalence under sparse charges is test-asserted
        across randomized fleets.

        Returns None when no eligible candidate exists — the caller runs
        the full tiered scan with its all-draining/all-busy fallbacks."""
        cfg = self.config
        if self._rank_dirty:
            self._rebuild_rank()
        cand: Optional[set] = None
        if candidates is not None:
            cand = set(candidates)
            unknown = cand - self._workers.keys()
            if unknown:
                for w in unknown:
                    self.add_worker(w)
                self._rebuild_rank()
        special: set = set()
        for w in overlaps.scores:
            if w in self._workers and (cand is None or w in cand):
                special.add(w)
        if transfer is not None and cfg.link_cost_weight > 0:
            for d in self.link_costs.special_dsts(transfer.src):
                if d in self._workers and (cand is None or d in cand):
                    special.add(d)
        # The tier filters would drop ineligible specials whenever any
        # eligible candidate exists — enforce the same here.
        pool: List[WorkerKey] = sorted(
            w for w in special if self._workers[w].eligible
        )
        logits = self._logits(pool, request_blocks, overlaps, transfer)
        best = min(
            ((l, -o, w) for w, l, o in logits), default=None
        )
        # The shared part of every zero-overlap default-link logit: the
        # static rank key completes it to a lower bound.
        base_const = cfg.overlap_score_weight * request_blocks
        if transfer is not None and cfg.link_cost_weight > 0:
            base_const += (
                cfg.link_cost_weight * cfg.prefill_blocks_per_s
                * (request_blocks * transfer.bytes_per_block)
                / max(self.link_costs.default_bandwidth, 1e-9)
            )
        walked = 0
        limit = max(cfg.prune_walk_limit, 1)
        # Entries EXAMINED (scored or skipped) are bounded too: with a
        # small candidate subset of a huge fleet, skip-scanning the whole
        # rank for in-candidate workers would silently restore O(workers)
        # wall cost even while scored logits stayed bounded. Hitting this
        # cap without a scored candidate defers to the full scan.
        examine_cap = max(limit * 8, 64)
        examined = 0
        found_eligible = bool(pool)
        for cost, w in self._rank:
            examined += 1
            if examined > examine_cap:
                break
            if w in special or (cand is not None and w not in cand):
                continue
            state = self._workers.get(w)
            if state is None or not state.eligible:
                continue
            found_eligible = True
            if best is not None and base_const + cost > best[0]:
                break  # exact: nothing later in the rank can win
            entry = self._logits([w], request_blocks, overlaps, transfer)[0]
            key = (entry[1], -entry[2], entry[0])
            if best is None or key < best:
                best = key
            walked += 1
            if walked >= limit:
                break
        if best is None or not found_eligible:
            return None
        return best[2]

    def complete_request(
        self,
        worker: WorkerKey,
        charged_blocks: int,
        report_gen: Optional[int] = None,
    ) -> None:
        """Release the in-flight prediction when a routed stream finishes
        (ref: sequence.rs active-sequence removal on completion). Without
        this, a fully-cached worker keeps looking as loaded as a cold one
        until the next load report, mis-routing cache hits.

        ``report_gen`` (from report_generation() at routing time) guards
        against double-release: if a load report landed after the charge, the
        report already absorbed it, and releasing again would debit charges
        belonging to later requests."""
        state = self._workers.get(worker)
        if state is None:
            return
        if report_gen is not None and report_gen != state.report_gen:
            return
        state.inflight_blocks = max(state.inflight_blocks - charged_blocks, 0)

    def _sample(
        self, logits: List[Tuple[WorkerKey, float, int]], temperature: float
    ) -> WorkerKey:
        if temperature <= 0.0 or len(logits) == 1:
            # Deterministic at temperature 0: break cost ties by preferring
            # the higher prefix overlap (routes to the warm cache), then by
            # worker key for stability across runs.
            return min(logits, key=lambda e: (e[1], -e[2], e[0]))[0]
        # softmax over −logit/T (lower cost → higher probability)
        scaled = [-l / temperature for _, l, _ in logits]
        m = max(scaled)
        exps = [math.exp(s - m) for s in scaled]
        total = sum(exps)
        r = self._rand.random() * total
        acc = 0.0
        for (w, _, _), e in zip(logits, exps):
            acc += e
            if r <= acc:
                return w
        return logits[-1][0]
