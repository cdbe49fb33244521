"""KV-reuse observability plane: prefix popularity, cache ROI, tier flow —
the port's copy of dynamo_tpu/runtime/kv_reuse_observe.py.

ROADMAP item 2 (enterprise-scale KV reuse) needs eviction informed by "the
router's observed prefix popularity" and a hit-rate win provable as TTFT
goodput — but nothing in the stack *observed* prefix popularity or what
each cache hit saved. This module is that measurement substrate (the
trajectory plane's sibling, design: docs/design_docs/kv_reuse_observability.md):

* ``PrefixPopularitySketch`` — a space-saving heavy-hitter sketch over
  block-hash-chain anchors: fixed capacity, min-replacement, exponentially
  decayed counts (recency-weighted popularity). Fed from router radix
  matches and engine prefix-cache hits; memory is bounded by capacity, not
  by the number of distinct prefixes ever seen.
* ``KvReuseMetrics`` — the lint-pinned ``ALL_KVCACHE`` family: hit rate by
  tier, reused vs recomputed prefill tokens, prefill-seconds-saved, sketch
  occupancy/replacements, tier-eviction reasons.
* ``KvReusePlane`` — the process-global aggregation point: sketch +
  metrics + the EWMA per-token prefill cost that prices a hit
  (seconds_saved = cached_tokens × cost/token), plus per-request ROI
  stamping into the trajectory plane (``note_event`` ring "kvcache").

Hot-path budget: every feed is O(1) amortized (dict lookup + heap push)
and rides admission / stream-end paths — OUTSIDE the DYN002 decode tick
scope — so the plane stays under the 1%/burst observe-overhead bar
(``_prof_gap.py``). Feeds never raise: observability must not take down
serving.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from dynamo_tpu_torch import config

logger = logging.getLogger(__name__)

# Declared in the canonical registry (config.py).
SKETCH_CAPACITY = config.KV_SKETCH_CAPACITY
SKETCH_HALF_LIFE_S = config.KV_SKETCH_HALF_LIFE_S


class _SketchEntry:
    """One tracked prefix. Counts are stored in inflated coordinates
    (see PrefixPopularitySketch) so ordering is time-invariant."""

    __slots__ = (
        "anchor", "count", "error", "hits", "tokens", "last_hit",
        "tiers", "workers",
    )

    def __init__(self, anchor: int) -> None:
        self.anchor = anchor
        self.count = 0.0  # inflated (scaled) decayed count
        self.error = 0.0  # space-saving overestimation bound (scaled)
        self.hits = 0  # raw lifetime touches (undecayed)
        self.tokens = 0  # cumulative tokens served from cache
        self.last_hit = 0.0  # wall clock, for display
        self.tiers: Dict[str, int] = {}  # tier -> raw hit count
        # worker key -> [scaled count, tokens] for zero-residue drop_worker
        self.workers: Dict[Any, List[float]] = {}


class PrefixPopularitySketch:
    """Space-saving heavy hitters with exponential time decay.

    Classic space-saving: at most ``capacity`` entries; an untracked key
    arriving at capacity replaces the minimum-count entry, inheriting its
    count as the overestimation ``error``. Guarantees every true heavy
    hitter above ~N/capacity is tracked, with bounded error.

    Decay without rescans: instead of decaying old counts we *inflate* new
    increments — a touch at time t has weight ``2^((t - origin)/half_life)``.
    Ratios between entries then equal the ratios of their exponentially
    decayed counts, ordering is time-invariant, and a lazy min-heap works.
    The true decayed count is recovered at read time by multiplying with
    ``2^(-(now - origin)/half_life)``; ``origin`` is rebased before the
    inflation factor can overflow a float.

    Thread-safe (router thread + engine loop may both feed it); every
    operation is O(log capacity) amortized.
    """

    # Rebase origin once the inflation exponent passes this (2^256 is
    # comfortably inside float range; rebase is O(capacity), rare).
    _REBASE_EXP = 256.0

    def __init__(
        self,
        capacity: Optional[int] = None,
        half_life_s: Optional[float] = None,
    ) -> None:
        self.capacity = int(capacity if capacity is not None else SKETCH_CAPACITY.get())
        self.half_life_s = float(
            half_life_s if half_life_s is not None else SKETCH_HALF_LIFE_S.get()
        )
        self._lock = threading.Lock()
        self._entries: Dict[int, _SketchEntry] = {}
        # Lazy min-heap of (scaled_count, anchor); stale tuples (count no
        # longer matching the entry) are skipped at pop time. Bounded by
        # periodic rebuild so sketch memory stays O(capacity).
        self._heap: List[Tuple[float, int]] = []
        self._origin = time.time()
        self.replacements = 0
        self.total_touches = 0

    # -- internals (lock held) ----------------------------------------------

    def _weight(self, now: float) -> float:
        if self.half_life_s <= 0:
            return 1.0
        exp = (now - self._origin) / self.half_life_s
        if exp > self._REBASE_EXP:
            self._rebase(now)
            exp = 0.0
        return 2.0 ** exp

    def _rebase(self, now: float) -> None:
        shift = 2.0 ** (-(now - self._origin) / self.half_life_s)
        for e in self._entries.values():
            e.count *= shift
            e.error *= shift
            for pair in e.workers.values():
                pair[0] *= shift
        self._origin = now
        self._rebuild_heap()

    def _rebuild_heap(self) -> None:
        self._heap = [(e.count, a) for a, e in self._entries.items()]
        heapq.heapify(self._heap)

    def _pop_min(self) -> _SketchEntry:
        """Remove and return the minimum-count entry (fresh heap top)."""
        while self._heap:
            count, anchor = heapq.heappop(self._heap)
            entry = self._entries.get(anchor)
            if entry is not None and entry.count == count:
                del self._entries[anchor]
                return entry
        # Heap exhausted by staleness: rebuild and retry (entries is
        # non-empty when this is called).
        self._rebuild_heap()
        return self._pop_min()

    def _decay_factor(self, now: float) -> float:
        if self.half_life_s <= 0:
            return 1.0
        return 2.0 ** (-(now - self._origin) / self.half_life_s)

    # -- feeds ---------------------------------------------------------------

    def touch(
        self,
        anchor: int,
        tokens: int = 0,
        tier: str = "device",
        worker: Any = None,
    ) -> None:
        """Record one cache hit on the prefix anchored at ``anchor``."""
        now = time.time()
        with self._lock:
            self.total_touches += 1
            w = self._weight(now)
            entry = self._entries.get(anchor)
            if entry is None:
                if len(self._entries) >= self.capacity:
                    victim = self._pop_min()
                    self.replacements += 1
                    entry = _SketchEntry(anchor)
                    # Space-saving inheritance: the newcomer takes the
                    # victim's count as its floor AND its error bound.
                    entry.count = victim.count
                    entry.error = victim.count
                else:
                    entry = _SketchEntry(anchor)
                self._entries[anchor] = entry
            entry.count += w
            entry.hits += 1
            entry.tokens += int(tokens)
            entry.last_hit = now
            entry.tiers[tier] = entry.tiers.get(tier, 0) + 1
            if worker is not None:
                pair = entry.workers.setdefault(worker, [0.0, 0.0])
                pair[0] += w
                pair[1] += tokens
            heapq.heappush(self._heap, (entry.count, anchor))
            if len(self._heap) > 8 * self.capacity:
                self._rebuild_heap()

    def drop_worker(self, worker: Any) -> int:
        """Zero-residue purge: subtract a departed worker's contributions;
        entries it alone sustained are removed. Returns entries touched."""
        touched = 0
        with self._lock:
            dead: List[int] = []
            for anchor, e in self._entries.items():
                pair = e.workers.pop(worker, None)
                if pair is None:
                    continue
                touched += 1
                e.count -= pair[0]
                e.tokens = max(0, e.tokens - int(pair[1]))
                # Entirely (or numerically) this worker's entry: drop it.
                if e.count <= e.error * 1e-12 + 1e-9 and not e.workers:
                    dead.append(anchor)
            for anchor in dead:
                del self._entries[anchor]
            if touched:
                self._rebuild_heap()
        return touched

    # -- reads ---------------------------------------------------------------

    def top(self, k: int = 20) -> List[Dict[str, Any]]:
        """Ranked top-K prefixes by decayed popularity."""
        now = time.time()
        with self._lock:
            f = self._decay_factor(now)
            ranked = sorted(
                self._entries.values(), key=lambda e: e.count, reverse=True
            )[: max(0, int(k))]
            return [
                {
                    "anchor": f"{e.anchor:016x}",
                    "score": e.count * f,
                    "score_error": e.error * f,
                    "hits": e.hits,
                    "tokens_from_cache": e.tokens,
                    "age_s": max(0.0, now - e.last_hit),
                    "tiers": dict(e.tiers),
                }
                for e in ranked
            ]

    def top_scores(self, k: int = 20) -> Dict[int, float]:
        """Ranked top-K as ``{anchor: decayed_score}`` — the narrow feed
        the KVBM eviction scorer consumes (kvbm/manager.py): integer
        anchors, no per-row formatting, one lock hold."""
        with self._lock:
            f = self._decay_factor(time.time())
            ranked = heapq.nlargest(
                max(0, int(k)), self._entries.values(),
                key=lambda e: e.count,
            )
            return {e.anchor: e.count * f for e in ranked}

    def stamp(self) -> Tuple[int, int]:
        """Cheap change marker: ``(total_touches, replacements)``.
        Consumers that cache a derived view (the KVBM protected-prefix
        map) rebuild only when this moves."""
        with self._lock:
            return (self.total_touches, self.replacements)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "tracked": len(self._entries),
                "replacements": self.replacements,
                "total_touches": self.total_touches,
                "half_life_s": self.half_life_s,
            }

    def __len__(self) -> int:
        return len(self._entries)


class KvReuseMetrics:
    """The ``ALL_KVCACHE`` family on a private registry (metrics_core.py
    rationale: several planes per process must not collide)."""

    def __init__(self, sketch: PrefixPopularitySketch) -> None:
        from dynamo_tpu_torch.runtime import metric_names as mn
        from dynamo_tpu_torch.runtime.metrics_core import MetricsRegistry

        self._sketch = sketch
        self.registry = MetricsRegistry()
        self.hits = self.registry.counter(
            mn.KVCACHE_HITS_TOTAL,
            "Prefix-cache hits by the tier the hit resolved from",
            ["tier"],
        )
        self.misses = self.registry.counter(
            mn.KVCACHE_MISSES_TOTAL,
            "Requests that found no cached prefix in any tier",
        )
        self.hit_rate = self.registry.gauge(
            mn.KVCACHE_HIT_RATE,
            "Fraction of prefix lookups resolved by each tier "
            "(render-time ratio of the hit/miss counters)",
            ["tier"],
        )
        self.reused_tokens = self.registry.counter(
            mn.KVCACHE_REUSED_TOKENS_TOTAL,
            "Prefill tokens served from cache instead of recomputed",
        )
        self.recomputed_tokens = self.registry.counter(
            mn.KVCACHE_RECOMPUTED_TOKENS_TOTAL,
            "Prefill tokens actually computed on device",
        )
        self.seconds_saved = self.registry.counter(
            mn.KVCACHE_PREFILL_SECONDS_SAVED_TOTAL,
            "Estimated prefill seconds saved by cache hits "
            "(cached tokens x EWMA per-token prefill cost)",
        )
        self.prefill_cost = self.registry.gauge(
            mn.KVCACHE_PREFILL_COST_PER_TOKEN,
            "EWMA per-token prefill cost the ROI estimate prices hits at",
        )
        self.sketch_tracked = self.registry.gauge(
            mn.KVCACHE_SKETCH_TRACKED_PREFIXES,
            "Prefixes tracked by the popularity sketch (<= capacity)",
        )
        self.sketch_replacements = self.registry.counter(
            mn.KVCACHE_SKETCH_REPLACEMENTS_TOTAL,
            "Space-saving min-replacements (sketch churn)",
        )
        self.sketch_lookup_p99 = self.registry.gauge(
            mn.KVCACHE_SKETCH_LOOKUP_P99_SECONDS,
            "p99 sketch touch latency (recorded by the scale harness)",
        )
        self.evictions = self.registry.counter(
            mn.KVCACHE_EVICTIONS_TOTAL,
            "Tier evictions by reason (arena_full | capacity | corrupt)",
            ["tier", "reason"],
        )
        self._known_tiers: set = set()
        self.registry.on_render(self._refresh)

    def _refresh(self) -> None:
        st = self._sketch.stats()
        self.sketch_tracked.set(st["tracked"])
        self.sketch_replacements.set_total(st["replacements"])
        # Hit rate per tier = tier hits / all lookups (hits + misses).
        total = self.misses.value()
        per_tier = {t: self.hits.value(tier=t) for t in self._known_tiers}
        total += sum(per_tier.values())
        for t, n in per_tier.items():
            self.hit_rate.set(n / total if total > 0 else 0.0, tier=t)

    def note_hit(self, tier: str) -> None:
        self._known_tiers.add(tier)
        self.hits.inc(tier=tier)

    def forget_tier(self, tier: str) -> None:
        """Departed-tier GC: drop the gauge series (counters stay — they
        are monotonic history)."""
        self._known_tiers.discard(tier)
        self.hit_rate.remove(tier=tier)

    def render(self, openmetrics: bool = False) -> str:
        return self.registry.render(openmetrics=openmetrics)


class KvReusePlane:
    """Process-global aggregation point for the KV-reuse plane."""

    # EWMA smoothing for the per-token prefill cost (same spirit as the
    # disagg link-bandwidth EWMA: stable under bursty chunk sizes).
    _EWMA_ALPHA = 0.2

    def __init__(
        self,
        capacity: Optional[int] = None,
        half_life_s: Optional[float] = None,
    ) -> None:
        self.sketch = PrefixPopularitySketch(capacity, half_life_s)
        self.metrics = KvReuseMetrics(self.sketch)
        self._cost_lock = threading.Lock()
        self._cost_per_token: Optional[float] = None
        # Live tier-occupancy sources: label -> callable returning
        # {tier: {"blocks": int, ...}}. Registered by TieredKvManager
        # (and anything else holding tiers); deregistered on close.
        self._tier_sources: Dict[str, Callable[[], Dict[str, Any]]] = {}

    # -- prefill cost (the ROI price) ---------------------------------------

    def note_prefill_cost(self, duration_s: float, tokens: int) -> None:
        """Feed one prefill dispatch (engines observe_prefill rides this)."""
        if tokens <= 0 or duration_s <= 0:
            return
        per_token = duration_s / tokens
        with self._cost_lock:
            if self._cost_per_token is None:
                self._cost_per_token = per_token
            else:
                self._cost_per_token += self._EWMA_ALPHA * (
                    per_token - self._cost_per_token
                )
            self.metrics.prefill_cost.set(self._cost_per_token)

    def prefill_cost_per_token(self) -> float:
        with self._cost_lock:
            return self._cost_per_token or 0.0

    # -- per-request attribution --------------------------------------------

    def note_request(
        self,
        *,
        anchor: Optional[int],
        cached_tokens: int,
        recomputed_tokens: int,
        tier: str = "device",
        worker: Any = None,
        trace_id: Optional[str] = None,
    ) -> Dict[str, Any]:
        """One admitted request's cache outcome: sketch + ROI counters +
        (when traced) a trajectory "kvcache"/"roi" event. Returns the ROI
        dict so callers can stamp it elsewhere (lifecycle, bench)."""
        seconds_saved = cached_tokens * self.prefill_cost_per_token()
        roi = {
            "cached_tokens": int(cached_tokens),
            "recomputed_tokens": int(recomputed_tokens),
            "seconds_saved": seconds_saved,
            "tier": tier,
        }
        try:
            if cached_tokens > 0:
                if anchor is not None:
                    self.sketch.touch(
                        anchor, tokens=cached_tokens, tier=tier, worker=worker
                    )
                self.metrics.note_hit(tier)
                self.metrics.reused_tokens.inc(int(cached_tokens))
                if seconds_saved > 0:
                    self.metrics.seconds_saved.inc(seconds_saved)
            else:
                self.metrics.misses.inc()
            if recomputed_tokens > 0:
                self.metrics.recomputed_tokens.inc(int(recomputed_tokens))
            if trace_id:
                from dynamo_tpu_torch.runtime.trajectory import note_event

                note_event(trace_id, "kvcache", "roi", **roi)
        except Exception:
            # Observability must not take down serving — but a plane bug
            # must not be invisible either.
            logger.debug("kv-reuse ROI feed failed", exc_info=True)
        return roi

    def note_router_match(
        self, anchor: int, tokens: int, worker: Any = None
    ) -> None:
        """Router radix match: popularity only (the engine-side hit will
        account the metrics — double feeds would inflate hit rates)."""
        try:
            self.sketch.touch(anchor, tokens=tokens, tier="device", worker=worker)
        except Exception:
            logger.debug("kv-reuse router feed failed", exc_info=True)

    def note_eviction(self, tier: str, reason: str, n: int = 1) -> None:
        if n > 0:
            self.metrics.evictions.inc(n, tier=tier, reason=reason)

    def drop_worker(self, worker: Any) -> int:
        """Departed-worker purge (the crash plane's zero-residue audit
        extended to this plane): sketch contributions subtracted, entries
        it alone sustained removed."""
        return self.sketch.drop_worker(worker)

    # -- tier sources / introspection ---------------------------------------

    def register_tier_source(
        self, label: str, fn: Callable[[], Dict[str, Any]]
    ) -> None:
        self._tier_sources[label] = fn

    def forget_tier_source(self, label: str) -> None:
        self._tier_sources.pop(label, None)

    def tiers(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for label, fn in list(self._tier_sources.items()):
            try:
                out[label] = fn()
            except Exception:
                out[label] = {"error": "source failed"}
        return out

    def snapshot(self, top_k: int = 10) -> Dict[str, Any]:
        """The GET /debug/kvcache body (also the CLI's source)."""
        m = self.metrics
        m._refresh()
        hit_rate = {
            t: m.hit_rate.value(tier=t) for t in sorted(m._known_tiers)
        }
        return {
            "hit_rate": hit_rate,
            "hits": {
                t: m.hits.value(tier=t) for t in sorted(m._known_tiers)
            },
            "misses": m.misses.value(),
            "reused_prefill_tokens": m.reused_tokens.value(),
            "recomputed_prefill_tokens": m.recomputed_tokens.value(),
            "prefill_seconds_saved": m.seconds_saved.value(),
            "prefill_cost_per_token_s": self.prefill_cost_per_token(),
            "sketch": self.sketch.stats(),
            "tiers": self.tiers(),
            "top_prefixes": self.sketch.top(top_k),
        }


_PLANE: Optional[KvReusePlane] = None
_PLANE_LOCK = threading.Lock()


def global_plane() -> KvReusePlane:
    """The process-global plane (router, engines, and KVBM all feed the
    same sketch — colocated planes share popularity by design)."""
    global _PLANE
    if _PLANE is None:
        with _PLANE_LOCK:
            if _PLANE is None:
                _PLANE = KvReusePlane()
    return _PLANE


def render_kv_reuse_metrics(openmetrics: bool = False) -> str:
    """ALL_KVCACHE exposition for every SystemStatusServer (the KV-reuse
    analog of render_trajectory_metrics)."""
    return global_plane().metrics.render(openmetrics=openmetrics)


def kvcache_index(
    plane: Optional[KvReusePlane] = None, top_k: int = 10
) -> Dict[str, Any]:
    """The GET /debug/kvcache response body — ONE shape shared by the
    system server and the CLI."""
    plane = plane if plane is not None else global_plane()
    return plane.snapshot(top_k=top_k)


def kvcache_prefixes(
    plane: Optional[KvReusePlane] = None, k: int = 50
) -> Dict[str, Any]:
    """The GET /debug/kvcache/prefixes body: ranked top-K + sketch stats."""
    plane = plane if plane is not None else global_plane()
    return {"sketch": plane.sketch.stats(), "prefixes": plane.sketch.top(k)}
