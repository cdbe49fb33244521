"""Approximate KV indexer: routing-decision-driven, TTL-pruned — the
port's copy of dynamo_tpu/router/approx.py, on the Python radix tree
(the JAX indexer takes its C++ tree when g++ builds it; the port has none).

Reference parity: lib/kv-router/src/approx.rs (PruneManager: lazily-staled
expiry heap, size-based pruning deepest-first) and kv_router.rs:359,937
(``use_kv_events=false`` mode — the router records its OWN routing
decisions as if the chosen worker had cached those blocks, since no event
feed exists to tell it the truth).

When to use: engines that don't publish KV events (external engines wired
through the KVBM connector, mockers without an event plane, cross-cluster
routing where the event fan-in is too chatty). The index is optimistic —
TTL expiry ages out blocks the worker has probably evicted, and size
pruning bounds memory. Deeper blocks (larger sequence position) expire
first on prune: the root of a prefix chain is the most shareable part.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from dynamo_tpu_torch.router.protocols import WorkerKey
from dynamo_tpu_torch.tokens.radix import OverlapScores, RadixTree
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class PruneConfig:
    """(ref: approx.rs PruneConfig — same defaults)"""

    ttl: float = 120.0  # seconds a recorded block stays credible
    max_tree_size: int = 1 << 20  # blocks before size pruning kicks in
    prune_target_ratio: float = 0.8  # prune down to this fraction of max


class PruneManager:
    """Expiry timers addressable by key, with lazy heap invalidation.

    ``timers`` is the source of truth; the heap may hold stale entries
    (re-inserted keys) which are skipped when popped. Heap order is
    (expiry, depth) so ties expire deepest-first — matching the reference's
    BlockEntry ordering by seq_position for pruning.
    """

    def __init__(self, config: Optional[PruneConfig] = None, *, clock=None) -> None:
        self.config = config or PruneConfig()
        self._clock = clock or time.monotonic
        self._timers: Dict[Hashable, float] = {}
        self._depth: Dict[Hashable, int] = {}
        self._heap: List[Tuple[float, int, Hashable]] = []

    def __len__(self) -> int:
        return len(self._timers)

    def insert(self, keys: Sequence[Hashable], depths: Sequence[int]) -> None:
        """Start (or refresh) the TTL for each key."""
        expiry = self._clock() + self.config.ttl
        for key, depth in zip(keys, depths):
            self._timers[key] = expiry
            self._depth[key] = depth
            heapq.heappush(self._heap, (expiry, depth, key))

    def pop_expired(self) -> List[Hashable]:
        """Remove and return every key whose TTL has elapsed."""
        now = self._clock()
        out: List[Hashable] = []
        while self._heap and self._heap[0][0] <= now:
            expiry, _depth, key = heapq.heappop(self._heap)
            if self._timers.get(key) != expiry:
                continue  # stale heap entry; the key was refreshed
            del self._timers[key]
            self._depth.pop(key, None)
            out.append(key)
        return out

    def next_expiry(self) -> Optional[float]:
        while self._heap:
            expiry, _d, key = self._heap[0]
            if self._timers.get(key) == expiry:
                return expiry
            heapq.heappop(self._heap)
        return None

    def prune(self, current_size: int) -> List[Hashable]:
        """If over max_tree_size, evict earliest-expiring (deepest on ties)
        keys down to target size. Returns the evicted keys."""
        cfg = self.config
        if current_size <= cfg.max_tree_size:
            return []
        target = int(cfg.max_tree_size * cfg.prune_target_ratio)
        out: List[Hashable] = []
        # Max-heap by (expiry, depth) would evict last-to-expire first; the
        # reference evicts by soonest expiry (oldest knowledge) and deepest
        # position — exactly the heap order we already maintain.
        while self._heap and len(self._timers) > target:
            expiry, _d, key = heapq.heappop(self._heap)
            if self._timers.get(key) != expiry:
                continue
            del self._timers[key]
            self._depth.pop(key, None)
            out.append(key)
        return out


@dataclass
class ApproxStats:
    decisions: int = 0
    expired: int = 0
    pruned: int = 0


class ApproxKvIndexer:
    """KvIndexer-compatible surface fed by routing decisions, not events.

    ``process_routing_decision(hashes, worker)`` optimistically stores the
    full block chain for the chosen worker; ``tick()`` (called inline from
    the router on each decision, and cheap when nothing expired) ages out
    stale knowledge. (ref: kv_router.rs process_routing_decision_for_request)
    """

    def __init__(
        self,
        block_size: int,
        config: Optional[PruneConfig] = None,
        *,
        clock=None,
    ) -> None:
        self.block_size = block_size
        self.tree = RadixTree()
        self.prune_manager = PruneManager(config, clock=clock)
        self.stats = ApproxStats()
        self._events_applied = 0  # surface parity with KvIndexer

    @property
    def events_applied(self) -> int:
        return self._events_applied

    # -- decisions ---------------------------------------------------------

    def process_routing_decision(
        self, block_hashes: Sequence[int], worker: WorkerKey
    ) -> None:
        if not block_hashes:
            return
        self.tree.store(worker, list(block_hashes), None)
        keys = [(worker, h) for h in block_hashes]
        self.prune_manager.insert(keys, list(range(len(keys))))
        self.stats.decisions += 1
        self.tick()

    def tick(self) -> None:
        """Apply TTL expiry and size pruning to the tree."""
        expired = self.prune_manager.pop_expired()
        for worker, h in expired:
            self.tree.remove(worker, [h])
        self.stats.expired += len(expired)
        pruned = self.prune_manager.prune(self.tree.num_blocks)
        for worker, h in pruned:
            self.tree.remove(worker, [h])
        self.stats.pruned += len(pruned)

    # -- KvIndexer surface -------------------------------------------------

    def apply(self, event) -> None:  # pragma: no cover - defensive
        logger.warning(
            "ApproxKvIndexer ignores KV events (use_kv_events=False); "
            "got %r", getattr(event, "kind", event),
        )

    def remove_worker(self, worker: WorkerKey) -> None:
        self.tree.remove_worker(worker)

    def find_matches(self, block_hashes: Sequence[int]) -> OverlapScores:
        self.tick()
        return self.tree.find_matches(block_hashes)

    def worker_block_count(self, worker: WorkerKey) -> int:
        return self.tree.worker_block_count(worker)
