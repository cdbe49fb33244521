"""KvIndexer: event-driven global view of which worker caches which blocks —
the port's copy of dynamo_tpu/router/indexer.py, on the Python radix tree
(the JAX indexer takes its C++ tree when g++ builds it, and the Python
tree is that tree's semantic reference; the port has no native tree).

Reference parity: lib/kv-router/src/indexer.rs (KvIndexer :110 — single
consumer task applying RouterEvents to the RadixTree, answering overlap
queries). Here the "single thread" is the asyncio loop: apply() is
synchronous and cheap; the subscription pump lives in router.py.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from dynamo_tpu_torch.router.protocols import RouterEvent, WorkerKey
from dynamo_tpu_torch.tokens.radix import OverlapScores, RadixTree
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class KvIndexer:
    def __init__(self, block_size: int) -> None:
        self.block_size = block_size
        self.tree = RadixTree()
        self._events_applied = 0
        self._last_event_id: Dict[WorkerKey, int] = {}

    @property
    def events_applied(self) -> int:
        return self._events_applied

    def apply(self, event: RouterEvent) -> None:
        worker = event.worker
        last = self._last_event_id.get(worker)
        if event.event_id and last is not None and event.event_id <= last:
            # In-flight duplicates arriving after a snapshot replaced them
            # would corrupt the rebuilt state — drop, don't re-apply.
            logger.debug(
                "dropping stale KV event %s from worker %s (last %s)",
                event.event_id, worker, last,
            )
            return
        if event.event_id:
            self._last_event_id[worker] = event.event_id
        if event.kind == "stored":
            self.tree.store(worker, event.block_hashes, event.parent_hash)
        elif event.kind == "removed":
            self.tree.remove(worker, event.block_hashes)
        elif event.kind == "cleared":
            self.tree.clear_worker(worker)
        elif event.kind == "snapshot":
            # Full-state resync: replace everything known about this worker.
            self.tree.clear_worker(worker)
            parents = event.parent_hashes or [None] * len(event.block_hashes)
            for h, p in zip(event.block_hashes, parents):
                self.tree.store(worker, [h], p)
        else:
            logger.warning("unknown KV event kind %r", event.kind)
            return
        self._events_applied += 1

    def has_seen(self, worker: WorkerKey) -> bool:
        """Whether an event of ``worker`` was applied since this index
        started or last dropped it."""
        return worker in self._last_event_id

    def has_gap(self, event: RouterEvent) -> bool:
        """True when ``event`` implies missed events from its worker (the
        router should request a snapshot)."""
        if not event.event_id or event.kind == "snapshot":
            # A snapshot IS the gap repair — its event_id legitimately jumps
            # past last+1 (live traffic between request and serialization).
            return False
        last = self._last_event_id.get(event.worker)
        if last is None:
            # Unknown worker joining mid-stream ("cleared" also rebases).
            return event.kind != "cleared" and event.event_id > 1
        return event.event_id > last + 1

    def remove_worker(self, worker: WorkerKey) -> None:
        self.tree.remove_worker(worker)
        self._last_event_id.pop(worker, None)

    def find_matches(self, block_hashes: Sequence[int]) -> OverlapScores:
        return self.tree.find_matches(block_hashes)

    def worker_block_count(self, worker: WorkerKey) -> int:
        return self.tree.worker_block_count(worker)
