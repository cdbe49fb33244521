"""Physical KV block pool: hash ↔ device-block-id, prefix reuse, LRU —
the port's copy of dynamo_tpu/engines/tpu/block_pool.py.

Reference parity: the G1 (device) pool of KVBM
(lib/llm/src/block_manager/pool/managed.rs — active/inactive sets, reuse &
eviction) fused with the mocker's KvManager semantics (kv_manager.rs:50).
Unlike the mock engine, blocks here name *physical slots* in the device cache
tensors, so the pool is the single source of truth for which device block
holds which content hash.

States: free (uninitialized/evicted) → active-private (being filled by one
sequence) → committed (full block, content-hashed, shareable) → inactive
(committed, refcount 0, LRU-evictable) → free.

Emits the same KvEvent stream as the mock engine for router indexing.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple


@dataclass
class KvEvent:
    """Router-facing KV event (copy of dynamo_tpu/engines/mock/kv_manager.py's)."""

    kind: str  # "stored" | "removed" | "cleared"
    block_hashes: List[int] = field(default_factory=list)
    parent_hash: Optional[int] = None


EventCallback = Callable[[KvEvent], None]


@dataclass
class _Committed:
    block_id: int
    parent_hash: Optional[int]
    ref_count: int = 0


class BlockPool:
    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        *,
        on_event: Optional[EventCallback] = None,
    ) -> None:
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._on_event = on_event
        self._free: Deque[int] = deque(range(num_blocks))
        self._by_hash: Dict[int, _Committed] = {}
        self._lru: "OrderedDict[int, _Committed]" = OrderedDict()  # hash → entry

    # -- stats -------------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free) + len(self._lru)

    @property
    def cached_blocks(self) -> int:
        return len(self._lru)

    @property
    def active_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    @property
    def usage(self) -> float:
        return self.active_blocks / self.num_blocks if self.num_blocks else 0.0

    def bytes_breakdown(self, block_bytes: int) -> Dict[str, int]:
        """Structural byte accounting for the HBM ledger / GET
        /debug/memory: pool-state block counts × per-block KV bytes. The
        pool itself is the single source of truth for which physical
        blocks hold live vs reusable-cached vs free content, so this is
        the only place the split can be computed without tearing."""
        block_bytes = int(block_bytes)
        return {
            "active_bytes": self.active_blocks * block_bytes,
            "cached_bytes": self.cached_blocks * block_bytes,
            "free_bytes": len(self._free) * block_bytes,
            "total_bytes": self.num_blocks * block_bytes,
        }

    # -- prefix reuse ------------------------------------------------------

    def contains(self, block_hash: int) -> bool:
        """Whether a committed block with this content hash is resident."""
        return block_hash in self._by_hash

    def snapshot_committed(self):
        """Pin EVERY committed block and return
        [(hash, parent_hash, block_id)] — a stable view for checkpointing.
        The caller must release(ids, hashes) (aligned) when done."""
        out = []
        for h, entry in self._by_hash.items():
            if entry.ref_count == 0:
                self._lru.pop(h, None)
            entry.ref_count += 1
            out.append((h, entry.parent_hash, entry.block_id))
        return out

    def committed_view(self) -> List[Tuple[int, Optional[int]]]:
        """Read-only [(hash, parent_hash)] of every committed block, in
        insertion order (parents always commit before children, so replaying
        this list rebuilds a radix index). Used by KV-event re-sync."""
        return [(h, e.parent_hash) for h, e in self._by_hash.items()]

    def match_prefix(self, block_hashes: Sequence[int]) -> int:
        n = 0
        for h in block_hashes:
            if h in self._by_hash:
                n += 1
            else:
                break
        return n

    def pin_prefix(self, block_hashes: Sequence[int]) -> Tuple[int, List[int]]:
        """Pin the longest cached prefix; returns (matched_blocks, their ids)."""
        matched = self.match_prefix(block_hashes)
        ids: List[int] = []
        for h in block_hashes[:matched]:
            entry = self._by_hash[h]
            if entry.ref_count == 0:
                self._lru.pop(h, None)
            entry.ref_count += 1
            ids.append(entry.block_id)
        return matched, ids

    # -- allocation --------------------------------------------------------

    def alloc(self) -> Optional[int]:
        """Take one free physical block (evicting cold cache if needed)."""
        if self._free:
            return self._free.popleft()
        if self._lru:
            h, entry = self._lru.popitem(last=False)
            del self._by_hash[h]
            self._emit(KvEvent(kind="removed", block_hashes=[h]))
            return entry.block_id
        return None

    def commit(
        self, block_id: int, block_hash: int, parent_hash: Optional[int]
    ) -> None:
        """A sequence finished filling `block_id`; register it shareable.

        If the hash is already cached (another sequence computed the same
        content), the physical block stays private to its owner — it is
        returned to the free list on release instead of double-registering.
        """
        if block_hash in self._by_hash:
            return
        self._by_hash[block_hash] = _Committed(
            block_id=block_id, parent_hash=parent_hash, ref_count=1
        )
        self._emit(
            KvEvent(kind="stored", block_hashes=[block_hash], parent_hash=parent_hash)
        )

    def release(self, block_ids: Sequence[int], block_hashes: Sequence[int]) -> None:
        """Sequence done. `block_hashes[i]` pairs with `block_ids[i]` for the
        committed prefix; remaining ids are private/partial blocks → freed."""
        owned = set()
        for i, h in enumerate(block_hashes):
            entry = self._by_hash.get(h)
            if entry is not None and entry.block_id == block_ids[i]:
                owned.add(i)
                entry.ref_count -= 1
                if entry.ref_count <= 0:
                    entry.ref_count = 0
                    self._lru[h] = entry
                    self._lru.move_to_end(h)
        for i, bid in enumerate(block_ids):
            if i not in owned:
                self._free.append(bid)

    def clear(self) -> None:
        """Drop all reusable cached blocks (ref: clear_kv_blocks route)."""
        evicted = list(self._lru)
        for h in evicted:
            entry = self._lru.pop(h)
            del self._by_hash[h]
            self._free.append(entry.block_id)
        if evicted:
            self._emit(KvEvent(kind="removed", block_hashes=evicted))
        self._emit(KvEvent(kind="cleared"))

    def _emit(self, event: KvEvent) -> None:
        if self._on_event is not None:
            self._on_event(event)
