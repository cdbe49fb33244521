"""Radix tree over chained block hashes → worker sets — the port's copy of
dynamo_tpu/tokens/radix.py.

Reference parity: lib/kv-router/src/radix_tree.rs:73 (RadixTree),
protocols.rs (OverlapScores, WorkerId). Because block hashes are *chained*,
a child hash can only ever follow its unique parent hash, so the tree's edge
label is simply the child block hash and lookup is a walk from the root.

The tree answers: given a new request's block hashes, how many leading blocks
does each worker already hold in KV cache (OverlapScores)? Updates arrive as
KV events from workers: Stored(parent_hash, hashes), Removed(hashes), Clear.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

WorkerKey = Tuple[int, int]  # (worker_id, dp_rank)


@dataclass
class _Node:
    block_hash: int
    parent: Optional["_Node"]
    children: Dict[int, "_Node"] = field(default_factory=dict)
    workers: Set[WorkerKey] = field(default_factory=set)


@dataclass
class OverlapScores:
    """Per-worker count of leading blocks already cached."""

    scores: Dict[WorkerKey, int] = field(default_factory=dict)
    # Blocks matched by at least one worker (the frontier depth).
    matched_blocks: int = 0

    def best(self) -> Optional[Tuple[WorkerKey, int]]:
        if not self.scores:
            return None
        worker = max(self.scores, key=lambda w: self.scores[w])
        return worker, self.scores[worker]


class RadixTree:
    def __init__(self) -> None:
        self._root = _Node(block_hash=0, parent=None)
        # Global hash → node index: chained hashes are unique per prefix, so
        # each hash names exactly one node (ref: flat_hashmap.rs equivalence).
        self._nodes: Dict[int, _Node] = {}
        # Per-worker set of held hashes, for fast worker removal.
        self._worker_blocks: Dict[WorkerKey, Set[int]] = {}

    # -- stats -------------------------------------------------------------

    @property
    def num_blocks(self) -> int:
        return len(self._nodes)

    @property
    def workers(self) -> List[WorkerKey]:
        return sorted(self._worker_blocks)

    def worker_block_count(self, worker: WorkerKey) -> int:
        return len(self._worker_blocks.get(worker, ()))

    # -- updates -----------------------------------------------------------

    def store(
        self,
        worker: WorkerKey,
        block_hashes: Sequence[int],
        parent_hash: Optional[int] = None,
    ) -> None:
        """Worker now holds ``block_hashes`` (a chain, following parent_hash)."""
        if parent_hash is None:
            node = self._root
        else:
            node = self._nodes.get(parent_hash)
            if node is None:
                # Parent unknown (e.g. events replayed out of order): root the
                # chain at a detached node so lookups through the full chain
                # still work via the flat map.
                node = _Node(block_hash=parent_hash, parent=None)
                self._nodes[parent_hash] = node
        held = self._worker_blocks.setdefault(worker, set())
        for h in block_hashes:
            child = node.children.get(h)
            if child is None:
                child = self._nodes.get(h)
                if child is None:
                    child = _Node(block_hash=h, parent=node)
                    self._nodes[h] = child
                else:
                    child.parent = node
                node.children[h] = child
            child.workers.add(worker)
            held.add(h)
            node = child

    def remove(self, worker: WorkerKey, block_hashes: Iterable[int]) -> None:
        """Worker evicted these blocks."""
        held = self._worker_blocks.get(worker)
        for h in block_hashes:
            node = self._nodes.get(h)
            if node is not None:
                node.workers.discard(worker)
                self._maybe_prune(node)
            if held is not None:
                held.discard(h)

    def remove_worker(self, worker: WorkerKey) -> None:
        """Worker died / deregistered: drop all its blocks."""
        held = self._worker_blocks.pop(worker, set())
        for h in held:
            node = self._nodes.get(h)
            if node is not None:
                node.workers.discard(worker)
                self._maybe_prune(node)

    def clear_worker(self, worker: WorkerKey) -> None:
        """Worker flushed its KV cache (ref: clear_kv_blocks admin route)."""
        self.remove_worker(worker)
        self._worker_blocks[worker] = set()

    def _maybe_prune(self, node: _Node) -> None:
        # Prune leaf nodes nobody holds; walk up while the chain stays empty.
        while (
            node is not None
            and node is not self._root
            and not node.workers
            and not node.children
        ):
            parent = node.parent
            if parent is not None:
                parent.children.pop(node.block_hash, None)
            self._nodes.pop(node.block_hash, None)
            node = parent

    # -- lookup ------------------------------------------------------------

    def find_matches(self, block_hashes: Sequence[int]) -> OverlapScores:
        """Walk the chain from the root; score = leading blocks per worker.

        A worker's score counts contiguous blocks from position 0 — a hole
        ends its run (matching scheduler semantics: only a prefix can be
        skipped at prefill, ref: radix_tree.rs find_matches).
        """
        result = OverlapScores()
        node = self._root
        active: Set[WorkerKey] = set()
        depth = 0
        for h in block_hashes:
            child = node.children.get(h)
            if child is None:
                break
            depth += 1
            if depth == 1:
                active = set(child.workers)
            else:
                active &= child.workers
            if not active:
                # Workers holding a deeper block without this one can't use it
                # as prefix; stop at the last depth where someone held all.
                break
            for w in active:
                result.scores[w] = depth
            node = child
        result.matched_blocks = max(result.scores.values(), default=0)
        return result
