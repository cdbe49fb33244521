"""LoRA placement: rendezvous (HRW) hashing + routing table.
The port's copy of dynamo_tpu/lora/routing.py (framework-free).

Reference parity: lib/llm/src/lora/routing/{hrw.rs,table.rs,mod.rs} —
RendezvousHasher.compute_score/rank_workers, LoraRoutingTable replica sets.
HRW gives stable, coordination-free placement: adding/removing a worker
only moves the adapters that hashed to it.
"""

from __future__ import annotations

import hashlib
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

WorkerKey = Tuple[int, int]  # (worker_id, dp_rank)


class RendezvousHasher:
    """Highest-random-weight placement (ref: hrw.rs)."""

    @staticmethod
    def compute_score(lora_name: str, worker: WorkerKey) -> int:
        h = hashlib.blake2b(digest_size=8)
        h.update(lora_name.encode())
        h.update(f"{worker[0]:x}:{worker[1]}".encode())
        return int.from_bytes(h.digest(), "big")

    @classmethod
    def rank_workers(
        cls, lora_name: str, workers: Sequence[WorkerKey]
    ) -> List[WorkerKey]:
        return sorted(
            workers,
            key=lambda w: cls.compute_score(lora_name, w),
            reverse=True,
        )

    @classmethod
    def allocate(
        cls, lora_name: str, workers: Sequence[WorkerKey], n_replicas: int
    ) -> List[WorkerKey]:
        return cls.rank_workers(lora_name, workers)[: max(n_replicas, 1)]


class RandomAllocator:
    """(ref: mod.rs RandomAllocation) — baseline placement for comparison."""

    @classmethod
    def allocate(
        cls, lora_name: str, workers: Sequence[WorkerKey], n_replicas: int
    ) -> List[WorkerKey]:
        pool = list(workers)
        rng = random.Random(lora_name)  # deterministic per adapter
        rng.shuffle(pool)
        return pool[: max(n_replicas, 1)]


@dataclass
class LoraReplicaConfig:
    """(ref: table.rs LoraReplicaConfig)"""

    replicas: List[WorkerKey] = field(default_factory=list)
    n_desired: int = 1


class LoraRoutingTable:
    """adapter name → replica set; thread-safe (ref: table.rs)."""

    def __init__(self) -> None:
        self._table: Dict[str, LoraReplicaConfig] = {}
        self._lock = threading.Lock()

    def get_replica_set(self, lora_name: str) -> Optional[List[WorkerKey]]:
        with self._lock:
            cfg = self._table.get(lora_name)
            return list(cfg.replicas) if cfg else None

    def update_allocation(self, lora_name: str, config: LoraReplicaConfig) -> None:
        with self._lock:
            self._table[lora_name] = config

    def remove_lora(self, lora_name: str) -> Optional[LoraReplicaConfig]:
        with self._lock:
            return self._table.pop(lora_name, None)

    def list_loras(self) -> List[str]:
        with self._lock:
            return sorted(self._table)

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)

    def clear(self) -> None:
        with self._lock:
            self._table.clear()

    def reallocate(
        self,
        workers: Sequence[WorkerKey],
        *,
        desired: Optional[Dict[str, int]] = None,
        allocator=RendezvousHasher,
    ) -> None:
        """Recompute every adapter's replica set over the live worker set
        (called on worker join/leave or when the load estimator changes the
        desired replica counts)."""
        with self._lock:
            for name, cfg in self._table.items():
                n = (desired or {}).get(name, cfg.n_desired)
                cfg.n_desired = n
                cfg.replicas = allocator.allocate(name, workers, n)
