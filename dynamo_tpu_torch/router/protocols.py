"""Router wire protocols: KV events and load snapshots — the port's copy of
dynamo_tpu/router/protocols.py.

Reference parity: lib/kv-router/src/protocols.rs (RouterEvent, WorkerId,
DpRank, OverlapScores) and the load metrics the scheduler consumes
(kv_router/scheduler.rs ProcessedEndpoints). Everything is a plain dict on
the wire (msgpack/json-able).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

WorkerKey = Tuple[int, int]  # (worker_id, dp_rank)

KV_EVENTS_TOPIC = "kv_events"
LOAD_TOPIC = "load"
KV_SYNC_TOPIC = "kv_sync"


def kv_events_topic(namespace: str, component: str) -> str:
    return f"{namespace}.{component}.{KV_EVENTS_TOPIC}"


def load_topic(namespace: str, component: str) -> str:
    return f"{namespace}.{component}.{LOAD_TOPIC}"


def kv_sync_topic(namespace: str, component: str) -> str:
    """Snapshot-request channel: a (re)joining router asks publishers for a
    full radix snapshot instead of waiting for TTL churn (the JetStream
    re-sync role, ref: lib/llm/src/kv_router/subscriber.rs:266)."""
    return f"{namespace}.{component}.{KV_SYNC_TOPIC}"


@dataclass
class RouterEvent:
    """One KV-cache mutation at a worker (ref: protocols.rs RouterEvent).

    ``kind="snapshot"`` carries the publisher's full committed-block set:
    ``block_hashes[i]`` pairs with ``parent_hashes[i]`` (None = root), listed
    parents-before-children so an indexer can rebuild its radix by replay.
    """

    worker_id: int
    kind: str  # "stored" | "removed" | "cleared" | "snapshot"
    block_hashes: List[int] = field(default_factory=list)
    parent_hash: Optional[int] = None
    dp_rank: int = 0
    event_id: int = 0  # per-worker monotonic; gaps trigger a sync request
    parent_hashes: Optional[List[Optional[int]]] = None  # snapshot only

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RouterEvent":
        return cls(**d)

    @property
    def worker(self) -> WorkerKey:
        return (self.worker_id, self.dp_rank)


@dataclass
class LoadSnapshot:
    """Periodic worker load report (ref: ForwardPassMetrics / load publishing
    in kv_router/publisher.rs and worker_monitor.rs)."""

    worker_id: int
    dp_rank: int = 0
    active_seqs: int = 0
    waiting: int = 0
    active_blocks: int = 0
    total_blocks: int = 0
    generated_tokens: int = 0  # cumulative, for throughput estimation
    # Engine admission-queue depth (waiting + backpressure-held). The
    # scheduler charges it as extra load so a deep queue deflects new
    # placements BEFORE the worker's KV usage shows the pain.
    queue_depth: int = 0
    # The worker's admission refusal threshold (engine
    # admit_kv_high_watermark): at/above this KV usage the worker is
    # SATURATED — it will hold new admissions rather than preempt — so
    # the router soft-skips it the way busy gating does (< 1.0 enables).
    kv_high_watermark: float = 1.0
    # src prefill worker id → EWMA observed KV-pull bandwidth (bytes/s)
    # measured at THIS worker's transfer path (disagg/handlers.py). Feeds
    # the router's per-(src, dst) link-cost model.
    link_bandwidth: Optional[Dict[int, float]] = None
    # src prefill worker ids whose pull circuit breaker at THIS worker is
    # open — the router prices those (src, this worker) pairs out of
    # disagg decode placement until the breaker's half-open window.
    link_faults: Optional[List[int]] = None
    # Live-handoff drain (runtime/drain.py): True while the worker is
    # draining — it refuses new work with a typed migratable error, so the
    # scheduler must stop placing anything here immediately.
    draining: bool = False
    # Incarnation fencing (runtime/liveness.py): the publishing PROCESS's
    # monotonically fresh incarnation stamp. 0 = an unstamped (pre-crash-
    # plane) publisher; consumers fence only stamped reports, so mixed
    # fleets interoperate.
    incarnation: int = 0
    # Tick-budgeter advertisement (engines/tpu/tick_budget.py): the
    # worker's effective per-tick prefill token budget. 0 = unbudgeted
    # (budgeter off or a pre-budgeter publisher) — the scheduler treats
    # that as unconstrained, so mixed fleets interoperate.
    prefill_budget_tokens: int = 0
    # Budgeter state (BUDGET_STATE_*): 0 off, 1 throughput (at ceiling),
    # 2 adaptive, 3 floor. FLOOR/ADAPTIVE mean the worker is ITL-
    # constrained and prefill-heavy placements should deflect elsewhere.
    budget_state: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LoadSnapshot":
        snap = cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})
        if snap.link_bandwidth:
            # JSON planes stringify int map keys; normalize on ingest.
            snap.link_bandwidth = {
                int(k): float(v) for k, v in snap.link_bandwidth.items()
            }
        if snap.link_faults:
            snap.link_faults = [int(s) for s in snap.link_faults]
        return snap

    @property
    def worker(self) -> WorkerKey:
        return (self.worker_id, self.dp_rank)

    @property
    def kv_usage(self) -> float:
        return self.active_blocks / self.total_blocks if self.total_blocks else 0.0
