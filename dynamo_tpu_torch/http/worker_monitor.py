"""Busy thresholds for frontend load shedding — the port's copy of
``BusyThresholds`` from dynamo_tpu/http/worker_monitor.py. The
``WorkerLoadMonitor`` that checks them reads the router's load events,
which come with the distributed runtime; until then a model has no monitor
and is never busy.

Reference parity: lib/llm/src/http/service/busy_threshold.rs (per-model
thresholds on KV-block utilization and prefill pressure; when ALL workers
for a model exceed them, new requests are rejected 503).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass
class BusyThresholds:
    """(ref: busy_threshold.rs BusyThresholdRequest fields)"""

    # fraction of KV blocks in use above which a worker counts as busy
    active_decode_blocks_threshold: Optional[float] = None
    # queued (not yet admitted) requests above which a worker counts as busy
    # (the prefill-pressure analog of the reference's prefill-token gauges)
    waiting_requests_threshold: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "active_decode_blocks_threshold": self.active_decode_blocks_threshold,
            "waiting_requests_threshold": self.waiting_requests_threshold,
        }
