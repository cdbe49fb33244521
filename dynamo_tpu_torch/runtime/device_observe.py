"""Flight recorder — the port's copy of ``FlightRecorder`` from
dynamo_tpu/runtime/device_observe.py, the one part of that module the
port reads (the parser plane's ``parser`` ring, parsers/observe.py). The
ring's own metric families render on the system server, which comes with
the distributed runtime.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple


class FlightRecorder:
    """Preallocated single-writer ring of typed events.

    Contract: ``record`` is called from EXACTLY ONE thread per recorder;
    readers (``snapshot``) may run on any thread and tolerate a
    concurrently advancing write index — a torn read can at worst miss or
    double-see the newest event, never corrupt the ring. Append is an
    index store + tuple build: O(1), no locks, no list growth."""

    def __init__(self, name: str, capacity: int = 2048) -> None:
        self.name = name
        self.capacity = int(capacity)
        self._ring: List[Optional[Tuple[float, str, Optional[dict]]]] = (
            [None] * self.capacity
        )
        self._n = 0  # total events ever recorded (monotonic)

    def record(self, kind: str, **fields: Any) -> None:
        i = self._n
        self._ring[i % self.capacity] = (
            time.monotonic(), kind, fields or None
        )
        self._n = i + 1

    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Events oldest→newest as dicts (``seq`` is the global event
        index, ``t_mono`` the monotonic timestamp)."""
        n = self._n
        start = max(0, n - self.capacity)
        if limit is not None:
            start = max(start, n - int(limit))
        out: List[Dict[str, Any]] = []
        for i in range(start, n):
            ev = self._ring[i % self.capacity]
            if ev is None:
                continue
            ts, kind, fields = ev
            d: Dict[str, Any] = {
                "seq": i, "t_mono": round(ts, 6), "ring": self.name,
                "kind": kind,
            }
            if fields:
                d.update(fields)
            out.append(d)
        return out
