"""Per-adapter load tracking → desired replica counts.
The port's copy of dynamo_tpu/lora/load_estimator.py (framework-free).

Reference parity: lib/llm/src/lora/load_estimator.rs (LoadEstimator —
increment/decrement on request start/end, bounded time series per adapter,
current-load snapshots feeding the allocator's replica decisions).
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class LoadEstimatorConfig:
    """(ref: load_estimator.rs LoadEstimatorConfig)"""

    max_samples: int = 120  # bounded history per adapter
    sample_interval_s: float = 1.0
    # concurrency one replica handles before another is warranted
    per_replica_capacity: float = 4.0
    max_replicas: int = 8


@dataclass
class LoadSample:
    ts: float
    active: int


class LoadEstimator:
    def __init__(self, config: LoadEstimatorConfig = LoadEstimatorConfig()) -> None:
        self.config = config
        self._active: Dict[str, int] = {}
        self._series: Dict[str, List[LoadSample]] = {}
        self._lock = threading.Lock()

    # -- accounting (request lifecycle hooks) -------------------------------

    def increment(self, lora_name: str) -> None:
        with self._lock:
            self._active[lora_name] = self._active.get(lora_name, 0) + 1
            self._record_locked(lora_name)

    def decrement(self, lora_name: str) -> None:
        with self._lock:
            n = self._active.get(lora_name, 0)
            if n <= 1:
                self._active.pop(lora_name, None)
            else:
                self._active[lora_name] = n - 1
            self._record_locked(lora_name)

    def _record_locked(self, lora_name: str) -> None:
        series = self._series.setdefault(lora_name, [])
        series.append(LoadSample(time.monotonic(), self._active.get(lora_name, 0)))
        if len(series) > self.config.max_samples:
            del series[: len(series) - self.config.max_samples]

    # -- queries ------------------------------------------------------------

    def current_load(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._active)

    def time_series(self, lora_name: str) -> List[Tuple[float, int]]:
        with self._lock:
            return [(s.ts, s.active) for s in self._series.get(lora_name, [])]

    def peak_load(self, lora_name: str, window_s: float = 60.0) -> int:
        cutoff = time.monotonic() - window_s
        with self._lock:
            samples = self._series.get(lora_name, [])
            return max((s.active for s in samples if s.ts >= cutoff), default=0)

    def desired_replicas(self) -> Dict[str, int]:
        """Replica targets from recent peak concurrency per adapter."""
        out: Dict[str, int] = {}
        with self._lock:
            names = set(self._series)
        for name in names:
            peak = self.peak_load(name)
            n = math.ceil(peak / self.config.per_replica_capacity) if peak else 1
            out[name] = min(max(n, 1), self.config.max_replicas)
        return out
