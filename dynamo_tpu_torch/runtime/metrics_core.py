"""Dependency-free metrics kit — the port's copy of
dynamo_tpu/runtime/metrics_core.py.

Reference parity: lib/runtime/src/metrics (typed Prometheus metrics built
into every runtime component). The port has no prometheus_client (the
card's machine lacks it), so every collector — the HTTP frontend's
(http/metrics.py) included — owns a private ``MetricsRegistry`` and
renders it in the Prometheus text format 0.0.4 or in OpenMetrics.

Exemplar support: histograms accept an optional ``trace_id`` per
observation, rendered OpenMetrics-style (`` # {trace_id="…"} value ts``)
when ``render(openmetrics=True)`` — a dashboard latency spike links to the
request's trace.

Every metric name comes from runtime/metric_names.py.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

LabelKey = Tuple[str, ...]

DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0,
)


def _fmt(v: float) -> str:
    # Prometheus text format: integers render without exponent noise.
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _le(bound: float) -> str:
    # A bucket's ``le`` as prometheus_client writes it (floatToGoString:
    # "5.0", "1e+06"), so the frontend's histograms are queried by the same
    # label values as the JAX frontend's (JAX's own kit writes "5").
    if bound == float("inf"):
        return "+Inf"
    s = repr(float(bound))
    dot = s.find(".")
    if bound > 0 and dot > 6:  # Go switches to exponents sooner than Python
        return f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.") + f"e+0{dot - 1}"
    return s


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(names: Sequence[str], values: LabelKey, extra: str = "") -> str:
    parts = [f'{n}="{_escape(str(v))}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, kwargs: Dict[str, object]) -> LabelKey:
        if set(kwargs) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kwargs)} != declared "
                f"{sorted(self.labelnames)}"
            )
        return tuple(str(kwargs[n]) for n in self.labelnames)

    def render(self, openmetrics: bool = False) -> List[str]:  # pragma: no cover
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()) -> None:
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set_total(self, value: float, **labels: object) -> None:
        """Mirror an externally maintained monotonic total (e.g. TierStats
        counters owned by the storage tier) — used from on_render hooks so
        the legacy attribute stays the single source of truth."""
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def render(self, openmetrics: bool = False) -> List[str]:
        # OpenMetrics keys counter metadata on the family name (sans the
        # mandatory ``_total`` sample suffix); the classic text format keys
        # it on the sample name. Strict parsers reject a TYPE line whose
        # name already carries the suffix.
        family = sample = self.name
        if openmetrics:
            if family.endswith("_total"):
                family = family[: -len("_total")]
            sample = family + "_total"
        lines = [f"# HELP {family} {self.help}", f"# TYPE {family} counter"]
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            lines.append(f"{sample}{_label_str(self.labelnames, key)} {_fmt(v)}")
        return lines


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()) -> None:
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: object) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def render(self, openmetrics: bool = False) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            lines.append(f"{self.name}{_label_str(self.labelnames, key)} {_fmt(v)}")
        return lines


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> None:
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # per label key: ([bucket counts..., +Inf], sum, count)
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sums: Dict[LabelKey, float] = {}
        # (key, bucket index) -> last exemplar (value, trace_id, unix ts)
        self._exemplars: Dict[Tuple[LabelKey, int], Tuple[float, str, float]] = {}

    def observe(
        self, value: float, trace_id: Optional[str] = None, **labels: object
    ) -> None:
        key = self._key(labels)
        v = float(value)
        idx = len(self.buckets)
        for i, b in enumerate(self.buckets):
            if v <= b:
                idx = i
                break
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
            counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + v
            if trace_id:
                self._exemplars[(key, idx)] = (v, str(trace_id), time.time())

    def render(self, openmetrics: bool = False) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
            exemplars = dict(self._exemplars)
        for key, counts in items:
            acc = 0
            for i, bound in enumerate(list(self.buckets) + [float("inf")]):
                acc += counts[i]
                le_label = 'le="' + _le(bound) + '"'
                line = (
                    f"{self.name}_bucket"
                    f"{_label_str(self.labelnames, key, le_label)} {acc}"
                )
                if openmetrics:
                    ex = exemplars.get((key, i))
                    if ex is not None:
                        v, tid, ts = ex
                        line += (
                            f' # {{trace_id="{_escape(tid)}"}} {_fmt(v)} {ts:.3f}'
                        )
                lines.append(line)
            ls = _label_str(self.labelnames, key)
            lines.append(f"{self.name}_sum{ls} {repr(sums.get(key, 0.0))}")
            lines.append(f"{self.name}_count{ls} {acc}")
        return lines


class MetricsRegistry:
    """A private registry: one per subsystem object. ``render()`` is the
    function handed to ``SystemStatusServer.register_metrics``."""

    def __init__(self) -> None:
        self._metrics: List[_Metric] = []
        self._before_render: List[Callable[[], None]] = []

    def counter(self, name: str, help: str, labelnames: Sequence[str] = ()) -> Counter:
        m = Counter(name, help, labelnames)
        self._metrics.append(m)
        return m

    def gauge(self, name: str, help: str, labelnames: Sequence[str] = ()) -> Gauge:
        m = Gauge(name, help, labelnames)
        self._metrics.append(m)
        return m

    def histogram(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        m = Histogram(name, help, labelnames, buckets)
        self._metrics.append(m)
        return m

    def on_render(self, fn: Callable[[], None]) -> None:
        """Register a pre-render hook — gauges sampled from live state
        (scheduler worker loads, tier occupancy) refresh at scrape time."""
        self._before_render.append(fn)

    def render(self, openmetrics: bool = False) -> str:
        for fn in self._before_render:
            try:
                fn()
            except Exception:  # a broken sampler must not break the scrape
                logger.debug("metrics render hook %r failed", fn,
                             exc_info=True)
        lines: List[str] = []
        for m in self._metrics:
            lines.extend(m.render(openmetrics=openmetrics))
        return "\n".join(lines)
