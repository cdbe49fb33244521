"""Frontend request metrics — the port of dynamo_tpu/http/metrics.py over
the dependency-free kit (runtime/metrics_core.py) in place of
prometheus_client, which the card's machine lacks: the same families,
label names and buckets.

Reference parity: lib/llm/src/http/service/metrics.rs (request counters,
TTFT/ITL/duration histograms, in-flight gauges) with the canonical naming
scheme of lib/runtime/src/metrics/prometheus_names.rs.

Exemplars: the TTFT and request-duration histograms carry the request's
trace id (from the request's ``traceparent``) as an OpenMetrics exemplar
— rendered when the scraper negotiates ``application/openmetrics-text``.

Each finished stream also gives the SLO plane its verdict
(runtime/trajectory.py ``SloTracker.note_stream``), and an optional
``itl_observer`` taps the ITL deltas (the overload controller's brownout
signal).
"""

from __future__ import annotations

import re
import time
from typing import Any, Callable, Optional

from dynamo_tpu_torch.runtime import metric_names as mn
from dynamo_tpu_torch.runtime.metrics_core import MetricsRegistry

_SECONDS_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0,
)

# W3C trace context (dynamo_tpu/utils/tracing.py TRACEPARENT_RE).
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def trace_id_of(context: Any) -> Optional[str]:
    """The trace id of a Context's ``traceparent`` baggage, or None when it
    has none or it is malformed (all-zero ids are invalid)."""
    header = (getattr(context, "baggage", None) or {}).get("traceparent")
    m = _TRACEPARENT_RE.match(header.strip().lower()) if header else None
    if not m or m.group(2) == "0" * 32 or m.group(3) == "0" * 16:
        return None
    return m.group(2)


class FrontendMetrics:
    def __init__(self) -> None:
        self.registry = MetricsRegistry()
        self.requests_total = self.registry.counter(
            mn.FRONTEND_REQUESTS_TOTAL,
            "HTTP requests by model/endpoint/status",
            ["model", "endpoint", "status"],
        )
        self.inflight = self.registry.gauge(
            mn.FRONTEND_INFLIGHT,
            "Currently executing requests",
            ["model", "endpoint"],
        )
        self.request_duration = self.registry.histogram(
            mn.FRONTEND_REQUEST_DURATION,
            "End-to-end request duration",
            ["model", "endpoint"],
            buckets=_SECONDS_BUCKETS,
        )
        self.ttft = self.registry.histogram(
            mn.FRONTEND_TTFT,
            "Time to first token (streaming requests)",
            ["model"],
            buckets=_SECONDS_BUCKETS,
        )
        self.itl = self.registry.histogram(
            mn.FRONTEND_ITL,
            "Latency between streamed tokens",
            ["model"],
            buckets=_SECONDS_BUCKETS,
        )
        self.output_tokens = self.registry.counter(
            mn.FRONTEND_OUTPUT_TOKENS_TOTAL,
            "Generated tokens",
            ["model"],
        )
        self.input_tokens = self.registry.counter(
            mn.FRONTEND_INPUT_TOKENS_TOTAL,
            "Prompt tokens",
            ["model"],
        )

    def render(self, openmetrics: bool = False) -> bytes:
        """Text format 0.0.4, or OpenMetrics (with exemplars) ending in
        ``# EOF``."""
        body = self.registry.render(openmetrics=openmetrics) + "\n"
        if openmetrics:
            body += "# EOF\n"
        return body.encode()


class RequestTimer:
    """Per-request observation helper feeding FrontendMetrics.

    ``bind_context`` attaches the request's trace id — from then on
    TTFT/duration observations carry it as an exemplar."""

    def __init__(
        self, metrics: FrontendMetrics, model: str, endpoint: str,
        *, itl_observer: Optional[Callable[[float], None]] = None,
    ) -> None:
        self._m = metrics
        self._model = model
        self._endpoint = endpoint
        self._start = time.monotonic()
        self._last_token: Optional[float] = None
        self._done = False
        self._trace_id: Optional[str] = None
        # SLO inputs (runtime/trajectory.py SloTracker): the stream's TTFT
        # and summed ITL deltas, judged once at done().
        self._ttft_s: Optional[float] = None
        self._itl_sum = 0.0
        self._itl_n = 0
        # Optional tap on the same deltas the ITL histogram observes —
        # the overload controller's brownout machine reads its p50 SLA
        # signal here (runtime/overload.py observe_itl).
        self._itl_observer = itl_observer
        self._m.inflight.inc(model=model, endpoint=endpoint)

    def bind_context(self, context) -> None:
        """Adopt the trace of a runtime Context whose baggage carries a
        traceparent."""
        self._trace_id = trace_id_of(context)

    def on_token(self, count: int = 1) -> None:
        now = time.monotonic()
        if self._last_token is None:
            self._ttft_s = now - self._start
            self._m.ttft.observe(now - self._start, trace_id=self._trace_id,
                                 model=self._model)
        else:
            self._itl_sum += now - self._last_token
            self._itl_n += 1
            self._m.itl.observe(now - self._last_token, model=self._model)
            if self._itl_observer is not None:
                self._itl_observer(now - self._last_token)
        self._last_token = now
        self._m.output_tokens.inc(count, model=self._model)

    def count_tokens(self, count: int) -> None:
        """Output-token accounting WITHOUT latency observations — secondary
        n>1 choice streams would corrupt TTFT/ITL with cross-stream deltas."""
        self._m.output_tokens.inc(count, model=self._model)

    def on_input_tokens(self, count: int) -> None:
        self._m.input_tokens.inc(count, model=self._model)

    def done(self, status: int) -> None:
        if self._done:  # idempotent: double-finish must not skew gauges
            return
        self._done = True
        self._m.inflight.inc(-1, model=self._model, endpoint=self._endpoint)
        self._m.requests_total.inc(model=self._model, endpoint=self._endpoint,
                                   status=str(status))
        self._m.request_duration.observe(
            time.monotonic() - self._start, trace_id=self._trace_id,
            model=self._model, endpoint=self._endpoint,
        )
        if status != 499 and (self._ttft_s is not None or status >= 429):
            # SLO verdict (no-op while no SLA is configured): one stream,
            # did TTFT and mean ITL land inside the SLA. Token-less
            # failures count too — sheds (429/503/504) and errors never
            # met the SLA. Token-less 2xx stay out: they have no latency
            # SLA. Client aborts (499) stay out entirely — a user walking
            # away says nothing about the server's SLA.
            from dynamo_tpu_torch.runtime.trajectory import global_slo

            global_slo().note_stream(
                self._trace_id,
                ttft_s=self._ttft_s,
                mean_itl_s=(
                    self._itl_sum / self._itl_n if self._itl_n else None
                ),
                status=status,
            )
