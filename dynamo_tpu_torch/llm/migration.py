"""Migration operator: re-dispatch a live request when its worker dies —
the port's copy of dynamo_tpu/llm/migration.py (the JAX module's
``try/except ImportError`` stand-ins are the port's real classes here).

Reference parity: lib/llm/src/migration.rs:24 (Migration) + docs/
fault_tolerance/request_migration.md — when the response stream dies mid-
generation (worker crash, connection loss, no instances), rebuild the
PreprocessedRequest with the tokens accumulated so far appended to the
prompt, and send it to another worker, up to ``migration_limit`` times. The
new worker's prefix cache makes the re-prefill cheap; the client stream never
observes the failure.

Two budgets bound a pathological loop:

  * ``migration_limit`` — attempt count (the reference's knob);
  * ``max_reprefill_tokens`` — TOTAL prompt+carried tokens re-prefilled
    across all migrations of one stream. Attempt counts alone don't bound
    cost: a 100k-token prompt that dies late in generation re-prefills
    prompt+tail every time, so three "cheap" retries can cost more compute
    than the request itself. The token cap prices the retries in the unit
    that matters.

Covered failure classes (``MIGRATABLE``): transport disconnects, vanished
instances, connection errors, deadline/timeout aborts (the disagg pull
timeout surfaces here), and mid-disagg transfer failures
(``DisaggTransferError`` from a strict decode handler — it subclasses
ConnectionError, imported here only to label the metric reason).

Every migration emits a flight-recorder event and a
``dynamo_tpu_migration_*`` metric (runtime/metric_names.py MIGRATION_*).
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator, List, Optional, Union

from dynamo_tpu_torch import config
from dynamo_tpu_torch.disagg.errors import DisaggTransferError
from dynamo_tpu_torch.llm.protocols.common import (
    BackendOutput,
    FinishReason,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime import metric_names as mn
from dynamo_tpu_torch.runtime.component import NoInstancesError
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.device_observe import FlightRecorder
from dynamo_tpu_torch.runtime.drain import WorkerDrainingError
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.faults import note_activity
from dynamo_tpu_torch.runtime.liveness import WorkerLostError
from dynamo_tpu_torch.runtime.metrics_core import MetricsRegistry
from dynamo_tpu_torch.runtime.network.tcp import StreamDisconnectedError
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


# NOTE: asyncio.TimeoutError is a DISTINCT class from builtin TimeoutError
# until Python 3.11 — both must be listed. DisaggTransferError subclasses
# ConnectionError (already migratable); it is named for reason labeling.
MIGRATABLE = (
    StreamDisconnectedError,
    NoInstancesError,
    ConnectionError,
    TimeoutError,
    asyncio.TimeoutError,
)

# Default total re-prefill budget across all migrations of one stream.
DEFAULT_REPREFILL_CAP = config.MIGRATION_REPREFILL_CAP.get()


def _failure_reason(exc: BaseException) -> str:
    """Metric label for what killed the stream."""
    if isinstance(exc, WorkerDrainingError):
        # Planned churn (rolling restart / scale-down), not a fault: the
        # worker refused or handed back the stream while draining.
        return "drain"
    if isinstance(exc, WorkerLostError):
        # The crash plane declared the worker dead (missed load reports)
        # and aborted the stream proactively — faster than any transport
        # error would have surfaced.
        return "worker_lost"
    if isinstance(exc, DisaggTransferError):
        return "disagg"
    if isinstance(exc, NoInstancesError):
        return "no_instances"
    if isinstance(exc, (TimeoutError, asyncio.TimeoutError)):
        return "timeout"
    if isinstance(exc, ConnectionError):
        return "connection"
    return "other"


class MigrationMetrics:
    """Canonical migration families (runtime/metric_names.py
    MIGRATION_*). ``render`` plugs into SystemStatusServer's
    ``register_metrics`` seam; ``registry`` puts the families on one that
    is rendered already (the frontend main passes its HttpService's)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = MetricsRegistry() if registry is None else registry
        self.migrations = self.registry.counter(
            mn.MIGRATION_MIGRATIONS_TOTAL,
            "Live streams re-dispatched to another worker, by failure "
            "reason",
            ["reason"],
        )
        self.exhausted = self.registry.counter(
            mn.MIGRATION_EXHAUSTED_TOTAL,
            "Streams failed after exhausting the migration budget "
            "(attempt limit or re-prefill token cap) — each one reached "
            "the client as an error",
        )
        self.reprefill_tokens = self.registry.counter(
            mn.MIGRATION_REPREFILL_TOKENS_TOTAL,
            "Prompt+carried tokens re-prefilled by migrations (the cost "
            "the re-prefill cap bounds)",
        )

    def render(self, openmetrics: bool = False) -> str:
        return self.registry.render(openmetrics=openmetrics)


class Migration:
    def __init__(
        self,
        migration_limit: int = 3,
        *,
        max_reprefill_tokens: Optional[int] = DEFAULT_REPREFILL_CAP,
    ) -> None:
        self.migration_limit = migration_limit
        # None = uncapped (attempt count only — the pre-cap behavior).
        self.max_reprefill_tokens = max_reprefill_tokens
        self.metrics = MigrationMetrics()
        # Migration history for post-mortems (DYN005 owner "migration";
        # single writer: the frontend pipeline's event loop).
        self.flight = FlightRecorder("migration", capacity=256)

    def register_metrics(self, server: Any) -> None:
        server.register_metrics(self.metrics.render)
        server.register_flight(self.flight.name, self.flight.snapshot)

    async def generate(
        self, request: Any, context: Context, next: AsyncEngine
    ) -> AsyncIterator[Union[BackendOutput, dict]]:
        if isinstance(request, PreprocessedRequest):
            req = request
        else:
            req = PreprocessedRequest.from_dict(dict(request))
        generated: List[int] = []
        migrations = 0
        reprefilled = 0  # total tokens re-prefilled by migrations so far
        # Trajectory handoff_stall accounting: a re-dispatch's stall runs
        # from the failure to the first item the NEW worker streams.
        stall_from: Optional[float] = None
        stall_reason = ""

        while True:
            finished = False
            try:
                async for item in next.generate(_as_wire(request, req), context):
                    if stall_from is not None:
                        self._export_redispatch_span(
                            context, stall_from, stall_reason, migrations
                        )
                        stall_from = None
                    tokens = _tokens_of(item)
                    if tokens:
                        generated.extend(tokens)
                    yield item
                    if _finish_reason_of(item) is not None:
                        finished = True
                return
            except MIGRATABLE as exc:
                if finished or context.stopped:
                    return
                migrations += 1
                # The rebuilt request re-prefills its whole prompt plus
                # everything generated so far — charge it BEFORE
                # dispatching so the cap is a true bound, not a postmortem.
                next_reprefill = len(req.token_ids) + len(generated)
                reason = _failure_reason(exc)
                if migrations > self.migration_limit or (
                    self.max_reprefill_tokens is not None
                    and reprefilled + next_reprefill
                    > self.max_reprefill_tokens
                ):
                    over_cap = migrations <= self.migration_limit
                    self.metrics.exhausted.inc()
                    self.flight.record(
                        "exhausted", request=req.request_id, reason=reason,
                        migrations=migrations - 1,
                        reprefilled=reprefilled,
                        over=("reprefill_cap" if over_cap else "attempts"),
                    )
                    logger.error(
                        "request %s exceeded migration budget (%s; %d "
                        "attempts, %d tokens re-prefilled): %r",
                        req.request_id,
                        "re-prefill cap" if over_cap else "attempt limit",
                        migrations - 1, reprefilled, exc,
                    )
                    detail = (
                        f"{reprefilled} re-prefilled tokens (cap "
                        f"{self.max_reprefill_tokens})"
                        if over_cap
                        else f"{self.migration_limit} migrations"
                    )
                    # Typed terminal error: the frontend renders the kind
                    # as a structured SSE error event / JSON error_kind
                    # instead of a bare 500 (http/service.py taxonomy).
                    yield BackendOutput(
                        error=f"stream failed after {detail}: {exc}",
                        error_kind=reason,
                        finish_reason=FinishReason.ERROR,
                    )
                    return
                reprefilled += next_reprefill
                self.metrics.migrations.inc(reason=reason)
                self.metrics.reprefill_tokens.inc(next_reprefill)
                note_activity("migrations")
                self.flight.record(
                    "migrate", request=req.request_id, attempt=migrations,
                    reason=reason, carried=len(generated),
                    reprefill=next_reprefill,
                )
                logger.warning(
                    "migrating request %s (attempt %d/%d, %s) after %r "
                    "with %d tokens carried",
                    req.request_id, migrations, self.migration_limit,
                    reason, exc, len(generated),
                )
                if stall_from is None:
                    import time as _time

                    stall_from = _time.monotonic()
                    stall_reason = reason
                req = _carry_tokens(req, generated)
                generated = []  # now embedded in the prompt; don't carry twice
                request = req  # from now on send the rebuilt request

    def _export_redispatch_span(
        self, context: Context, start_mono: float, reason: str, attempt: int,
    ) -> None:
        """Trajectory handoff_stall span for one migration re-dispatch:
        stream death → first token from the new worker."""
        if not context.baggage.get("traceparent"):
            return
        try:
            from dynamo_tpu_torch.utils.tracing import export_span

            export_span(
                "migration.redispatch", context, start_mono=start_mono,
                reason=reason, attempt=attempt,
            )
        except Exception:
            logger.debug("migration span export failed", exc_info=True)

    # Streams that end without any finish reason (worker vanished without an
    # exception) are NOT retried here: the transport layer is responsible for
    # surfacing disconnects as exceptions (tcp.py StreamDisconnectedError).


def _carry_tokens(req: PreprocessedRequest, generated: List[int]) -> PreprocessedRequest:
    """New request whose prompt embeds everything generated so far
    (ref: migration.rs retained-token re-dispatch)."""
    d = req.to_dict()
    d["token_ids"] = list(req.token_ids) + list(generated)
    new = PreprocessedRequest.from_dict(d)
    if new.stop.max_tokens is not None:
        new.stop.max_tokens = max(new.stop.max_tokens - len(generated), 1)
    if new.stop.min_tokens is not None:
        new.stop.min_tokens = max(new.stop.min_tokens - len(generated), 0)
    return new


def _as_wire(original: Any, req: PreprocessedRequest) -> Any:
    """Preserve the caller's representation (dict over the wire, object locally)."""
    return req.to_dict() if isinstance(original, dict) else req


def _tokens_of(item: Any) -> List[int]:
    if isinstance(item, dict):
        return item.get("token_ids") or []
    return getattr(item, "token_ids", None) or []


def _finish_reason_of(item: Any):
    if isinstance(item, dict):
        return item.get("finish_reason")
    return getattr(item, "finish_reason", None)
