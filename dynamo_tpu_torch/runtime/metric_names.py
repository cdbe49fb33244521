"""Canonical metric names — the port's copy of the entries of
dynamo_tpu/runtime/metric_names.py that the port emits (the frontend's and
the parser plane's families), letter for letter, so that dashboards and
scrapers read the port as they read the JAX package.

Reference parity: lib/runtime/src/metrics/prometheus_names.rs — emitters
import these constants instead of repeating strings.

Naming scheme: ``dynamo_tpu_<subsystem>_<metric>[_unit][_total]``.
"""

from __future__ import annotations

# -- frontend (http/metrics.py) ---------------------------------------------
FRONTEND_PREFIX = "dynamo_tpu_frontend"
FRONTEND_REQUESTS_TOTAL = f"{FRONTEND_PREFIX}_requests_total"
FRONTEND_INFLIGHT = f"{FRONTEND_PREFIX}_inflight_requests"
FRONTEND_REQUEST_DURATION = f"{FRONTEND_PREFIX}_request_duration_seconds"
FRONTEND_TTFT = f"{FRONTEND_PREFIX}_time_to_first_token_seconds"
FRONTEND_ITL = f"{FRONTEND_PREFIX}_inter_token_latency_seconds"
FRONTEND_OUTPUT_TOKENS_TOTAL = f"{FRONTEND_PREFIX}_output_tokens_total"
FRONTEND_INPUT_TOKENS_TOTAL = f"{FRONTEND_PREFIX}_input_tokens_total"

# -- parser plane (parsers/observe.py ParserPlane) ----------------------------
PARSER_PREFIX = "dynamo_tpu_parser"
# Tool calls fully streamed through the incremental jail, by dialect.
PARSER_TOOL_CALLS_TOTAL = f"{PARSER_PREFIX}_tool_calls_total"
# Argument-delta characters emitted while the call was still being
# generated — the incremental jail's reason to exist (the old jail held
# every argument byte until stream end).
PARSER_ARGS_DELTA_CHARS_TOTAL = f"{PARSER_PREFIX}_args_delta_chars_total"
# Degradation-ladder activations by dialect and reason (truncated |
# bad_nesting | drift | buffer_cap | ...) — a malformed call sealed or
# returned to content, never a dropped stream.
PARSER_DEGRADED_CALLS_TOTAL = f"{PARSER_PREFIX}_degraded_calls_total"
# Calls whose argument string was unparseable and shipped as a lossy
# {"__raw__": ...} wrap (tool_calling._normalize and its streaming twin);
# the emitted call carries degraded=true so clients and the SLO plane can
# see lossy parses.
PARSER_DEGRADED_ARGS_TOTAL = f"{PARSER_PREFIX}_degraded_args_total"
# Parser BUGS (not malformed model output): each surfaced as a terminal
# typed SSE error frame (error_kind=tool_call_parse).
PARSER_EXCEPTIONS_TOTAL = f"{PARSER_PREFIX}_exceptions_total"
# Tool-enabled streams through the jail by outcome (clean | degraded |
# error).
PARSER_STREAMS_TOTAL = f"{PARSER_PREFIX}_streams_total"
# Peak jailed-buffer size (chars) — bounded by the jail's buffer cap.
PARSER_JAIL_BUFFERED_PEAK_CHARS = (
    f"{PARSER_PREFIX}_jail_buffered_peak_chars"
)
