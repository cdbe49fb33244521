"""Canonical metric names — the port's copy of the entries of
dynamo_tpu/runtime/metric_names.py that the port emits (the frontend's, the
parser plane's, the crash plane's, the router's and the KV-reuse plane's
families), letter for letter, so that dashboards and
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

# -- crash plane (runtime/liveness.py) ----------------------------------------
LIVENESS_PREFIX = "dynamo_tpu_liveness"
# Per-worker liveness state gauge: 0 alive, 1 suspect, 2 dead.
LIVENESS_WORKER_STATE = f"{LIVENESS_PREFIX}_worker_state"
# Last-report-to-declared-dead latency (bounded by dead_after x interval).
LIVENESS_DETECTION_SECONDS = f"{LIVENESS_PREFIX}_detection_seconds"
# Packets from a prior worker incarnation dropped (never applied), by seam.
LIVENESS_STALE_DROPS_TOTAL = (
    f"{LIVENESS_PREFIX}_stale_incarnation_drops_total"
)
# Warm-restart KV checkpoint restore duration and outcomes.
LIVENESS_RESTORE_SECONDS = f"{LIVENESS_PREFIX}_restore_seconds"
LIVENESS_RESTORE_OUTCOME_TOTAL = f"{LIVENESS_PREFIX}_restore_outcome_total"

# -- router (router/router.py KvRouter + router/scheduler.py) ----------------
ROUTER_PREFIX = "dynamo_tpu_router"
ROUTER_DECISIONS_TOTAL = f"{ROUTER_PREFIX}_decisions_total"
ROUTER_OVERLAP_BLOCKS = f"{ROUTER_PREFIX}_overlap_blocks"
ROUTER_WORKER_LOAD_BLOCKS = f"{ROUTER_PREFIX}_worker_load_blocks"
ROUTER_WORKER_KV_USAGE = f"{ROUTER_PREFIX}_worker_kv_usage"
ROUTER_KV_EVENTS_TOTAL = f"{ROUTER_PREFIX}_kv_events_total"
# Link-cost model input: EWMA transfer bandwidth per (src prefill worker,
# dst decode worker) pair, as the scheduler's select_worker sees it.
ROUTER_LINK_BANDWIDTH = f"{ROUTER_PREFIX}_link_bandwidth_bytes_per_s"

# -- KV-reuse plane (runtime/kv_reuse_observe.py KvReusePlane) ----------------
KVCACHE_PREFIX = "dynamo_tpu_kvcache"
# Prefix-cache hits by the tier the hit resolved from (device | host |
# disk | remote) and requests that found no cached prefix at all. The
# hit-rate gauge is the render-time ratio of these monotonic sources.
KVCACHE_HITS_TOTAL = f"{KVCACHE_PREFIX}_hits_total"
KVCACHE_MISSES_TOTAL = f"{KVCACHE_PREFIX}_misses_total"
KVCACHE_HIT_RATE = f"{KVCACHE_PREFIX}_hit_rate"
# Cache ROI: prefill tokens served from cache vs recomputed, and the
# estimated prefill seconds the cache saved (cached tokens x EWMA
# per-token prefill cost — the same number stamped per-request onto the
# trajectory rollup).
KVCACHE_REUSED_TOKENS_TOTAL = f"{KVCACHE_PREFIX}_reused_prefill_tokens_total"
KVCACHE_RECOMPUTED_TOKENS_TOTAL = (
    f"{KVCACHE_PREFIX}_recomputed_prefill_tokens_total"
)
KVCACHE_PREFILL_SECONDS_SAVED_TOTAL = (
    f"{KVCACHE_PREFIX}_prefill_seconds_saved_total"
)
KVCACHE_PREFILL_COST_PER_TOKEN = (
    f"{KVCACHE_PREFIX}_prefill_cost_per_token_seconds"
)
# Space-saving popularity sketch: live tracked-prefix count (bounded by
# capacity by construction), min-replacements (sketch churn under a
# heavy-tailed workload), and the p99 sketch lookup latency recorded by
# the scale harness (tests/test_kv_reuse_scale.py).
KVCACHE_SKETCH_TRACKED_PREFIXES = f"{KVCACHE_PREFIX}_sketch_tracked_prefixes"
KVCACHE_SKETCH_REPLACEMENTS_TOTAL = (
    f"{KVCACHE_PREFIX}_sketch_replacements_total"
)
KVCACHE_SKETCH_LOOKUP_P99_SECONDS = (
    f"{KVCACHE_PREFIX}_sketch_lookup_p99_seconds"
)
# Tier evictions by (tier, reason): arena_full (straight spill past a
# full pinned arena) | capacity (LRU overflow) | corrupt (CRC drop on
# read-back). Mirrors kvbm_tier_evictions_total with the reason split the
# popularity-eviction follow-on acts on.
KVCACHE_EVICTIONS_TOTAL = f"{KVCACHE_PREFIX}_evictions_total"
