"""Canonical metric names — the port's copy of the entries of
dynamo_tpu/runtime/metric_names.py that the port emits (the engine's stats
gauges, the frontend's, the parser plane's, the crash plane's, the
router's, the KV-reuse plane's, migration's, the overload plane's, the SLO
plane's, the engine step loop's, the perf ledger's and the device plane's
compile, HBM ledger, flight-ring and profiler families), letter
for letter, so that dashboards and scrapers read the port as they read the
JAX package.

Reference parity: lib/runtime/src/metrics/prometheus_names.rs — emitters
import these constants instead of repeating strings.

Naming scheme: ``dynamo_tpu_<subsystem>_<metric>[_unit][_total]``.
"""

from __future__ import annotations

# -- engine stats gauges (runtime/system_server.py engine_stats_prometheus) --
ENGINE_PREFIX = "dynamo_tpu_engine"


def engine_gauge(stat_key: str) -> str:
    """Engine stats-dict key → canonical gauge name (system server)."""
    return f"{ENGINE_PREFIX}_{stat_key}"


# -- engine step loop (engines/metrics.py EngineStepMetrics) -----------------
ENGINE_STEP_DURATION = f"{ENGINE_PREFIX}_step_duration_seconds"
ENGINE_BATCH_OCCUPANCY = f"{ENGINE_PREFIX}_batch_occupancy"
ENGINE_STEP_PREFILL_TOKENS = f"{ENGINE_PREFIX}_prefill_tokens_per_step"
ENGINE_STEP_DECODE_TOKENS = f"{ENGINE_PREFIX}_decode_tokens_per_step"
# Decode-tick pipelining (engines/gpu/engine.py dispatch/reap split):
# host_gap = device wait injected by the host between a burst's readback
# completing and the next dispatch (0 when another burst was already in
# flight); inflight_depth = bursts in flight at each dispatch.
ENGINE_HOST_GAP = f"{ENGINE_PREFIX}_host_gap_seconds"
ENGINE_INFLIGHT_DEPTH = f"{ENGINE_PREFIX}_inflight_depth"


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

# -- device/runtime plane (runtime/device_observe.py) ------------------------
RUNTIME_PREFIX = "dynamo_tpu_runtime"
# Compile telemetry (CompileWatcher): in the port a compile is a CUDA graph
# capture of a decode burst (engines/gpu/runner.py).
RUNTIME_COMPILES_TOTAL = f"{RUNTIME_PREFIX}_compiles_total"
RUNTIME_COMPILE_SIGNATURES = f"{RUNTIME_PREFIX}_compile_signatures"
RUNTIME_COMPILE_SECONDS = f"{RUNTIME_PREFIX}_compile_seconds"
RUNTIME_RECOMPILE_STORMS_TOTAL = f"{RUNTIME_PREFIX}_recompile_storms_total"
# HBM ledger (structural byte accounting + the CUDA allocator's mirror).
RUNTIME_HBM_BYTES = f"{RUNTIME_PREFIX}_hbm_bytes"
RUNTIME_HBM_DEVICE_BYTES = f"{RUNTIME_PREFIX}_hbm_device_bytes"
# On-demand torch.profiler captures (POST /debug/profile).
RUNTIME_PROFILER_CAPTURES_TOTAL = f"{RUNTIME_PREFIX}_profiler_captures_total"
# Flight recorder rings (the perf ledger's "perf" ring on the system server).
RUNTIME_FLIGHT_EVENTS_TOTAL = f"{RUNTIME_PREFIX}_flight_events_total"
RUNTIME_FLIGHT_OVERWRITTEN_TOTAL = f"{RUNTIME_PREFIX}_flight_overwritten_total"

# -- migration (llm/migration.py Migration) ----------------------------------
MIGRATION_PREFIX = "dynamo_tpu_migration"
# Re-dispatches of a live stream to another worker, by failure reason
# (connection | timeout | no_instances | disagg | other).
MIGRATION_MIGRATIONS_TOTAL = f"{MIGRATION_PREFIX}_migrations_total"
# Streams that failed AFTER exhausting the migration budget (attempt
# limit or the re-prefill token cap) — each one reached the client.
MIGRATION_EXHAUSTED_TOTAL = f"{MIGRATION_PREFIX}_exhausted_total"
# Prompt+carried tokens re-prefilled by migrations (the cost the
# re-prefill cap bounds).
MIGRATION_REPREFILL_TOKENS_TOTAL = f"{MIGRATION_PREFIX}_reprefill_tokens_total"

# -- overload plane (runtime/overload.py OverloadController) -----------------
OVERLOAD_PREFIX = "dynamo_tpu_overload"
# Brownout state machine: 0 healthy, 1 brownout (max_tokens clamped,
# speculative decode off), 2 shed (new admissions refused 503).
OVERLOAD_STATE = f"{OVERLOAD_PREFIX}_state"
OVERLOAD_TRANSITIONS_TOTAL = f"{OVERLOAD_PREFIX}_transitions_total"
# Admissions refused, by reason (queue_full | predicted_delay |
# deadline_expired | brownout_shed) — every shed reached a client as a
# typed 429/503/504 + Retry-After.
OVERLOAD_SHED_TOTAL = f"{OVERLOAD_PREFIX}_shed_total"
OVERLOAD_ADMITTED_TOTAL = f"{OVERLOAD_PREFIX}_admitted_total"
# Bounded EDF admission queue: live depth and the wait granted requests
# actually paid (the predicted-delay shed keeps the tail of this
# histogram inside max_queue_delay_s).
OVERLOAD_QUEUE_DEPTH = f"{OVERLOAD_PREFIX}_queue_depth"
OVERLOAD_QUEUE_DELAY = f"{OVERLOAD_PREFIX}_queue_delay_seconds"
# Requests whose deadline expired before admission (dead on arrival or
# expired mid-queue) — shed before any prefill work.
OVERLOAD_DEADLINE_EXPIRED_TOTAL = f"{OVERLOAD_PREFIX}_deadline_expired_total"

# -- perf ledger (runtime/perf_ledger.py PerfLedger) --------------------------
PERF_PREFIX = "dynamo_tpu_perf"
# Rolling-window median step wall time per (width, variant, path) decode
# shape — the always-on attribution the regression sentinel judges.
PERF_STEP_P50_SECONDS = f"{PERF_PREFIX}_step_p50_seconds"
# Rolling-window p99 step wall time per shape — tail drift shows here
# before the median moves.
PERF_STEP_P99_SECONDS = f"{PERF_PREFIX}_step_p99_seconds"
# Rolling-window median host gap (CPU time the device sat idle between
# reap and the next dispatch) per shape.
PERF_HOST_GAP_P50_SECONDS = f"{PERF_PREFIX}_host_gap_p50_seconds"
# Rolling-window median dispatch-side host cost per shape (the portion of
# the step spent building + launching the burst).
PERF_DISPATCH_P50_SECONDS = f"{PERF_PREFIX}_dispatch_p50_seconds"
# Rolling-window median reap-side host cost per shape (readback + state
# update after the burst completed).
PERF_REAP_P50_SECONDS = f"{PERF_PREFIX}_reap_p50_seconds"
# Rolling-window decode throughput (tokens/s) per shape.
PERF_TOKENS_PER_SEC = f"{PERF_PREFIX}_tokens_per_sec"
# Measured tok/s divided by the pure-arithmetic bandwidth roofline
# (runtime/roofline.py) at the window's median occupancy and context —
# 1.0 is the HBM wall.
PERF_ROOFLINE_FRACTION = f"{PERF_PREFIX}_roofline_fraction"
# Rolling-window prefill throughput (tokens/s) per pow2 chunk bucket,
# from the admission loop's per-round stamps.
PERF_PREFILL_TOKENS_PER_SEC = f"{PERF_PREFIX}_prefill_tokens_per_sec"
# Live samples currently inside each shape's rolling window (TTL-pruned);
# verdicts are withheld below the min-sample floor.
PERF_WINDOW_SAMPLES = f"{PERF_PREFIX}_window_samples"
# Typed perf anomalies raised by the sentinel, labeled by kind
# (step_regression | toks_regression).
PERF_ANOMALIES_TOTAL = f"{PERF_PREFIX}_anomalies_total"
# Steady-state fingerprints loaded from the persisted ledger at startup
# (0 on cold start).
PERF_FINGERPRINT_LOADED = f"{PERF_PREFIX}_fingerprints_loaded"
# Fingerprint persistence failures by op (load | store) — a corrupt or
# vanished file degrades to cold start and counts here, never crashes.
PERF_FINGERPRINT_FAILURES_TOTAL = (
    f"{PERF_PREFIX}_fingerprint_failures_total"
)

# -- SLO plane (runtime/trajectory.py SloTracker) -----------------------------
SLO_PREFIX = "dynamo_tpu_slo"
# Rolling-window fraction of finished streams that met BOTH the TTFT and
# ITL SLAs, labeled by window (5m | 60m). 1.0 = every stream inside SLA.
SLO_GOODPUT = f"{SLO_PREFIX}_goodput_ratio"
# Finished streams by SLO verdict (good | breach) — the goodput ratio's
# monotonic source of truth across scrapes.
SLO_STREAMS_TOTAL = f"{SLO_PREFIX}_streams_total"
# Error-budget burn rate per window: breach fraction ÷ (1 − slo_target).
# 1.0 = burning exactly the budget; a multi-window alert fires when BOTH
# the fast and slow windows burn hot (the SRE-workbook shape).
SLO_BURN_RATE = f"{SLO_PREFIX}_burn_rate"
# p99 of each phase's per-request duration over the trajectory window —
# which phase (queue / prefill / kv_transfer / decode / handoff_stall /
# overhead) dominates the tail, as a number a dashboard can rank.
SLO_PHASE_P99_MS = f"{SLO_PREFIX}_phase_p99_contribution_ms"
