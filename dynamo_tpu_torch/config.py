"""Environment knobs the port reads — copies of the JAX package's entries
in dynamo_tpu/config.py, with the same names, defaults and parsing: a
knob's value is read from the environment when ``get()`` is called, and an
unset or unparsable value gives the default."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class EnvVar:
    name: str
    default: Any
    parser: Callable[[str], Any]
    doc: str

    def get(self) -> Any:
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        try:
            return self.parser(raw)
        except (ValueError, TypeError):
            return self.default


def _parse_bool(raw: str) -> bool:
    return raw.strip().lower() in ("1", "true", "yes", "on")


NAMESPACE = EnvVar(
    "DYN_TPU_NAMESPACE", "dynamo", str,
    "Default namespace for components (dynamo_tpu/config.py:118)",
)
HTTP_HOST = EnvVar(
    "DYN_TPU_HTTP_HOST", "0.0.0.0", str,
    "Frontend HTTP bind host (dynamo_tpu/config.py:192)",
)
HTTP_PORT = EnvVar(
    "DYN_TPU_HTTP_PORT", 8000, int,
    "Frontend HTTP bind port (dynamo_tpu/config.py:196)",
)
SYSTEM_PORT = EnvVar(
    "DYN_TPU_SYSTEM_PORT", 9090, int,
    "System status server port (/health /live /metrics) (dynamo_tpu/config.py:200)",
)
ROUTER_TEMPERATURE = EnvVar(
    "DYN_TPU_ROUTER_TEMPERATURE", 0.0, float,
    "KV router softmax sampling temperature (0 = argmin) "
    "(dynamo_tpu/config.py:205)",
)
ROUTER_OVERLAP_WEIGHT = EnvVar(
    "DYN_TPU_ROUTER_OVERLAP_WEIGHT", 1.0, float,
    "KV router overlap score weight (dynamo_tpu/config.py:210)",
)
MIGRATION_LIMIT = EnvVar(
    "DYN_TPU_MIGRATION_LIMIT", 3, int,
    "Max per-request migrations to new workers on stream death "
    "(dynamo_tpu/config.py:214)",
)
MIGRATION_REPREFILL_CAP = EnvVar(
    "DYN_TPU_MIGRATION_REPREFILL_CAP", 131072, int,
    "Total re-prefill token budget across all migrations of one stream "
    "(caps the work a flapping worker set can burn per request) "
    "(dynamo_tpu/config.py:219)",
)
KV_QUANT_AUTO_CTX = EnvVar(
    "DYN_TPU_KV_QUANT_AUTO_CTX", 512, int,
    "kv_cache_dtype='auto': quantize the KV cache to int8 when max_model_len "
    "reaches this (dynamo_tpu/config.py:153)",
)
KV_BLOCK_SIZE = EnvVar(
    "DYN_TPU_KV_BLOCK_SIZE", 16, int,
    "KV cache block size in tokens (`cli run --block-size` default; "
    "dynamo_tpu/config.py:170)",
)
LOG_LEVEL = EnvVar(
    "DYN_TPU_LOG", "info", str,
    "Log level (trace|debug|info|warn|error) (dynamo_tpu/config.py:184)",
)
LOG_JSON = EnvVar(
    "DYN_TPU_LOG_JSON", False, _parse_bool,
    "Emit JSONL structured logs (dynamo_tpu/config.py:188)",
)
TOOL_JAIL_CAP_CHARS = EnvVar(
    "DYN_TPU_TOOL_JAIL_CAP_CHARS", 262144, int,
    "Tool-call jail unresolved-buffer cap (chars): generous for real calls, "
    "small enough that a marker bomb cannot balloon host RSS "
    "(dynamo_tpu/config.py:225)",
)
AUDIT_POLICY = EnvVar(
    "DYN_TPU_AUDIT", "off", str,
    "Request auditing: off | stderr | file:<path> (JSONL records) "
    "(dynamo_tpu/config.py:468)",
)
REQUEST_PLANE = EnvVar(
    "DYN_TPU_REQUEST_PLANE", "tcp", str,
    "Request plane for cross-process serving: tcp|http|local; the port has "
    "no http plane yet and raises for it (dynamo_tpu/config.py:122)",
)
DISCOVERY = EnvVar(
    "DYN_TPU_DISCOVERY", "memory", str,
    "Discovery backend: memory|file|discd (addr via DYN_TPU_DISCOVERY_ADDR) "
    "(dynamo_tpu/config.py:127)",
)
DISCOVERY_ADDR = EnvVar(
    "DYN_TPU_DISCOVERY_ADDR", "127.0.0.1:6180", str,
    "discd service address or file-backend directory (dynamo_tpu/config.py:132)",
)
EVENT_PLANE = EnvVar(
    "DYN_TPU_EVENT_PLANE", "zmq", str,
    "Event plane: memory|zmq; zmq names the wire (ZMTP), which the port "
    "speaks without pyzmq (dynamo_tpu/config.py:137)",
)
EVENT_PLANE_ADDR = EnvVar(
    "DYN_TPU_EVENT_PLANE_ADDR", "127.0.0.1:6181:6182", str,
    "Event broker address host:xsub_port:xpub_port (dynamo_tpu/config.py:141)",
)
TCP_HOST = EnvVar(
    "DYN_TPU_TCP_HOST", "127.0.0.1", str,
    "Advertised host for the TCP request plane (dynamo_tpu/config.py:147)",
)
LEASE_TTL = EnvVar(
    "DYN_TPU_LEASE_TTL", 10.0, float,
    "Discovery lease TTL seconds (dynamo_tpu/config.py:152)",
)
LOAD_REPORT_INTERVAL_S = EnvVar(
    "DYN_TPU_LOAD_REPORT_INTERVAL_S", 1.0, float,
    "Worker load-report publish cadence (router/publisher.py LoadPublisher); "
    "the liveness detection budget is denominated in these intervals "
    "(dynamo_tpu/config.py:348)",
)
LIVENESS_INTERVAL_S = EnvVar(
    "DYN_TPU_LIVENESS_INTERVAL_S", 1.0, float,
    "Expected worker load-report cadence the frontend's liveness tracker "
    "judges missed intervals against (match the LoadPublisher interval) "
    "(dynamo_tpu/config.py:355)",
)
LIVENESS_SUSPECT_AFTER = EnvVar(
    "DYN_TPU_LIVENESS_SUSPECT_AFTER", 2, int,
    "Missed load-report intervals before a worker is SUSPECT "
    "(dynamo_tpu/config.py:361)",
)
LIVENESS_DEAD_AFTER = EnvVar(
    "DYN_TPU_LIVENESS_DEAD_AFTER", 5, int,
    "Missed load-report intervals before a worker is DEAD: drop_worker "
    "reconciliation runs and its in-flight streams abort into migration "
    "(detection-to-migration is bounded by dead_after x interval) "
    "(dynamo_tpu/config.py:366)",
)
WORKER_ID = EnvVar(
    "DYN_TPU_WORKER_ID", 0, int,
    "Stable worker identity across restarts (0 = random per start). A "
    "restarted worker re-registers under the SAME id with a fresh "
    "incarnation so warm rejoin and incarnation fencing line up "
    "(dynamo_tpu/config.py:373)",
)
GRACE_PERIOD = EnvVar(
    "DYN_TPU_GRACE_PERIOD", 30.0, float,
    "Graceful-shutdown drain seconds (dynamo_tpu/config.py:380)",
)
SLOW_REQUEST_S = EnvVar(
    "DYN_TPU_SLOW_REQUEST_S", 30.0, float,
    "Requests slower than this (seconds, received to done) are retained in "
    "the slow-request capture ring (dynamo_tpu/config.py:437)",
)
LIFECYCLE_RECENT = EnvVar(
    "DYN_TPU_LIFECYCLE_RECENT", 256, int,
    "Recent-request timelines retained (dynamo_tpu/config.py:443)",
)
LIFECYCLE_SLOW = EnvVar(
    "DYN_TPU_LIFECYCLE_SLOW", 64, int,
    "Slow-request timelines retained past recent-ring eviction "
    "(dynamo_tpu/config.py:448)",
)
KV_SKETCH_CAPACITY = EnvVar(
    "DYN_TPU_KV_SKETCH_CAPACITY", 4096, int,
    "Prefix-popularity sketch capacity in tracked prefixes "
    "(dynamo_tpu/config.py:454)",
)
KV_SKETCH_HALF_LIFE_S = EnvVar(
    "DYN_TPU_KV_SKETCH_HALF_LIFE_S", 600.0, float,
    "Popularity decay half-life in seconds; 0 disables decay "
    "(dynamo_tpu/config.py:461)",
)
TRACE_FILE = EnvVar(
    "DYN_TPU_TRACE_FILE", "", str,
    "Append finished spans as JSONL to this path ('' disables file export) "
    "(dynamo_tpu/config.py:478)",
)
OTLP_ENDPOINT = EnvVar(
    "DYN_TPU_OTLP_ENDPOINT", "", str,
    "OTLP/HTTP traces endpoint; '' disables the wire exporter "
    "(dynamo_tpu/config.py:484)",
)
OTLP_SERVICE = EnvVar(
    "DYN_TPU_OTLP_SERVICE", "dynamo-tpu", str,
    "service.name resource attribute on exported spans "
    "(dynamo_tpu/config.py:490)",
)
# -- disaggregated KV transfer (disagg/handlers.py) ------------------------------
PULL_ATTEMPTS = EnvVar(
    "DYN_TPU_PULL_ATTEMPTS", 3, int,
    "Bounded retry: attempts per decode-side KV pull (1 = single-shot) "
    "(dynamo_tpu/config.py:249)",
)
PULL_BACKOFF_S = EnvVar(
    "DYN_TPU_PULL_BACKOFF_S", 0.05, float,
    "Exponential backoff base between pull attempts (base x 2^(n-1), "
    "capped) (dynamo_tpu/config.py:254)",
)
PULL_TIMEOUT_S = EnvVar(
    "DYN_TPU_PULL_TIMEOUT_S", 30.0, float,
    "Per-attempt pull timeout when the request carries no deadline; with "
    "one, each attempt gets min(this, time remaining) (dynamo_tpu/config.py:260)",
)
BREAKER_OPEN_AFTER = EnvVar(
    "DYN_TPU_BREAKER_OPEN_AFTER", 3, int,
    "Consecutive pull failures from one prefill source before the "
    "(src -> worker) circuit opens (dynamo_tpu/config.py:266)",
)
BREAKER_COOLDOWN_S = EnvVar(
    "DYN_TPU_BREAKER_COOLDOWN_S", 30.0, float,
    "Open-circuit cooldown before the next pull is admitted as the "
    "half-open probe (dynamo_tpu/config.py:272)",
)
KV_CHUNK_BYTES = EnvVar(
    "DYN_TPU_KV_CHUNK_BYTES", 8 << 20, int,
    "KV transfer chunk size: one message blocks the event loop and "
    "doubles peak host memory; ~8 MB chunks pipeline gather/wire/scatter "
    "(dynamo_tpu/config.py:278)",
)
# -- overload armor (runtime/overload.py) --------------------------------------
OVERLOAD_MAX_CONCURRENCY = EnvVar(
    "DYN_TPU_OVERLOAD_MAX_CONCURRENCY", 256, int,
    "Frontend streams generating concurrently; excess queues (EDF) "
    "(dynamo_tpu/config.py:285)",
)
OVERLOAD_MAX_QUEUE = EnvVar(
    "DYN_TPU_OVERLOAD_MAX_QUEUE", 1024, int,
    "Bounded admission queue depth; beyond it requests shed 429 "
    "(dynamo_tpu/config.py:290)",
)
OVERLOAD_MAX_QUEUE_DELAY_S = EnvVar(
    "DYN_TPU_OVERLOAD_MAX_QUEUE_DELAY_S", 30.0, float,
    "Shed when predicted queue delay exceeds this (429 + Retry-After) "
    "(dynamo_tpu/config.py:295)",
)
OVERLOAD_DEFAULT_DEADLINE_S = EnvVar(
    "DYN_TPU_OVERLOAD_DEFAULT_DEADLINE_S", 0.0, float,
    "Deadline stamped on requests that carry none (0 = unbounded) "
    "(dynamo_tpu/config.py:300)",
)
OVERLOAD_ITL_SLA_MS = EnvVar(
    "DYN_TPU_OVERLOAD_ITL_SLA_MS", 0.0, float,
    "p50 ITL SLA driving healthy->brownout->shed (0 = brownout disabled; "
    "admission caps still enforce) (dynamo_tpu/config.py:305)",
)
OVERLOAD_BROWNOUT_MAX_TOKENS = EnvVar(
    "DYN_TPU_OVERLOAD_BROWNOUT_MAX_TOKENS", 256, int,
    "max_tokens clamp applied while browned out (dynamo_tpu/config.py:311)",
)
# -- trajectory plane (runtime/trajectory.py) -----------------------------------
TRAJECTORY_RECENT = EnvVar(
    "DYN_TPU_TRAJECTORY_RECENT", 256, int,
    "Recent request trajectories retained for GET /debug/trajectory "
    "(dynamo_tpu/config.py:317)",
)
TRAJECTORY_SLOW = EnvVar(
    "DYN_TPU_TRAJECTORY_SLOW", 64, int,
    "Slow/errored trajectory summaries retained past recent-ring eviction "
    "(dynamo_tpu/config.py:322)",
)
TRAJECTORY_SHIP_INTERVAL_S = EnvVar(
    "DYN_TPU_TRAJECTORY_SHIP_S", 0.5, float,
    "Worker-side finished-span batch flush cadence onto the event plane "
    "(dynamo_tpu/config.py:327)",
)
SLO_TTFT_MS = EnvVar(
    "DYN_TPU_SLO_TTFT_MS", 0.0, float,
    "TTFT SLA for the goodput/burn-rate gauges (0 = SLO tracking off) "
    "(dynamo_tpu/config.py:332)",
)
SLO_ITL_MS = EnvVar(
    "DYN_TPU_SLO_ITL_MS", 0.0, float,
    "Mean-ITL SLA for the goodput/burn-rate gauges (0 = SLO tracking off) "
    "(dynamo_tpu/config.py:337)",
)
SLO_TARGET = EnvVar(
    "DYN_TPU_SLO_TARGET", 0.99, float,
    "SLO target the burn-rate denominates against (error budget = 1 - target) "
    "(dynamo_tpu/config.py:342)",
)

# -- perf ledger (runtime/perf_ledger.py)
PERF_WINDOW = EnvVar(
    "DYN_TPU_PERF_WINDOW", 256, int,
    "Perf-ledger rolling window (samples per decode shape; bounds both "
    "memory and quantile cost) (dynamo_tpu/config.py:401)",
)
PERF_SAMPLE_TTL_S = EnvVar(
    "DYN_TPU_PERF_SAMPLE_TTL_S", 120.0, float,
    "Perf-ledger sample TTL in seconds (stale samples age out so the "
    "windows describe the CURRENT regime, not history) (dynamo_tpu/config.py:407)",
)
PERF_EVAL_INTERVAL_S = EnvVar(
    "DYN_TPU_PERF_EVAL_INTERVAL_S", 5.0, float,
    "Seconds between perf-sentinel evaluations (the fingerprint "
    "comparison runs at this cadence, not per tick) (dynamo_tpu/config.py:413)",
)
PERF_NOISE_BAND = EnvVar(
    "DYN_TPU_PERF_NOISE_BAND", 0.10, float,
    "Fractional noise band around a fingerprint before the sentinel "
    "calls regression (0.10 = ±5% run-to-run noise stays silent, a "
    "20% slowdown is flagged) (dynamo_tpu/config.py:419)",
)
PERF_MIN_SAMPLES = EnvVar(
    "DYN_TPU_PERF_MIN_SAMPLES", 16, int,
    "Samples a window needs before the sentinel issues a verdict for it "
    "(dynamo_tpu/config.py:426)",
)
PERF_FINGERPRINT_PATH = EnvVar(
    "DYN_TPU_PERF_FINGERPRINT_PATH", "", str,
    "Where steady-state perf fingerprints persist across restarts "
    "(JSON; empty = in-memory only, every start is a cold start) "
    "(dynamo_tpu/config.py:431)",
)
