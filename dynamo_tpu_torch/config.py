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
