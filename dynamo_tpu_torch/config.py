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
