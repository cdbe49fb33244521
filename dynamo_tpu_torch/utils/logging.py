"""Structured logging setup — the port's copy of dynamo_tpu/utils/logging.py
(the port logs under ``dynamo_tpu_torch``).

Reference parity: lib/runtime/src/logging.rs (DYN_LOG level control, JSONL
mode, request-id propagation). OTel export is out of scope in this
environment; the JSONL format carries trace fields so an external collector
can ingest it.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional

from dynamo_tpu_torch import config

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

_configured = False


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": round(time.time(), 6),
            "level": record.levelname.lower(),
            "target": record.name,
            "message": record.getMessage(),
        }
        # Lazy, as in the JAX package: utils.logging sits below runtime.
        from dynamo_tpu_torch.runtime.context import current_context

        ctx = current_context()
        if ctx is not None:
            entry["request_id"] = ctx.id
        if record.exc_info and record.exc_info[0] is not None:
            entry["exception"] = self.formatException(record.exc_info)
        return json.dumps(entry, separators=(",", ":"))


class TextFormatter(logging.Formatter):
    def __init__(self) -> None:
        super().__init__(
            fmt="%(asctime)s %(levelname)-5s %(name)s: %(message)s",
            datefmt="%H:%M:%S",
        )


def configure_logging(level: Optional[str] = None, json_mode: Optional[bool] = None) -> None:
    global _configured
    level = level or config.LOG_LEVEL.get()
    json_mode = json_mode if json_mode is not None else config.LOG_JSON.get()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(JsonFormatter() if json_mode else TextFormatter())
    root = logging.getLogger("dynamo_tpu_torch")
    root.handlers.clear()
    root.addHandler(handler)
    root.setLevel(_LEVELS.get(str(level).lower(), logging.INFO))
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    if not _configured:
        configure_logging()
    return logging.getLogger(
        name if name.startswith("dynamo_tpu_torch") else f"dynamo_tpu_torch.{name}"
    )
