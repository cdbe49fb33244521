"""Request auditing: capture full request/response pairs per policy — the
port's copy of dynamo_tpu/http/audit.py.

Reference parity: lib/llm/src/audit/ (AuditRecord + bus + sinks: stderr /
JetStream; policy from env). Here: an in-process bus with pluggable sinks
(stderr JSONL, file JSONL); policy via ``DYN_TPU_AUDIT`` env
(off | stderr | file:<path>). Aggregated AND streamed responses are
captured — the frontend assembles the final text either way.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol

from dynamo_tpu_torch import config
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Declared in config.py.
AUDIT_POLICY = config.AUDIT_POLICY

SCHEMA_VERSION = 1


@dataclass
class AuditRecord:
    """(ref: audit/handle.rs AuditRecord)"""

    request_id: str
    model: str
    requested_streaming: bool
    endpoint: str
    ts: float = field(default_factory=time.time)
    request: Optional[Dict[str, Any]] = None
    response_text: Optional[str] = None
    finish_reason: Optional[str] = None
    status: int = 0
    schema_version: int = SCHEMA_VERSION

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "ts": self.ts,
            "request_id": self.request_id,
            "model": self.model,
            "endpoint": self.endpoint,
            "requested_streaming": self.requested_streaming,
            "request": self.request,
            "response_text": self.response_text,
            "finish_reason": self.finish_reason,
            "status": self.status,
        }


class AuditSink(Protocol):
    def emit(self, record: AuditRecord) -> None: ...


class StderrSink:
    def emit(self, record: AuditRecord) -> None:
        print(json.dumps({"audit": record.to_dict()}), file=sys.stderr, flush=True)


class FileSink:
    def __init__(self, path: str) -> None:
        self.path = path

    def emit(self, record: AuditRecord) -> None:
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(record.to_dict()) + "\n")
        except OSError:
            logger.exception("audit file sink failed; disabling")
            self.path = ""


class AuditBus:
    """(ref: audit/bus.rs) — fan records out to registered sinks."""

    def __init__(self) -> None:
        self.sinks: List[AuditSink] = []

    @classmethod
    def from_env(cls) -> "AuditBus":
        bus = cls()
        policy = AUDIT_POLICY.get()
        if policy == "stderr":
            bus.sinks.append(StderrSink())
        elif policy.startswith("file:"):
            bus.sinks.append(FileSink(policy.split(":", 1)[1]))
        return bus

    @property
    def enabled(self) -> bool:
        return bool(self.sinks)

    def publish(self, record: AuditRecord) -> None:
        for sink in self.sinks:
            try:
                sink.emit(record)
            except Exception:
                logger.exception("audit sink %r failed", sink)
