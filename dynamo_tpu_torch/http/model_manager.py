"""ModelManager: the frontend's registry of servable models — the port's
copy of dynamo_tpu/http/model_manager.py.

Reference parity: lib/llm/src/discovery/model_manager.rs — maps model name →
assembled pipeline engine + deployment card. Fed either statically (tests,
single-process serving) or dynamically by the ModelWatcher as workers
register/deregister on the discovery plane.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols.openai import model_entry
from dynamo_tpu_torch.runtime.engine import AsyncEngine


@dataclass
class ModelEntry:
    name: str
    engine: AsyncEngine  # full pipeline: OpenAI dict request in
    card: ModelDeploymentCard
    registered_at: float = field(default_factory=time.time)
    # optional per-model operational attachments (worker_monitor.py / health.py)
    monitor: Optional[Any] = None  # WorkerLoadMonitor
    health: Optional[Any] = None  # CanaryHealthChecker
    # admin hooks, e.g. {"clear_kv": async () -> int} (clear_kv_blocks route)
    admin: Dict[str, Any] = field(default_factory=dict)


class ModelManager:
    def __init__(self) -> None:
        self._models: Dict[str, ModelEntry] = {}

    def register(
        self,
        name: str,
        engine: AsyncEngine,
        card: ModelDeploymentCard,
        *,
        monitor: Optional[Any] = None,
        health: Optional[Any] = None,
        admin: Optional[Dict[str, Any]] = None,
    ) -> None:
        self._models[name] = ModelEntry(
            name=name, engine=engine, card=card, monitor=monitor, health=health,
            admin=dict(admin or {}),
        )

    def unregister(self, name: str) -> None:
        self._models.pop(name, None)

    def get(self, name: str) -> Optional[ModelEntry]:
        return self._models.get(name)

    def names(self) -> List[str]:
        return sorted(self._models)

    def openai_model_list(self) -> List[Dict[str, Any]]:
        return [
            model_entry(e.name, created=int(e.registered_at))
            for e in sorted(self._models.values(), key=lambda e: e.name)
        ]

    def __len__(self) -> int:
        return len(self._models)
