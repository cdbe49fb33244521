"""KV-aware routing layer — the port's copy of dynamo_tpu/router/.

Reference parity: lib/llm/src/kv_router.rs + lib/kv-router (SURVEY §2.1):
radix-tree indexer fed by worker KV events, cost-model scheduler with
softmax-temperature worker sampling, publishers bridging engine events onto
the event plane, and a KvRouter that plugs into the runtime Client as its
KV-mode instance picker.
"""

from dynamo_tpu_torch.router.protocols import (
    KV_EVENTS_TOPIC,
    LOAD_TOPIC,
    LoadSnapshot,
    RouterEvent,
    kv_events_topic,
    load_topic,
)
from dynamo_tpu_torch.router.indexer import KvIndexer
from dynamo_tpu_torch.router.scheduler import (
    KvRouterConfig,
    KvScheduler,
    LinkCostModel,
    TransferContext,
    WorkerState,
)
from dynamo_tpu_torch.router.publisher import KvEventPublisher, LoadPublisher
from dynamo_tpu_torch.router.router import KvRouter

__all__ = [
    "KV_EVENTS_TOPIC",
    "LOAD_TOPIC",
    "LoadSnapshot",
    "RouterEvent",
    "kv_events_topic",
    "load_topic",
    "KvIndexer",
    "KvRouterConfig",
    "KvScheduler",
    "LinkCostModel",
    "TransferContext",
    "WorkerState",
    "KvEventPublisher",
    "LoadPublisher",
    "KvRouter",
]
