"""LoRA adapter serving: sources, cache, placement, batched compute —
counterpart of dynamo_tpu/lora/.

Reference parity: lib/llm/src/lora.rs — downloader/cache (adapter artifact
management), routing (RendezvousHasher HRW placement + LoraRoutingTable),
load_estimator (per-adapter demand → replica counts). The compute side:
adapters are stacked on a leading axis and applied as a gather and two
batched products (ops/lora.py), so one captured decode graph serves a
continuous batch mixing adapters (engines/gpu/runner.py).
"""

from dynamo_tpu_torch.lora.cache import LoRACache
from dynamo_tpu_torch.lora.load_estimator import LoadEstimator, LoadEstimatorConfig
from dynamo_tpu_torch.lora.loader import LoRAAdapter, load_lora_adapter
from dynamo_tpu_torch.lora.routing import (
    LoraRoutingTable,
    RendezvousHasher,
)
from dynamo_tpu_torch.lora.source import LocalLoRASource, LoRASource

__all__ = [
    "LoRACache",
    "LoRAAdapter",
    "load_lora_adapter",
    "LoadEstimator",
    "LoadEstimatorConfig",
    "LoraRoutingTable",
    "RendezvousHasher",
    "LoRASource",
    "LocalLoRASource",
]
