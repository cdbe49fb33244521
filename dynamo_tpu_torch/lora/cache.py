"""LoRA adapter cache: fetch-once, LRU-evicted local materialization.
The port's copy of dynamo_tpu/lora/cache.py (framework-free).

Reference parity: lib/llm/src/lora/cache.rs (LoRACache — bounded local cache
in front of a LoRASource, keyed by adapter name).
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional

from dynamo_tpu_torch.lora.source import LoRASource
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class LoRACache:
    def __init__(
        self, source: LoRASource, *, cache_dir: str = "/tmp/dynamo_tpu_lora",
        max_adapters: int = 32,
    ) -> None:
        self.source = source
        self.cache_dir = cache_dir
        self.max_adapters = max_adapters
        self._paths: "collections.OrderedDict[str, str]" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, name: str) -> str:
        """Local path for adapter ``name``, fetching on miss."""
        with self._lock:
            if name in self._paths:
                self.hits += 1
                self._paths.move_to_end(name)
                return self._paths[name]
        # Fetch outside the lock (may be slow for remote sources).
        path = self.source.fetch(name, self.cache_dir)
        with self._lock:
            self.misses += 1
            self._paths[name] = path
            self._paths.move_to_end(name)
            while len(self._paths) > self.max_adapters:
                evicted, _ = self._paths.popitem(last=False)
                logger.info("evicted LoRA adapter %s from cache", evicted)
        return path

    def contains(self, name: str) -> bool:
        with self._lock:
            return name in self._paths

    def list_cached(self) -> List[str]:
        with self._lock:
            return list(self._paths)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "cached": len(self._paths),
                "hits": self.hits,
                "misses": self.misses,
            }
