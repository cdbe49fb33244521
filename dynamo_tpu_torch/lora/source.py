"""Adapter sources: where LoRA artifacts come from.
The port's copy of dynamo_tpu/lora/source.py (framework-free).

Reference parity: lib/llm/src/lora/source.rs (LoRASource trait with
LocalLoRASource / S3LoRASource). Zero-egress environment: only the local
source is functional; the remote source is a gated stub with the same
interface so deployments with egress can drop one in.
"""

from __future__ import annotations

import os
from typing import List, Protocol


class LoRASource(Protocol):
    def list_adapters(self) -> List[str]: ...
    def fetch(self, name: str, dest_dir: str) -> str:
        """Materialize adapter `name` under dest_dir; returns the local path."""
        ...


class LocalLoRASource:
    """Adapters laid out as ``root/<name>/adapter_config.json`` (+ weights)."""

    def __init__(self, root: str) -> None:
        self.root = root

    def list_adapters(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(
            d
            for d in os.listdir(self.root)
            if os.path.exists(os.path.join(self.root, d, "adapter_config.json"))
        )

    def fetch(self, name: str, dest_dir: str) -> str:
        path = os.path.join(self.root, name)
        if not os.path.exists(os.path.join(path, "adapter_config.json")):
            raise FileNotFoundError(f"no adapter '{name}' under {self.root}")
        # Local source: artifacts are already on disk — no copy needed.
        return path


class RemoteLoRASource:
    """Placeholder for object-store sources (ref: S3LoRASource). This
    environment has no egress; constructing one raises with guidance."""

    def __init__(self, uri: str) -> None:
        raise NotImplementedError(
            f"remote LoRA source {uri!r} requires network egress; "
            "mount the adapters locally and use LocalLoRASource"
        )
