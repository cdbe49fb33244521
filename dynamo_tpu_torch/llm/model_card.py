"""ModelDeploymentCard: metadata a worker publishes to the discovery plane —
the port's copy of dynamo_tpu/llm/model_card.py.

Reference parity: lib/llm/src/model_card.rs:178 (ModelDeploymentCard) and
local_model/runtime_config.rs. The card is everything a frontend needs to
serve a model it has never seen: where the tokenizer/template live, context
window, KV block size, engine runtime capacity, migration budget.
"""

from __future__ import annotations

import os
import re
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch import config


def slugify(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_.-]+", "-", name).strip("-").lower()


@dataclass
class RuntimeConfig:
    """Engine capacity info used by the router/planner
    (ref: local_model/runtime_config.rs)."""

    total_kv_blocks: int = 0
    kv_block_size: int = 64
    max_num_seqs: int = 256
    max_context_len: int = 4096
    dp_size: int = 1
    supports_disagg: bool = False


@dataclass
class ModelDeploymentCard:
    name: str
    model_type: str = "chat"  # chat | completion | embedding | multimodal | image
    model_path: Optional[str] = None  # local dir with tokenizer/config
    context_length: int = 4096
    kv_block_size: int = 64
    # DYN_TPU_MIGRATION_LIMIT, read at card creation: the card carries
    # the worker's migration budget to every frontend that serves it.
    migration_limit: int = field(
        default_factory=lambda: config.MIGRATION_LIMIT.get()
    )
    eos_token_ids: List[int] = field(default_factory=list)
    chat_template_source: Optional[str] = None  # inline template override
    # Reasoning-content marker style (parsers/reasoning.py KNOWN_MARKERS):
    # think | reasoning | seed | granite.
    reasoning_style: str = "think"
    # Tool-call dialect pin (parsers/incremental.py DIALECTS): json |
    # hermes | mistral | pythonic | harmony | dsml | xml. None =
    # auto-detect by opening marker — required for the marker-less
    # dialects (json, pythonic) to stream incrementally.
    tool_call_dialect: Optional[str] = None
    runtime_config: RuntimeConfig = field(default_factory=RuntimeConfig)
    user_data: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        from dynamo_tpu_torch.parsers.incremental import DIALECTS
        from dynamo_tpu_torch.parsers.reasoning import KNOWN_MARKERS

        if self.reasoning_style not in KNOWN_MARKERS:
            raise ValueError(
                f"unknown reasoning_style {self.reasoning_style!r}; "
                f"known: {sorted(KNOWN_MARKERS)}"
            )
        if (
            self.tool_call_dialect is not None
            and self.tool_call_dialect not in DIALECTS
        ):
            raise ValueError(
                f"unknown tool_call_dialect {self.tool_call_dialect!r}; "
                f"known: {sorted(DIALECTS)}"
            )

    @property
    def slug(self) -> str:
        return slugify(self.name)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelDeploymentCard":
        d = dict(d)
        d["runtime_config"] = RuntimeConfig(**(d.get("runtime_config") or {}))
        return cls(**d)

    @classmethod
    def from_model_dir(cls, name: str, model_dir: str, **overrides: Any) -> "ModelDeploymentCard":
        """Build a card from a local HF-style model directory
        (ref: local_model resolution, hub.rs — local path branch)."""
        import json

        context_length = 4096
        eos: List[int] = []
        cfg_path = os.path.join(model_dir, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            context_length = int(
                cfg.get("max_position_embeddings")
                or cfg.get("n_positions")
                or context_length
            )
            raw_eos = cfg.get("eos_token_id")
            if raw_eos is not None:
                eos = [raw_eos] if isinstance(raw_eos, int) else list(raw_eos)
        card = cls(
            name=name,
            model_path=model_dir,
            context_length=context_length,
            eos_token_ids=eos,
        )
        for k, v in overrides.items():
            setattr(card, k, v)
        return card
