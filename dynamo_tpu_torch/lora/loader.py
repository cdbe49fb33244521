"""Load PEFT-format LoRA adapters into the model's layer-stacked layout —
counterpart of dynamo_tpu/lora/loader.py.

PEFT stores ``base_model.model.model.layers.{i}.<module>.lora_{A,B}.weight``
with ``lora_A`` [r, d_in] and ``lora_B`` [d_out, r]; per target module the
adapter becomes (A [L, d_in, r], B [L, r, d_out]), both transposed, and
layers the adapter does not touch hold zeros. Host tensors are float32 on
the CPU (the card holds only the stack, engines/gpu/runner.py), rounded
through the model dtype at load as JAX's loader stores them, so a stack
built here equals JAX's bit for bit. The file is read by
models/safetensors_lite.py.

``stack_adapters`` puts a zero "no adapter" slot 0 first, pads every
adapter to the largest rank, folds ``alpha / r`` into B and casts to the
model dtype last, as JAX's does. ``lora_from_jax`` carries a JAX
``LoRAAdapter`` (its arrays read with numpy; nothing of JAX is imported)
into this layout.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.safetensors_lite import load_file

# PEFT module name → our param name
_TARGET_MAP = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "w_gate",
    "up_proj": "w_up",
    "down_proj": "w_down",
}


@dataclass
class LoRAAdapter:
    name: str
    rank: int
    scaling: float  # lora_alpha / r
    # our param name → (A [L, d_in, r], B [L, r, d_out]), float32 host tensors
    weights: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = field(default_factory=dict)

    @property
    def targets(self) -> List[str]:
        return sorted(self.weights)


def _module_dims(config: ModelConfig, ours: str) -> Tuple[int, int]:
    d, ff = config.d_model, config.d_ff
    hd = config.head_dim_
    dims = {
        "wq": (d, config.n_heads * hd),
        "wk": (d, config.n_kv_heads * hd),
        "wv": (d, config.n_kv_heads * hd),
        "wo": (config.n_heads * hd, d),
        "w_gate": (d, ff),
        "w_up": (d, ff),
        "w_down": (ff, d),
    }
    return dims[ours]


def _as_model_dtype(a: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """float32 holding the model dtype's values (JAX keeps the arrays in
    that dtype)."""
    return a.to(config.dtype).to(torch.float32)


def load_lora_adapter(
    adapter_dir: str, config: ModelConfig, *, name: Optional[str] = None
) -> LoRAAdapter:
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        acfg = json.load(f)
    rank = int(acfg.get("r", 8))
    alpha = float(acfg.get("lora_alpha", rank))
    adapter = LoRAAdapter(
        name=name or os.path.basename(adapter_dir.rstrip("/")),
        rank=rank,
        scaling=alpha / rank,
    )
    raw = load_file(os.path.join(adapter_dir, "adapter_model.safetensors"))

    L = config.n_layers
    # group by target module
    per_target: Dict[str, Dict[int, Dict[str, torch.Tensor]]] = {}
    for key, tensor in raw.items():
        # ...model.layers.{i}.self_attn.q_proj.lora_A.weight
        parts = key.split(".")
        try:
            li = parts.index("layers")
            layer = int(parts[li + 1])
        except (ValueError, IndexError):
            continue
        module = next((p for p in parts if p in _TARGET_MAP), None)
        ab = "A" if "lora_A" in key else "B" if "lora_B" in key else None
        if module is None or ab is None:
            continue
        per_target.setdefault(module, {}).setdefault(layer, {})[ab] = tensor

    for module, layers in per_target.items():
        ours = _TARGET_MAP[module]
        d_in, d_out = _module_dims(config, ours)
        A = torch.zeros((L, d_in, rank), dtype=torch.float32)
        B = torch.zeros((L, rank, d_out), dtype=torch.float32)
        for layer, ab in layers.items():
            if "A" in ab:
                A[layer] = ab["A"].T.to(torch.float32)  # PEFT stores [r, d_in]
            if "B" in ab:
                B[layer] = ab["B"].T.to(torch.float32)  # PEFT stores [d_out, r]
        adapter.weights[ours] = (_as_model_dtype(A, config), _as_model_dtype(B, config))
    return adapter


def lora_from_jax(adapter: Any) -> LoRAAdapter:
    """A JAX ``LoRAAdapter`` (arrays in the model dtype) as the port's:
    float32 host tensors of the same values."""
    def host(a: Any) -> torch.Tensor:
        return torch.from_numpy(np.array(np.asarray(a, dtype=np.float32), copy=True))

    return LoRAAdapter(
        name=adapter.name, rank=int(adapter.rank), scaling=float(adapter.scaling),
        weights={t: (host(A), host(B)) for t, (A, B) in adapter.weights.items()},
    )


def stack_adapters(
    adapters: List[LoRAAdapter], config: ModelConfig, targets: List[str]
) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Stack N adapters (plus a zero 'no adapter' slot 0) per target:
    A: [N+1, L, d_in, r_max], B: [N+1, L, r_max, d_out], CPU tensors in the
    model dtype. Scaling is folded into B so the batched compute needs no
    per-adapter scalar."""
    L = config.n_layers
    r_max = max([a.rank for a in adapters], default=1)
    out: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for target in targets:
        d_in, d_out = _module_dims(config, target)
        A = torch.zeros((len(adapters) + 1, L, d_in, r_max), dtype=torch.float32)
        B = torch.zeros((len(adapters) + 1, L, r_max, d_out), dtype=torch.float32)
        for i, a in enumerate(adapters, start=1):
            if target not in a.weights:
                continue
            Aa, Ba = a.weights[target]
            A[i, :, :, : a.rank] = Aa.to(torch.float32)
            B[i, :, : a.rank, :] = Ba.to(torch.float32) * a.scaling
        out[target] = (A.to(config.dtype), B.to(config.dtype))
    return out
