"""Parameter bridge from the JAX package's layout to the port's.

``params_from_jax`` takes the JAX package's parameter tree with numpy leaves
(``jax.tree.map(np.asarray, params)`` on the JAX side — this module never
imports JAX) and returns the port's dictionary: the same names and layouts,
per-layer list form, torch tensors on ``device``: plain leaves in the
config's dtype, int8 ``{"q8", "s"}`` leaves as int8 codes and float32
scales (per layer ``[1, N]``; ``[V, 1]`` / ``[1, V]`` for embed and head).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Union

import numpy as np
import torch

from dynamo_tpu_torch.device import DeviceLike, resolve_device
from dynamo_tpu_torch.models.config import ModelConfig

Params = Dict[str, Any]


def _tensor(a: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: widen exactly first
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device=device, dtype=dtype)


def _leaf(a: Any, dtype: torch.dtype, device: torch.device) -> Any:
    """A plain leaf takes the config dtype; an int8 pair keeps int8 codes
    and float32 scales."""
    if isinstance(a, Mapping):
        return {"q8": _tensor(a["q8"], torch.int8, device),
                "s": _tensor(a["s"], torch.float32, device)}
    return _tensor(a, dtype, device)


def _layer_slice(a: Any, l: int) -> Any:
    if isinstance(a, Mapping):
        return {k: np.asarray(v)[l] for k, v in a.items()}
    return np.asarray(a)[l]


def _n_layers(a: Any) -> int:
    return np.asarray(a["q8"] if isinstance(a, Mapping) else a).shape[0]


def params_from_jax(
    tree: Mapping[str, Any], config: ModelConfig, device: DeviceLike = None
) -> Params:
    """Accepts both the stacked ``layers`` form (a dict of [L, ...] arrays,
    as ``llama.init_params`` makes) and the per-layer list form (as
    ``llama.unstack_layer_params`` makes)."""
    dev = resolve_device(device)
    dt = config.dtype
    layers_in: Union[Mapping[str, Any], Sequence[Mapping[str, Any]]] = tree["layers"]
    if isinstance(layers_in, Mapping):
        n = _n_layers(next(iter(layers_in.values())))
        if n != config.n_layers:
            raise ValueError(f"tree has {n} layers, config {config.n_layers}")
        per_layer = [
            {name: _layer_slice(a, l) for name, a in layers_in.items()} for l in range(n)
        ]
    else:
        per_layer = list(layers_in)
        if len(per_layer) != config.n_layers:
            raise ValueError(f"tree has {len(per_layer)} layers, config {config.n_layers}")
    layers: List[Params] = [
        {name: _leaf(a, dt, dev) for name, a in lp.items()} for lp in per_layer
    ]
    out: Params = {
        name: _leaf(a, dt, dev) for name, a in tree.items() if name != "layers"
    }
    out["layers"] = layers
    return out
