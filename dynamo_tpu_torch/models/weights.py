"""Parameter bridge from the JAX package's layout to the port's.

``params_from_jax`` takes the JAX package's parameter tree with numpy leaves
(``jax.tree.map(np.asarray, params)`` on the JAX side — this module never
imports JAX) and returns the port's dictionary: the same names and layouts,
per-layer list form, torch tensors in the config's dtype on ``device``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Union

import numpy as np
import torch

from dynamo_tpu_torch.device import DeviceLike, resolve_device
from dynamo_tpu_torch.models.config import ModelConfig

Params = Dict[str, Any]


def _tensor(a: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(a, Mapping):
        raise NotImplementedError("int8 {'q8', 's'} weights are not ported yet")
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: widen exactly first
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device=device, dtype=dtype)


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
        stacked = {name: np.asarray(a) for name, a in layers_in.items()}
        n = next(iter(stacked.values())).shape[0]
        if n != config.n_layers:
            raise ValueError(f"tree has {n} layers, config {config.n_layers}")
        per_layer = [{name: a[l] for name, a in stacked.items()} for l in range(n)]
    else:
        per_layer = list(layers_in)
        if len(per_layer) != config.n_layers:
            raise ValueError(f"tree has {len(per_layer)} layers, config {config.n_layers}")
    layers: List[Params] = [
        {name: _tensor(a, dt, dev) for name, a in lp.items()} for lp in per_layer
    ]
    out: Params = {
        name: _tensor(a, dt, dev) for name, a in tree.items() if name != "layers"
    }
    out["layers"] = layers
    return out
