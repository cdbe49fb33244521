"""Int8 weight-only parameters — counterpart of dynamo_tpu/models/quantize.py.

Each matmul weight of the port's parameter dictionary (per-layer list form,
models/llama.py) becomes the ``{"q8", "s"}`` pair of ops/quant.py; norms and
biases stay in the model's dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from dynamo_tpu_torch.device import DeviceLike, resolve_device
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.quant import is_q8, quantize_q8

Params = Dict[str, Any]

# weight name → contracted axis, in the per-layer layout ([d, N] weights
# contract axis 0) and for the top-level weights as stored.
_LAYER_CONTRACT = {
    "wq": 0, "wk": 0, "wv": 0, "wo": 0, "w_gate": 0, "w_up": 0, "w_down": 0,
}
_TOP_CONTRACT = {"embed": 1, "lm_head": 0}
# std of codes drawn uniform in [-127, 127]
_INT8_STD = 73.3


def is_quantized(params: Any) -> bool:
    """Whether any leaf of the (nested dict / list) tree is an int8 pair."""
    if is_q8(params):
        return True
    if isinstance(params, dict):
        return any(is_quantized(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return any(is_quantized(v) for v in params)
    return False


def quantize_params(params: Params) -> Params:
    """Quantize a parameter dictionary in the per-layer list form.
    Idempotent: an int8 leaf passes through."""

    def put(w, contract):
        if contract is None or is_q8(w):
            return w
        return quantize_q8(w, (contract,))

    out: Params = {}
    for name, w in params.items():
        if name == "layers":
            out[name] = [
                {ln: put(lw, _LAYER_CONTRACT.get(ln)) for ln, lw in lp.items()} for lp in w
            ]
        else:
            out[name] = put(w, _TOP_CONTRACT.get(name))
    return out


@torch.no_grad()
def init_quantized_params(config: ModelConfig, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random parameters made directly in int8, as the JAX function does
    (quantize.py:100-153): codes uniform in [-127, 127], each channel's
    scale ``target_std / 73.3`` so the dequantised std matches
    ``llama.init_params``. The codes are drawn on the device from a
    ``torch.Generator`` seeded with ``seed`` (eight gigabytes of host draws
    at Llama-3-8B would take minutes); they differ from numpy's draws, so
    parity tests convert the JAX package's tree with params_from_jax."""
    c = config
    if c.is_moe:
        raise NotImplementedError("MoE layers are not ported yet")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    hd, d, ff, H, KH = c.head_dim_, c.d_model, c.d_ff, c.n_heads, c.n_kv_heads

    def q(shape, target_std, contract_axis):
        codes = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        s_shape = tuple(1 if i == contract_axis else n for i, n in enumerate(shape))
        scale = torch.full(s_shape, target_std / _INT8_STD, dtype=torch.float32, device=dev)
        return {"q8": codes, "s": scale}

    def fp(shape, fill):
        return torch.full(shape, fill, dtype=c.dtype, device=dev)

    norm_fill = 0.0 if c.rmsnorm_unit_offset else 1.0
    layers = []
    for _ in range(c.n_layers):
        lp: Params = {
            "attn_norm": fp((d,), norm_fill),
            "wq": q((d, H * hd), d**-0.5, 0),
            "wk": q((d, KH * hd), d**-0.5, 0),
            "wv": q((d, KH * hd), d**-0.5, 0),
            "wo": q((H * hd, d), (H * hd) ** -0.5, 0),
            "mlp_norm": fp((d,), norm_fill),
            "w_gate": q((d, ff), d**-0.5, 0),
            "w_up": q((d, ff), d**-0.5, 0),
            "w_down": q((ff, d), ff**-0.5, 0),
        }
        if c.post_norms:
            lp["attn_post_norm"] = fp((d,), norm_fill)
            lp["mlp_post_norm"] = fp((d,), norm_fill)
        if c.qkv_bias:
            lp["bq"] = fp((H * hd,), 0.0)
            lp["bk"] = fp((KH * hd,), 0.0)
            lp["bv"] = fp((KH * hd,), 0.0)
        if c.qk_norm:
            lp["q_norm"] = fp((hd,), 1.0)
            lp["k_norm"] = fp((hd,), 1.0)
        layers.append(lp)
    params: Params = {
        "embed": q((c.vocab_size, d), 1.0, 1),
        "layers": layers,
        "final_norm": fp((d,), norm_fill),
    }
    if not c.tie_word_embeddings:
        params["lm_head"] = q((d, c.vocab_size), d**-0.5, 0)
    return params
