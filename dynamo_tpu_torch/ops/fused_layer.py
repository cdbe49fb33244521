"""Fused decoder layer for C = 1 decode over int8 weights — counterpart of
dynamo_tpu/ops/pallas/fused_layer.py.

One call runs a whole decoder layer: RMS-norm → int8 q/k/v products (+bias,
qk-norm, RoPE) → paged attention over the history pages plus the current
token → int8 o-proj (+post-norm) → residual → RMS-norm → int8 gate/up →
SiLU or tanh-GeGLU · up → int8 down (+post-norm) → residual. It returns
(x_out [B, d], k_new [B, KH, D], v_new [B, KH, D]); the caller scatters the
current token's K/V into the pools AFTER the call
(ops/attention.write_chunk_to_cache), since the layer attends to the
history pages and to the current token it holds itself.

``fused_decoder_layer`` runs the plain version here for CPU tensors and
launches the hand-written CUDA kernel (ops/cuda/fused_layer.py) for CUDA
tensors. The plain version keeps the TPU kernel's rounding points, which
differ from ``llama.decoder_layer``'s: the products are float32 sums over
bf16 activations and int8 codes, times the column scale; q/k/v stay float32
through bias, qk-norm and RoPE (only k_new/v_new are cast); scores are
float32; the o-proj and the FFN products are added to the residual in
float32; h, attn and gu are bf16.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
_SUPPORTED_ACTS = ("silu", "gelu_tanh")
# Head dims csrc/fused_layer.cu is built for, and the widest GQA group
# (G · head_dim values) its attention step holds in shared memory.
BUILT_HEAD_DIMS = (128, 256)
MAX_GROUP_WIDTH = 8192


def _tiles_for(d: int, HD: int, KHD: int, F: int, D: int):
    """(TQ, TO, TF) weight-streaming tile widths, or None when no split
    exists — the JAX package's derivation (fused_layer.py:87-115), kept so
    ``supports_reason`` rejects exactly what the reference rejects."""

    def div_tile(n: int, cap: int, step: int) -> Optional[int]:
        t = (cap // step) * step
        while t >= step:
            if n % t == 0:
                return t
            t -= step
        return None

    tq = None
    t = (256 // D) * D if D else 0
    while t >= D > 0:
        if HD % t == 0 and KHD % t == 0:
            tq = t
            break
        t -= D
    to = div_tile(d, 512, 128)
    tf = div_tile(F, 512, 128)
    if tq is None or to is None or tf is None:
        return None
    return tq, to, tf


def supports_reason(config, *, lora: bool, quantized_weights: bool) -> Optional[str]:
    """Why the fused layer can NOT serve this config (None = it can). The
    strings are the JAX package's (fused_layer.py:118-149); two reasons
    belong to the port alone and come last: a head_dim the CUDA kernel was
    not built for, and a GQA group wider than its attention step holds. With
    128 and 256 built, every head_dim the JAX reasons admit is built."""
    c = config
    if not quantized_weights:
        return "weights not int8-quantized (the kernel streams int8 tiles)"
    if lora:
        return "LoRA adapters active (per-request delta einsums excluded)"
    if c.is_moe:
        return "MoE FFN (routed experts excluded; dense FFN only)"
    if c.act_fn not in _SUPPORTED_ACTS:
        return f"unsupported activation {c.act_fn!r} (silu/gelu_tanh only)"
    D = c.head_dim_
    if D <= 0 or D % 128 != 0:
        return f"head_dim {D} not a multiple of the 128-lane MXU width"
    if (c.n_heads % c.n_kv_heads) != 0:
        return "n_heads not a multiple of n_kv_heads (GQA grouping)"
    d, HD, KHD, Fd = c.d_model, c.n_heads * D, c.n_kv_heads * D, c.d_ff
    if _tiles_for(d, HD, KHD, Fd, D) is None:
        return (
            "no lane-aligned weight-streaming tile split for "
            f"(d={d}, HD={HD}, KHD={KHD}, d_ff={Fd})"
        )
    if D not in BUILT_HEAD_DIMS:
        return f"head_dim {D} not built into the CUDA kernel (built: {BUILT_HEAD_DIMS})"
    if (c.n_heads // c.n_kv_heads) * D > MAX_GROUP_WIDTH:
        return (
            f"{c.n_heads // c.n_kv_heads} query heads per KV head × head_dim {D} "
            f"exceeds the {MAX_GROUP_WIDTH} the CUDA kernel's shared memory holds"
        )
    return None


def supports(config, *, lora: bool, quantized_weights: bool) -> bool:
    return supports_reason(config, lora=lora, quantized_weights=quantized_weights) is None


def history_pcounts(start_pos: torch.Tensor, block_size: int, table_width: int) -> torch.Tensor:
    """Per-row history page count, clamped to the table width so a row
    never indexes past its table; derived once a step and shared by every
    layer."""
    start = start_pos.to(torch.int32)
    return torch.clamp((start + block_size - 1) // block_size, max=table_width).to(torch.int32)


def window_page_bounds(
    start_pos: torch.Tensor, window: Any, block_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wlo, poff): the first visible history key ``max(0, pos − W + 1)``
    (0 when the layer has no window) and its page."""
    start = start_pos.to(torch.int32)
    w = torch.as_tensor(window, dtype=torch.int32, device=start.device)
    wlo = torch.where(w > 0, torch.clamp(start - w + 1, min=0), torch.zeros_like(start))
    return wlo.to(torch.int32), (wlo // block_size).to(torch.int32)


def fused_decoder_layer_ref(
    x: torch.Tensor,  # [B, d] residual
    cos: torch.Tensor,  # [B, D] float32, already the layer's (local/global) table
    sin: torch.Tensor,  # [B, D]
    lp: Dict[str, Any],  # one layer's params, int8 {"q8", "s"} weights
    k_pool: torch.Tensor,  # [NB, BS, KH, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, P] int32
    start_pos: torch.Tensor,  # [B] int32
    *,
    eps: float,
    sm_scale: float,
    pcounts: Optional[torch.Tensor] = None,  # [B] int32 (history_pcounts)
    window: Optional[int] = None,  # 0 / None = full attention
    act_fn: str = "silu",
    unit_offset: bool = False,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, at the TPU kernel's rounding points
    (fused_layer.py:269-661). The kernel's oracle on the card."""
    B, d = x.shape
    NB, BS, KH, D = k_pool.shape
    P = block_tables.shape[1]
    H = lp["wq"]["q8"].shape[1] // D
    G = H // KH
    bf = torch.bfloat16
    f32 = torch.float32

    def w1(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        w = w.to(dtype)
        return w + 1.0 if unit_offset else w

    def norm_bf16(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        var = torch.mean(v * v, dim=-1, keepdim=True)
        return (v * torch.rsqrt(var + eps)).to(bf) * w1(w, bf)

    def mm(a: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
        # bf16 activations times int8 codes: every product is exact in f32,
        # the sum is f32; then the per-column scale.
        return torch.matmul(a.to(f32), w["q8"].to(f32)) * w["s"].reshape(1, -1)

    def bias(name: str) -> Any:
        return lp[name].to(f32) if name in lp else 0.0

    def rope(v: torch.Tensor) -> torch.Tensor:  # [B, n, D] f32
        half = D // 2
        rot = torch.cat([-v[..., half:], v[..., :half]], dim=-1)
        return v * cos[:, None, :].to(f32) + rot * sin[:, None, :].to(f32)

    def head_norm(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        hv = torch.mean(v * v, dim=-1, keepdim=True)
        return v * torch.rsqrt(hv + eps) * w1(w, f32)

    def capped(s: torch.Tensor) -> torch.Tensor:
        return softcap * torch.tanh(s / softcap) if softcap > 0.0 else s

    # attn norm, q/k/v in f32 (+bias, qk-norm, rope)
    h = norm_bf16(x.to(f32), lp["attn_norm"])
    q = (mm(h, lp["wq"]) + bias("bq")).reshape(B, H, D)
    k = (mm(h, lp["wk"]) + bias("bk")).reshape(B, KH, D)
    v = (mm(h, lp["wv"]) + bias("bv")).reshape(B, KH, D)
    if "q_norm" in lp:
        q = head_norm(q, lp["q_norm"])
        k = head_norm(k, lp["k_norm"])
    q = rope(q)
    k_new = rope(k).to(x.dtype)
    v_new = v.to(x.dtype)

    # attention: visible history keys t in [wlo, start), below the row's
    # page count, plus the current token; finite -1e30 mask
    start = start_pos.to(torch.int64)
    if pcounts is None:
        pcounts = history_pcounts(start_pos, BS, P)
    wlo, _ = window_page_bounds(start_pos, window or 0, BS)
    T = P * BS
    tables = block_tables.to(torch.int64).clamp(0, NB - 1)
    kh_hist = k_pool[tables].reshape(B, T, KH, D).to(f32)
    vh_hist = v_pool[tables].reshape(B, T, KH, D).to(f32)
    qg = q.reshape(B, KH, G, D)
    s_hist = capped(torch.einsum("bkgd,btkd->bkgt", qg, kh_hist) * sm_scale)
    t = torch.arange(T, device=x.device)[None, :]
    visible = (t < start[:, None]) & (t >= wlo.to(torch.int64)[:, None]) & (
        t < pcounts.to(torch.int64)[:, None] * BS
    )
    s_hist = torch.where(visible[:, None, None, :], s_hist, torch.full_like(s_hist, NEG_INF))
    kc = k_new.to(f32)
    vc = v_new.to(f32)
    s_cur = capped(torch.einsum("bkgd,bkd->bkg", qg, kc) * sm_scale)[..., None]
    s_all = torch.cat([s_hist, s_cur], dim=-1)
    m = torch.amax(s_all, dim=-1, keepdim=True)
    p = torch.exp(s_all - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.einsum("bkgt,btkd->bkgd", p[..., :T], vh_hist) + p[..., T:] * vc[:, :, None, :]
    attn = (acc / torch.clamp(l, min=1e-30)).to(bf).reshape(B, H * D)

    # o-proj (+post-norm) + residual, in f32
    y = mm(attn, lp["wo"])
    if "attn_post_norm" in lp:
        y = norm_bf16(y, lp["attn_post_norm"]).to(f32)
    xo = (x.to(f32) + y).to(x.dtype)

    # FFN
    h2 = norm_bf16(xo.to(f32), lp["mlp_norm"])
    g = mm(h2, lp["w_gate"])
    u = mm(h2, lp["w_up"])
    act = F.gelu(g, approximate="tanh") if act_fn == "gelu_tanh" else g * torch.sigmoid(g)
    gu = (act * u).to(bf)
    mlp = mm(gu, lp["w_down"])
    if "mlp_post_norm" in lp:
        mlp = norm_bf16(mlp, lp["mlp_post_norm"]).to(f32)
    x_out = (xo.to(f32) + mlp).to(x.dtype)
    return x_out, k_new, v_new


def fused_decoder_layer(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    lp: Dict[str, Any],
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    start_pos: torch.Tensor,
    *,
    eps: float,
    sm_scale: float,
    pcounts: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    act_fn: str = "silu",
    unit_offset: bool = False,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused decoder layer (the signature of the JAX
    ``_fused_decoder_layer_impl`` without its TPU knobs ``batch_block`` and
    ``interpret``). CPU tensors run the plain version; CUDA tensors launch
    the kernel, which raises rather than falls back."""
    kw = dict(eps=eps, sm_scale=sm_scale, pcounts=pcounts, window=window,
              act_fn=act_fn, unit_offset=unit_offset, softcap=softcap)
    if x.device.type == "cpu":
        return fused_decoder_layer_ref(
            x, cos, sin, lp, k_pool, v_pool, block_tables, start_pos, **kw
        )
    from dynamo_tpu_torch.ops.cuda import fused_layer as kernel

    return kernel.fused_decoder_layer(
        x, cos, sin, lp, k_pool, v_pool, block_tables, start_pos, **kw
    )
