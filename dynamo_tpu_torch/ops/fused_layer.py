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

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
_SUPPORTED_ACTS = ("silu", "gelu_tanh")
# Head dims csrc/fused_layer.cu is built for, and the most query heads a KV
# head (G) its tensor-core attention stages in shared memory (the mma's 8
# columns).
BUILT_HEAD_DIMS = (128, 256)
MAX_GROUP = 8


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
    if c.n_heads // c.n_kv_heads > MAX_GROUP:
        return (
            f"{c.n_heads // c.n_kv_heads} query heads per KV head exceed the {MAX_GROUP} "
            "the CUDA kernel's attention stages in shared memory"
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


def _attention_plain(q, k_new, v_new, k_pool, v_pool, block_tables, start_pos, pcounts, *,
                     window, sm_scale, softcap):
    """The layer's attention at the TPU kernel's points: f32 scores over
    the visible history keys t in [wlo, start), below the row's page count,
    plus the current token; finite -1e30 mask; f32 probabilities; attn =
    bf16(acc / l). q [B, H, D] f32; returns [B, H·D] bf16."""
    B, H, D = q.shape
    NB, BS, KH, _ = k_pool.shape
    P = block_tables.shape[1]
    G = H // KH
    f32 = torch.float32
    start = start_pos.to(torch.int64)
    wlo, _ = window_page_bounds(start_pos, window or 0, BS)
    T = P * BS
    tables = block_tables.to(torch.int64).clamp(0, NB - 1)
    kh_hist = k_pool[tables].reshape(B, T, KH, D).to(f32)
    vh_hist = v_pool[tables].reshape(B, T, KH, D).to(f32)
    qg = q.reshape(B, KH, G, D)

    def capped(s: torch.Tensor) -> torch.Tensor:
        return softcap * torch.tanh(s / softcap) if softcap > 0.0 else s

    s_hist = capped(torch.einsum("bkgd,btkd->bkgt", qg, kh_hist) * sm_scale)
    t = torch.arange(T, device=q.device)[None, :]
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
    return (acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16).reshape(B, H * D)


# The CUDA kernel's attention walk (csrc/fused_layer.cu): 256-key items,
# a 32 KB slot of keys a tile (SLOT_VALUES = keys x head_dim), 16 keys a
# warp.
SPLIT_KEYS = 256
SLOT_VALUES = 16384
TERMS = 3  # bf16 terms of an f32 q or probability in its product


def _attention_mma(q, k_new, v_new, k_pool, v_pool, block_tables, start_pos, pcounts, *,
                   window, sm_scale, softcap, terms=TERMS):
    """The CUDA kernel's attention arithmetic, emulated on the CPU (the
    plain version's function, other sums): each (row, KV head) walks its
    history keys from base = wlo rounded down to 16, in items of 256 keys,
    each item in tiles of SLOT_VALUES / D keys, each tile in groups of 16
    keys with an online softmax of its own (one per warp). q enters the
    score product as ``terms`` bf16 terms (hi, the rest's hi, ...) and the
    f32 probabilities enter P·V the same way (masked keys weigh exactly 0,
    l sums the f32 values);
    an item adds its groups in order, and the current token's merge adds
    the items in order. Same arguments and result as _attention_plain."""
    B, H, D = q.shape
    NB, BS, KH, _ = k_pool.shape
    P = block_tables.shape[1]
    G = H // KH
    f32, bf = torch.float32, torch.bfloat16
    SK = SLOT_VALUES // D
    KG = SK // 16

    def split_bf16(v: torch.Tensor):
        parts = []
        for _ in range(terms):
            parts.append(v.to(bf).to(f32))
            v = v - parts[-1]
        return parts

    def capped(s: torch.Tensor) -> torch.Tensor:
        return softcap * torch.tanh(s / softcap) if softcap > 0.0 else s

    out = torch.empty(B, KH, G, D, dtype=f32)
    qg = q.to(f32).reshape(B, KH, G, D)
    tables = block_tables.to(torch.int64).clamp(0, NB - 1)
    for b in range(B):
        start = int(start_pos[b])
        kend = min(start, int(pcounts[b]) * BS)
        wlo = max(start - window + 1, 0) if window and window > 0 else 0
        base = wlo // 16 * 16
        n_split = -(-(kend - base) // SPLIT_KEYS) if kend > wlo else 1
        for kh in range(KH):
            qs = split_bf16(qg[b, kh])  # terms of [G, D]
            items = []
            for split in range(n_split):
                lo = base + split * SPLIT_KEYS
                vlo, vhi = max(lo, wlo), min(lo + SPLIT_KEYS, kend)
                n_tiles = -(-(vhi - lo) // SK) if vhi > vlo else 0
                m = torch.full((KG, G), NEG_INF, dtype=f32)
                l = torch.zeros(KG, G, dtype=f32)
                acc = torch.zeros(KG, G, D, dtype=f32)
                for it in range(n_tiles):
                    keys = lo + it * SK + torch.arange(SK)
                    page = tables[b, torch.clamp(keys // BS, max=P - 1)]
                    kt = k_pool[page, keys % BS, kh].to(f32).reshape(KG, 16, D)
                    vt = v_pool[page, keys % BS, kh].to(f32).reshape(KG, 16, D)
                    vis = ((keys >= vlo) & (keys < vhi)).reshape(KG, 16, 1)
                    s = capped(sum(kt @ qj.T for qj in qs) * sm_scale)  # [KG, 16 keys, G]
                    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
                    m_new = torch.maximum(m, s.amax(dim=1))
                    alpha = torch.exp(m - m_new)
                    m = m_new
                    p = torch.where(vis, torch.exp(s - m[:, None, :]), torch.zeros_like(s))
                    l = l * alpha + p.sum(dim=1)
                    pv = sum(pj.transpose(1, 2) @ vt for pj in split_bf16(p))  # [KG, G, D]
                    acc = acc * alpha[..., None] + pv
                M = m.amax(dim=0)  # the item: its groups in order
                w = torch.exp(m - M)
                A = torch.zeros(G, D, dtype=f32)
                L = torch.zeros(G, dtype=f32)
                for j in range(KG):
                    A = A + w[j][:, None] * acc[j]
                    L = L + w[j] * l[j]
                items.append((M, L, A))
            sc = capped((qg[b, kh] @ k_new[b, kh].to(f32)) * sm_scale)  # [G]
            mm = sc.clone()
            for M, _, _ in items:
                mm = torch.maximum(mm, M)
            ll = torch.zeros(G, dtype=f32)
            A = torch.zeros(G, D, dtype=f32)
            for M, L, Ai in items:
                ws = torch.exp(M - mm)
                ll = ll + L * ws
                A = A + Ai * ws[:, None]
            pc = torch.exp(sc - mm)
            A = A + pc[:, None] * v_new[b, kh].to(f32)[None, :]
            out[b, kh] = A / torch.clamp(ll + pc, min=1e-30)[:, None]
    return out.to(bf).reshape(B, H * D)


def _layer(x, cos, sin, lp, k_pool, v_pool, block_tables, start_pos, *, eps, sm_scale,
           pcounts, window, act_fn, unit_offset, softcap, attention):
    """The layer at the TPU kernel's rounding points (fused_layer.py:269-661),
    with ``attention`` one of _attention_plain or _attention_mma."""
    B, d = x.shape
    NB, BS, KH, D = k_pool.shape
    P = block_tables.shape[1]
    H = lp["wq"]["q8"].shape[1] // D
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
    if pcounts is None:
        pcounts = history_pcounts(start_pos, BS, P)
    attn = attention(q, k_new, v_new, k_pool, v_pool, block_tables, start_pos, pcounts,
                     window=window, sm_scale=sm_scale, softcap=softcap)

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
    return _layer(x, cos, sin, lp, k_pool, v_pool, block_tables, start_pos, eps=eps,
                  sm_scale=sm_scale, pcounts=pcounts, window=window, act_fn=act_fn,
                  unit_offset=unit_offset, softcap=softcap, attention=_attention_plain)


def fused_decoder_layer_mma_ref(
    x, cos, sin, lp, k_pool, v_pool, block_tables, start_pos, *, eps: float, sm_scale: float,
    pcounts: Optional[torch.Tensor] = None, window: Optional[int] = None, act_fn: str = "silu",
    unit_offset: bool = False, softcap: float = 0.0, terms: int = TERMS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fused_decoder_layer_ref with the CUDA kernel's attention arithmetic
    (_attention_mma, q and P in ``terms`` bf16 terms) in place of the plain
    attention: the CPU check of the kernel's walk, terms and merge orders
    (the tests; CPU tensors)."""
    return _layer(x, cos, sin, lp, k_pool, v_pool, block_tables, start_pos, eps=eps,
                  sm_scale=sm_scale, pcounts=pcounts, window=window, act_fn=act_fn,
                  unit_offset=unit_offset, softcap=softcap,
                  attention=functools.partial(_attention_mma, terms=terms))


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
