"""Attention over a paged KV cache — counterpart of dynamo_tpu/ops/attention.py.

One entry point, ``paged_attention``, serves chunked prefill and decode: a
chunk of C query tokens per sequence starting at ``start_pos``, with keys and
values in a block pool indexed by per-sequence block tables. It routes as
the JAX function does (attention.py:95-121): C ≤ 8 with C·G ≤ 64 goes to the
decode kernel, everything else to the chunk kernel. Both are hand-written
CUDA (ops/cuda/paged_attention.py); on CPU tensors their wrappers run the
plain version here, ``paged_attention_ref``. Unlike the JAX package, a
kernel that fails to build or launch raises — nothing falls back quietly.

A pool is a bf16 [NB, BS, KH, D] tensor or an int8 pool
``{"q8", "s"}`` (ops/kv_quant.py); every function here takes both, and the
wrappers send int8 pools to the kernels' int8 variants.

``dense_chunk_attention`` (a fresh prompt's first chunk attends over its own
K/V, so it never reads a pool) and ``write_chunk_to_cache`` are plain
PyTorch. ``decode_attention_bf16_ref`` is the plain version of the
decode kernels with bf16 probabilities (ops/cuda/decode_attention_proto.py),
counterparts of the TPU prototypes in _prof_attn.py; no serving path calls
them. ``paged_attention_split_ref`` is the decode kernel's split over the
keys (per-split partials and their combine) and
``paged_attention_chunk_mma_ref`` the chunk kernel's tile walk on the
tensor cores, both for the tests.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dynamo_tpu_torch.ops.kv_quant import (
    KVPool,
    is_quantized_pool,
    pool_values,
    quantize_kv_chunk,
)

NEG_INF = -1e30


def paged_attention(
    q: torch.Tensor,  # [B, C, H, D]
    k_cache: KVPool,  # [NB, BS, KH, D], or an int8 pool
    v_cache: KVPool,
    block_tables: torch.Tensor,  # [B, P] int32
    start_pos: torch.Tensor,  # [B] int32 — tokens in cache before the chunk
    chunk_lens: torch.Tensor,  # [B] int32 — valid query tokens in the chunk
    *,
    sm_scale: Optional[float] = None,
    window: int = 0,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Returns [B, C, H, D]. The chunk's own K/V must already be in the
    cache; key t is visible to query offset c iff t <= start + c and, with
    ``window`` > 0, t > start + c - window. Rows past ``chunk_lens`` are
    padding: finite, never read."""
    from dynamo_tpu_torch.ops.cuda import paged_attention as kernels

    C, H = q.shape[1], q.shape[2]
    G = H // pool_values(k_cache).shape[2]
    if C <= 8 and C * G <= 64:
        return kernels.paged_attention_decode(
            q, k_cache, v_cache, block_tables, start_pos,
            sm_scale=sm_scale, window=window, logit_cap=logit_cap,
        )
    return kernels.paged_attention_chunk(
        q, k_cache, v_cache, block_tables, start_pos, chunk_lens,
        sm_scale=sm_scale, window=window, logit_cap=logit_cap,
    )


def paged_attention_ref(
    q: torch.Tensor,
    k_cache: KVPool,
    v_cache: KVPool,
    block_tables: torch.Tensor,
    start_pos: torch.Tensor,
    chunk_lens: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    window: int = 0,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Plain version: gather every table page into a dense [B, T, KH, D]
    history, then masked float32 attention — the counterpart of
    ``_paged_attention_xla_impl`` (attention.py:124-168) and the kernels'
    oracle. ``chunk_lens`` does not change valid rows (it is accepted for
    the shared signature).

    int8 pools keep the TPU kernels' dequantization points
    (pallas/paged_attention.py:139-150), as the CUDA kernels do, not the
    XLA oracle's (which dequantizes the gathered pages first): scores are
    taken on the codes and multiplied by the key's scale s_k[t] after
    ``sm_scale`` and before the softcap; the probabilities, normalised by
    the row sum of the unscaled ones, are multiplied by the value's scale
    s_v[t] before P·V. Both orders compute the same function; they differ
    in float32 rounding only."""
    B, C, H, D = q.shape
    scores, v, v_scale = _masked_scores(q, k_cache, v_cache, block_tables, start_pos, sm_scale,
                                        window, logit_cap)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale
    out = torch.einsum("bcght,btgd->bcghd", probs, v)
    return out.reshape(B, C, H, D).to(q.dtype)


def _masked_scores(q, k_cache, v_cache, block_tables, start_pos, sm_scale, window, logit_cap):
    """The plain versions' float32 scores [B, C, KH, G, T] over every table
    page (T = P·BS), scaled (and int8 pools: times s_k), softcapped and
    masked with -1e30; the gathered values [B, T, KH, D] in float32; the
    value scales [B, 1, KH, 1, T] of int8 pools, else None."""
    B, C, H, D = q.shape
    quantized = is_quantized_pool(k_cache)
    _, BS, KH, _ = pool_values(k_cache).shape
    T = block_tables.shape[1] * BS
    G = H // KH
    scale = sm_scale if sm_scale is not None else D**-0.5
    tables = block_tables.long()
    k = pool_values(k_cache)[tables].reshape(B, T, KH, D).to(torch.float32)
    v = pool_values(v_cache)[tables].reshape(B, T, KH, D).to(torch.float32)
    qg = q.reshape(B, C, KH, G, D).to(torch.float32)
    scores = torch.einsum("bcghd,btgd->bcght", qg, k) * scale  # [B,C,KH,G,T]

    def token_scales(pool):  # [NB, KH, BS] → [B, 1, KH, 1, T]
        s = pool["s"][tables].permute(0, 2, 1, 3).reshape(B, KH, T)
        return s[:, None, :, None, :]

    if quantized:
        scores = scores * token_scales(k_cache)
    if logit_cap > 0.0:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    t_pos = torch.arange(T, device=q.device)[None, None, :]
    limit = start_pos.long()[:, None, None] + torch.arange(C, device=q.device)[None, :, None]
    mask = t_pos <= limit  # [B, C, T]
    if window > 0:
        mask = mask & (t_pos > limit - window)
    scores = torch.where(mask[:, :, None, None, :], scores, torch.full_like(scores, NEG_INF))
    return scores, v, token_scales(v_cache) if quantized else None


def paged_attention_split_ref(
    q: torch.Tensor,  # [B, C, H, D], every row valid (decode)
    k_cache: KVPool,
    v_cache: KVPool,
    block_tables: torch.Tensor,
    start_pos: torch.Tensor,
    *,
    splits: int,
    tile: int,
    sm_scale: Optional[float] = None,
    window: int = 0,
    logit_cap: float = 0.0,
):
    """Plain version of the split decode kernel's algebra
    (csrc/paged_attention.cu, splits > 1): each (b, h)'s tile range — from
    the tile of its first visible key to that of its last, tiles of ``tile``
    keys — is cut into ``splits`` equal shares of whole tiles; each share
    gives float32 partials m (max score, -1e30 if every key of the share is
    masked for the row), l (sum of exp(s - m)) and acc (sum of exp(s - m) ×
    s_v × v); then out = Σ e^(m_s - M) acc_s / max(Σ e^(m_s - M) l_s, 1e-30)
    with M the largest m_s. An empty share is m = -1e30, l = 0, acc = 0.
    Keys on pages outside the walked range read as zeros, as the kernel
    loads them. Only tests use it. Returns out [B, C, H, D] in q's dtype,
    m and l [splits, B, C, H] and acc [splits, B, C, H, D]."""
    B, C, H, D = q.shape
    _, BS, KH, _ = pool_values(k_cache).shape
    P = block_tables.shape[1]
    T = P * BS
    G = H // KH
    scores, v, v_scale = _masked_scores(q, k_cache, v_cache, block_tables, start_pos, sm_scale,
                                        window, logit_cap)
    if v_scale is None:
        v_scale = torch.ones(B, 1, KH, 1, T, device=q.device)
    keys = torch.arange(T, device=q.device)

    m = torch.full((splits, B, C, KH, G), NEG_INF, device=q.device)
    l = torch.zeros(splits, B, C, KH, G, device=q.device)
    acc = torch.zeros(splits, B, C, KH, G, D, device=q.device)
    for b in range(B):
        start = int(start_pos[b])
        # the kernel's walk (paged_attention.cu, rows 0 .. C·G - 1 of one block)
        last_key = max(start + C - 1, 0)
        last_page = min(last_key // BS, P - 1)
        first_key = max(start - window + 1, 0) if window > 0 else 0
        first_page = first_key // BS
        key_end = min((last_key // BS + 1) * BS, T)
        tile_first = first_key // tile
        n_tiles = (min(last_key, key_end - 1) // tile - tile_first + 1
                   if first_page <= last_page else 0)
        loaded = (keys // BS >= first_page) & (keys // BS <= last_page)
        v_b = v[b] * loaded[:, None, None]  # [T, KH, D]
        for s in range(splits):
            k0 = (tile_first + s * n_tiles // splits) * tile
            k1 = (tile_first + (s + 1) * n_tiles // splits) * tile
            if k1 == k0:
                continue
            n = max(0, min(k1, T) - k0)  # keys of the share inside the table; the
            sc = torch.full((C, KH, G, k1 - k0), NEG_INF, device=q.device)  # rest: masked,
            sc[..., :n] = scores[b, ..., k0:k0 + n]  # zero scales and values
            vs = torch.zeros(1, KH, 1, k1 - k0, device=q.device)
            vs[..., :n] = v_scale[b, ..., k0:k0 + n]
            vv = torch.zeros(k1 - k0, KH, D, device=q.device)
            vv[:n] = v_b[k0:k0 + n]
            m[s, b] = sc.amax(dim=-1)
            p = torch.exp(sc - m[s, b][..., None])
            l[s, b] = p.sum(dim=-1)
            acc[s, b] = torch.einsum("cght,tgd->cghd", p * vs, vv)
    big = m.amax(dim=0)
    w = torch.exp(m - big)
    out = (w[..., None] * acc).sum(dim=0) / (w * l).sum(dim=0).clamp_min(1e-30)[..., None]
    return (out.reshape(B, C, H, D).to(q.dtype), m.reshape(splits, B, C, H),
            l.reshape(splits, B, C, H), acc.reshape(splits, B, C, H, D))


CHUNK_TILE = 64  # keys a tile of the chunk kernel walks


CHUNK_ROWS = 64  # query rows a block of the chunk kernel holds


def paged_attention_chunk_mma_ref(
    q: torch.Tensor,  # [B, C, H, D]
    k_cache: KVPool,
    v_cache: KVPool,
    block_tables: torch.Tensor,
    start_pos: torch.Tensor,
    chunk_lens: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    window: int = 0,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Plain emulation of the chunk kernel's algebra on the tensor cores
    (csrc/paged_attention.cu, paged_attention_chunk_kernel), for the tests.
    Rows (c, g), c-major, in blocks of 64 of one (b, h); a block whose rows
    are all past ``chunk_lens`` is zeros. A block walks 64-key tiles from
    the tile of its first row's first visible key (start + c_lo - W + 1,
    or 0 without a window) to that of its last valid row's causal limit;
    keys on pages outside the walked pages (or past the table) read as
    zeros and are masked. Per tile, in walk order: float32 scores × sm_scale
    (× s_k with int8 pools), the softcap, the causal and window masks
    (-1e30); the online softmax (running max m, sum l of the unscaled
    probabilities, the accumulator rescaled by e^(m_old - m_new)); the
    probabilities × s_v (int8 pools), split into hi = bf16(p) and lo =
    bf16(p - hi), and hi·V + lo·V added to the float32 accumulator. out =
    acc / max(l, 1e-30) in q's dtype. Only tests use it."""
    B, C, H, D = q.shape
    quantized = is_quantized_pool(k_cache)
    _, BS, KH, _ = pool_values(k_cache).shape
    P = block_tables.shape[1]
    G = H // KH
    T = P * BS
    scale = sm_scale if sm_scale is not None else D**-0.5
    tables = block_tables.long()
    pad = (T // CHUNK_TILE + 2) * CHUNK_TILE - T  # tiles may run past the table: zeros
    k = pool_values(k_cache)[tables].reshape(B, T, KH, D).to(torch.float32)
    v = pool_values(v_cache)[tables].reshape(B, T, KH, D).to(torch.float32)
    k = torch.cat([k, k.new_zeros(B, pad, KH, D)], dim=1)
    v = torch.cat([v, v.new_zeros(B, pad, KH, D)], dim=1)
    if quantized:
        def token_scales(pool):  # [NB, KH, BS] -> [B, T + pad, KH]
            sc = pool["s"][tables].permute(0, 2, 1, 3).reshape(B, KH, T).transpose(1, 2)
            return torch.cat([sc, sc.new_zeros(B, pad, KH)], dim=1)

        k_s, v_s = token_scales(k_cache), token_scales(v_cache)
    qf = q.to(torch.float32)
    out = torch.zeros(B, C, H, D, dtype=torch.float32)
    rows_all, block_rows = C * G, CHUNK_ROWS
    for b in range(B):
        start, clen = int(start_pos[b]), int(chunk_lens[b])
        for h in range(KH):
            for r0 in range(0, rows_all, block_rows):
                nrows = min(block_rows, rows_all - r0)
                if r0 // G >= clen:
                    continue  # every row is chunk padding: zeros
                r = torch.arange(r0, r0 + nrows)
                c_idx, g_idx = r // G, r % G
                qb = qf[b, c_idx, h * G + g_idx]  # [nrows, D]
                limit = start + c_idx  # [nrows]
                c_lo, c_hi = r0 // G, min((r0 + nrows - 1) // G, clen - 1)
                last_key = max(start + c_hi, 0)
                last_page = min(last_key // BS, P - 1)
                first_key = max(start + c_lo - window + 1, 0) if window > 0 else 0
                first_page = first_key // BS
                key_end = min((last_key // BS + 1) * BS, T)
                tile_first = first_key // CHUNK_TILE
                n_tiles = (min(last_key, key_end - 1) // CHUNK_TILE - tile_first + 1
                           if first_page <= last_page else 0)
                m = torch.full((nrows,), NEG_INF)
                l = torch.zeros(nrows)
                acc = torch.zeros(nrows, D)
                for it in range(n_tiles):
                    kp = torch.arange(CHUNK_TILE) + (tile_first + it) * CHUNK_TILE
                    page = kp // BS
                    loaded = ((page >= first_page) & (page <= last_page)).float()
                    kt = k[b, kp, h] * loaded[:, None]
                    vt = v[b, kp, h] * loaded[:, None]
                    sc = qb @ kt.T * scale  # [nrows, 64]
                    if quantized:
                        sc = sc * (k_s[b, kp, h] * loaded)[None]
                    if logit_cap > 0.0:
                        sc = logit_cap * torch.tanh(sc / logit_cap)
                    visible = (kp[None] <= limit[:, None]) & (kp[None] < key_end)
                    if window > 0:
                        visible = visible & (kp[None] > limit[:, None] - window)
                    sc = torch.where(visible, sc, torch.full_like(sc, NEG_INF))
                    m_new = torch.maximum(m, sc.amax(dim=1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    l = l * alpha + p.sum(dim=1)
                    m = m_new
                    if quantized:
                        p = p * (v_s[b, kp, h] * loaded)[None]
                    hi = p.to(torch.bfloat16).to(torch.float32)
                    lo = (p - hi).to(torch.bfloat16).to(torch.float32)
                    acc = acc * alpha[:, None] + (hi @ vt + lo @ vt)
                out[b, c_idx, h * G + g_idx] = acc / l.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def decode_attention_bf16_ref(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [NB, BS, KH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, P] int32
    start_pos: torch.Tensor,  # [B] int32
    window: int = 0,
    *,
    sm_scale: Optional[float] = None,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Plain version of decode attention at the rounding points of the TPU
    prototypes ``decode_packed`` and ``decode_bf16`` (_prof_attn.py:22-107,
    :244-308), which compute this one function in two work splits (the
    kernels of ops/cuda/decode_attention_proto.py). Key t is visible to
    sequence b iff t <= start_pos[b] and, with ``window`` > 0,
    t > start_pos[b] - window. q, K and V as bf16 operands (each product
    exact in float32), float32 scores × ``sm_scale``, the optional softcap,
    the finite -1e30 mask; probabilities exp(s - max) rounded to bf16, and
    both the row sum and P·V taken over the rounded values;
    out = bf16(P·V / max(sum, 1e-30)). The prototypes run an online
    softmax page by page; this takes one max over all keys, so its bf16
    roundings of the probabilities fall at other points (the outputs agree
    within a bf16 step). Unlike ``paged_attention_ref`` (float32
    probabilities), this is the function the prototypes compute."""
    B, C, H, D = q.shape
    if C != 1:
        raise ValueError(f"decode attention takes one query token a sequence, got C = {C}")
    _, BS, KH, _ = k_cache.shape
    T = block_tables.shape[1] * BS
    G = H // KH
    scale = sm_scale if sm_scale is not None else D**-0.5
    bf = torch.bfloat16
    tables = block_tables.long()
    k = k_cache[tables].reshape(B, T, KH, D).to(bf).to(torch.float32)
    v = v_cache[tables].reshape(B, T, KH, D).to(bf).to(torch.float32)
    qg = q.reshape(B, KH, G, D).to(bf).to(torch.float32)
    s = torch.einsum("bhgd,bthd->bhgt", qg, k) * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    t_pos = torch.arange(T, device=q.device)[None, :]
    start = start_pos.long()[:, None]
    visible = t_pos <= start
    if window > 0:
        visible = visible & (t_pos > start - window)
    s = torch.where(visible[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(bf).to(torch.float32)
    out = torch.einsum("bhgt,bthd->bhgd", p, v) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, 1, H, D).to(q.dtype)


PROTO_STEP = 16  # keys a warp of decode_packed / decode_bf16 takes at a time


def decode_attention_bf16_split_ref(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [NB, BS, KH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, P] int32
    start_pos: torch.Tensor,  # [B] int32
    window: int = 0,
    *,
    splits: int,
    tile: int,
    sm_scale: Optional[float] = None,
    logit_cap: float = 0.0,
):
    """Plain emulation of the walk of the kernels ``decode_packed`` and
    ``decode_bf16`` (csrc/decode_attention_proto.cu), for the tests. Per
    (sequence, KV head): the visible keys [first, last] (first = start - W
    + 1 with a window, else 0; last = min(start, P·BS - 1)); the tiles of
    ``tile`` keys from first's to last's, cut into ``splits`` equal shares
    of whole tiles; within a share, key group j (keys 16j .. 16j + 15 of
    each tile) runs its own online softmax over its 16-key steps in walk
    order: scores × sm_scale, the softcap, -1e30 outside [first, last]
    (where the values read as zeros), m_new = max(m, step max), bf16
    probabilities exp(s - m_new), l = l·alpha + their sum, acc = acc·alpha
    + P·V. The groups of a share are added in order (weights e^(m_j - M)),
    giving the share's float32 (m, l, acc); an empty share is (-1e30, 0, 0).
    Then out = Σ e^(m_s - M) acc_s / max(Σ e^(m_s - M) l_s, 1e-30) over the
    shares in order, in q's dtype. Returns out [B, 1, H, D], m and l
    [splits, B, H], acc [splits, B, H, D]."""
    B, C, H, D = q.shape
    if C != 1:
        raise ValueError(f"decode attention takes one query token a sequence, got C = {C}")
    _, BS, KH, _ = k_cache.shape
    T = block_tables.shape[1] * BS
    G = H // KH
    scale = sm_scale if sm_scale is not None else D**-0.5
    bf, f32 = torch.bfloat16, torch.float32
    tables = block_tables.long()
    pad = (T // tile + 2) * tile  # tiles may run past the table: masked zeros
    k = k_cache[tables].reshape(B, T, KH, D).to(bf).to(f32)
    v = v_cache[tables].reshape(B, T, KH, D).to(bf).to(f32)
    qg = q.reshape(B, KH, G, D).to(bf).to(f32)
    keys = torch.arange(pad, device=q.device)
    m = torch.full((splits, B, KH, G), NEG_INF, device=q.device)
    l = torch.zeros(splits, B, KH, G, device=q.device)
    acc = torch.zeros(splits, B, KH, G, D, device=q.device)
    for b in range(B):
        start = int(start_pos[b])
        first = max(start - window + 1, 0) if window > 0 else 0
        last = min(start, T - 1)
        tile_first = first // tile
        n_all = last // tile - tile_first + 1 if last >= first else 0
        s = torch.einsum("hgd,thd->hgt", qg[b], k[b]) * scale  # [KH, G, T]
        if logit_cap > 0.0:
            s = logit_cap * torch.tanh(s / logit_cap)
        s = torch.nn.functional.pad(s, (0, pad - T))
        vb = torch.nn.functional.pad(v[b], (0, 0, 0, 0, 0, pad - T))
        visible = (keys >= first) & (keys <= last)
        s = torch.where(visible, s, torch.full_like(s, NEG_INF))
        vb = vb * visible[:, None, None]
        for sp in range(splits):
            t0 = tile_first + sp * n_all // splits
            t1 = tile_first + (sp + 1) * n_all // splits
            if t1 == t0:
                continue
            groups = []
            for j in range(tile // PROTO_STEP):
                mg = torch.full((KH, G), NEG_INF, device=q.device)
                lg = torch.zeros(KH, G, device=q.device)
                ag = torch.zeros(KH, G, D, device=q.device)
                for t in range(t0, t1):
                    k0 = t * tile + j * PROTO_STEP
                    sc = s[..., k0:k0 + PROTO_STEP]
                    m_new = torch.maximum(mg, sc.amax(dim=-1))
                    alpha = torch.exp(mg - m_new)
                    p = torch.exp(sc - m_new[..., None]).to(bf).to(f32)
                    lg = lg * alpha + p.sum(dim=-1)
                    ag = ag * alpha[..., None] + torch.einsum(
                        "hgt,thd->hgd", p, vb[k0:k0 + PROTO_STEP])
                    mg = m_new
                groups.append((mg, lg, ag))
            M = torch.stack([g[0] for g in groups]).amax(dim=0)
            for mg, lg, ag in groups:  # in order, as the kernel adds its key groups
                w = torch.exp(mg - M)
                l[sp, b] = l[sp, b] + w * lg
                acc[sp, b] = acc[sp, b] + w[..., None] * ag
            m[sp, b] = M
    big = m.amax(dim=0)
    num = torch.zeros(B, KH, G, D, device=q.device)
    den = torch.zeros(B, KH, G, device=q.device)
    for sp in range(splits):  # in order, as the combine adds the splits
        w = torch.exp(m[sp] - big)
        num = num + w[..., None] * acc[sp]
        den = den + w * l[sp]
    out = (num / den.clamp_min(1e-30)[..., None]).reshape(B, 1, H, D).to(q.dtype)
    return (out, m.reshape(splits, B, H), l.reshape(splits, B, H),
            acc.reshape(splits, B, H, D))


def dense_chunk_attention(
    q: torch.Tensor,  # [B, C, H, D]
    k: torch.Tensor,  # [B, C, KH, D] — the chunk's own K
    v: torch.Tensor,  # [B, C, KH, D]
    chunk_lens: torch.Tensor,  # [B]
    *,
    sm_scale: Optional[float] = None,
    window: int = 0,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """First-chunk attention (start_pos == 0): the whole history is the
    chunk itself, so attend over it directly instead of reading the pages
    just written. Padding keys (>= chunk_lens) are masked with the finite
    -1e30 sentinel, so a padding row with no visible key averages instead
    of turning into NaN (attention.py:219-224). Returns [B, C, H, D]."""
    B, C, H, D = q.shape
    KH = k.shape[2]
    scale = sm_scale if sm_scale is not None else D**-0.5
    if KH != H:  # GQA: repeat kv heads into query-head groups
        rep = H // KH
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qf = q.to(torch.float32).transpose(1, 2)  # [B, H, C, D]
    kf = k.to(torch.float32).transpose(1, 2)
    vf = v.to(torch.float32).transpose(1, 2)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    rows = torch.arange(C, device=q.device)[:, None]
    cols = torch.arange(C, device=q.device)[None, :]
    mask = cols <= rows
    if window > 0:
        mask = mask & (cols > rows - window)
    valid = cols[None] < chunk_lens.long()[:, None, None]  # [B, 1, C]
    s = torch.where((mask[None] & valid)[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return out.transpose(1, 2).to(q.dtype)


def cache_write_index(
    block_tables: torch.Tensor,  # [B, P]
    start_pos: torch.Tensor,  # [B]
    chunk_lens: torch.Tensor,  # [B]
    chunk_len: int,  # C
    block_size: int,
    num_blocks: int,  # NB: the sink slot is NB·BS
) -> torch.Tensor:
    """Where a [B, C] chunk lands in the pool: [B·C] int64 flat pool slots
    block·BS + offset, with a shape that follows from B and C alone and no
    read back to the host. Padding positions (c >= chunk_lens) and
    positions past the table's capacity (decode overshoot past a stop) go
    to the sink slot NB·BS, never clamped onto a live slot: the JAX package
    drops them with an out-of-range index and ``mode="drop"``
    (attention.py:250-257), which torch indexing does not have. One index
    serves every layer of a forward step."""
    B, P = block_tables.shape
    c_off = torch.arange(chunk_len, device=block_tables.device)[None, :]
    pos = start_pos.long()[:, None] + c_off  # [B, C]
    keep = (c_off < chunk_lens.long()[:, None]) & (pos < P * block_size)
    page = torch.clamp(pos // block_size, 0, P - 1)
    blk = torch.gather(block_tables.long(), 1, page)
    dest = torch.where(keep, blk * block_size + pos % block_size, num_blocks * block_size)
    return dest.reshape(-1)


def sink_pool_tensor(shape: Tuple[int, ...], dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """Zeros of ``shape`` ([NB, ...]: a pool's values, or an int8 pool's
    scales) as the first NB blocks of an allocation of NB + 1. The spare
    block is the pool's sink: ``write_chunk_to_cache`` sends dropped rows
    there, and no block table reaches it. The tensor holds the whole
    allocation as ``.sink_full``; a tensor without it (a copy, a clone, a
    view made elsewhere) is refused by ``write_chunk_to_cache``."""
    full = torch.zeros((shape[0] + 1, *shape[1:]), dtype=dtype, device=device)
    pool = full[:-1]
    pool.sink_full = full
    return pool


def copy_to_sink_pool(pool: KVPool) -> KVPool:
    """A copy of ``pool`` (a tensor, or an int8 pool's {"q8", "s"}) made of
    ``sink_pool_tensor``s: how a pool made elsewhere gets its sink."""
    def one(t: torch.Tensor) -> torch.Tensor:
        out = sink_pool_tensor(tuple(t.shape), t.dtype, t.device)
        out.copy_(t)
        return out

    return {k: one(v) for k, v in pool.items()} if isinstance(pool, dict) else one(pool)


def _sink_full(t: torch.Tensor) -> torch.Tensor:
    full = getattr(t, "sink_full", None)
    if full is None:
        raise ValueError("the KV pool has no sink block: make pools with "
                         "models/llama.init_kv_cache or ops/attention.copy_to_sink_pool")
    return full


def write_chunk_to_cache(
    cache: KVPool,
    chunk: torch.Tensor,  # [B, C, KH, D]
    block_tables: torch.Tensor,
    start_pos: torch.Tensor,
    chunk_lens: torch.Tensor,
    index: Optional[torch.Tensor] = None,
) -> KVPool:
    """Scatter a chunk of K or V into its pages, in place (the JAX function
    returns a new pool; the port updates the one it was given and returns
    it), with a scatter of fixed shape, so a decode step can be captured in
    a CUDA graph (pass a precomputed ``cache_write_index`` to share it
    across layers). Padding positions and positions past the table
    capacity are dropped into the pool's sink block (``sink_pool_tensor``;
    a pool without one raises), so no byte of the NB blocks that a kept
    row does not write changes, and only the sink's bytes depend on the
    order of the writes. An int8 pool takes the written tokens' codes and
    scales (ops/kv_quant.quantize_kv_chunk): codes at the same slots,
    scales at ``s[block, :, slot]`` (attention.py:258-263)."""
    B, C = chunk.shape[:2]
    values = pool_values(cache)
    NB, BS = values.shape[:2]
    if index is None:
        index = cache_write_index(block_tables, start_pos, chunk_lens, C, BS, NB)
    rows = chunk.reshape(B * C, *chunk.shape[2:])
    flat = _sink_full(values).view((NB + 1) * BS, *values.shape[2:])
    if not is_quantized_pool(cache):
        flat.index_copy_(0, index, rows.to(values.dtype))
        return cache
    q8, s = quantize_kv_chunk(rows)  # [n, KH, D], [n, KH]
    flat.index_copy_(0, index, q8)
    _sink_full(cache["s"])[index // BS, :, index % BS] = s
    return cache
