"""Llama-family decoder over a paged KV cache — counterpart of
dynamo_tpu/models/llama.py.

Parameters are a plain dictionary in the JAX package's serving layout:
``{"embed" [V, d], "final_norm" [d], "lm_head" [d, V] (untied only),
"layers": [per-layer dict, ...]}`` with each layer's weights laid out as
the JAX ones (``wq`` [d, H·hd], ...), so the parity tests feed both packages
the same arrays. KV pools are per-layer (the JAX "layered" cache), each a
[NB, BS, KH, D] tensor in the model dtype or an int8 pool ``{"q8", "s"}``
(ops/kv_quant.py), and are updated in place.

Covered: the dense (non-MoE, non-LoRA) decoder with the family knobs of
``decoder_layer`` (qkv-bias, qk-norm, post-norms, unit-offset norms, GeGLU,
softcaps, sliding windows, Gemma-3 dual rope), ``forward_paged`` on the
layered cache with ``first_chunk``, and ``decode_multi`` with per-sequence
salts, int8 ``{"q8", "s"}`` weights (ops/quant.py), int8 KV pools on
the unfused layer (ops/kv_quant.py), and the fused-layer
decode branch of ``forward_paged`` (``use_megakernel``: one
ops/fused_layer call a layer for C = 1), and ``decode_burst``: a burst of
``decode_multi`` over the engine's device-resident slot state, the body
the runner captures as a CUDA graph, with the logits processors
(ops/logits_process.py), min_p, logprobs and top-N inside it when a burst
asks for them. Not yet: MoE, LoRA, multimodal splices.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.device import DeviceLike, resolve_device
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import logits_process
from dynamo_tpu_torch.ops.attention import (
    cache_write_index,
    dense_chunk_attention,
    paged_attention,
    sink_pool_tensor,
    write_chunk_to_cache,
)
from dynamo_tpu_torch.ops.fused_layer import fused_decoder_layer, history_pcounts
from dynamo_tpu_torch.ops.kv_quant import KVPool, is_quantized_pool, pool_values
from dynamo_tpu_torch.ops.quant import embed_lookup, lm_head as q_lm_head, qeinsum
from dynamo_tpu_torch.ops.rope import apply_rope, rope_table
from dynamo_tpu_torch.ops.sampling import (
    fold_row_keys,
    log_softmax_f32,
    pick_logprobs,
    sample_tokens,
    top_of,
)

Params = Dict[str, Any]


def _check_supported(c: ModelConfig) -> None:
    if c.is_moe:
        raise NotImplementedError("MoE layers are not ported yet")


@torch.no_grad()
def init_params(config: ModelConfig, seed: int, device: DeviceLike = None) -> Params:
    """Random-init params (scaled normal, as the JAX ``init_params``), drawn
    on the device from a ``torch.Generator`` seeded with ``seed``. The draws
    differ from JAX's for the same seed; parity tests convert the JAX
    package's parameters with models/weights.params_from_jax instead."""
    c = config
    _check_supported(c)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    hd, d, ff, H, KH = c.head_dim_, c.d_model, c.d_ff, c.n_heads, c.n_kv_heads

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * scale).to(c.dtype)

    def fill(shape, value):
        return torch.full(shape, value, device=dev, dtype=c.dtype)

    norm_fill = 0.0 if c.rmsnorm_unit_offset else 1.0
    layers: List[Params] = []
    for _ in range(c.n_layers):
        lp: Params = {
            "attn_norm": fill((d,), norm_fill),
            "wq": normal((d, H * hd), d**-0.5),
            "wk": normal((d, KH * hd), d**-0.5),
            "wv": normal((d, KH * hd), d**-0.5),
            "wo": normal((H * hd, d), (H * hd) ** -0.5),
            "mlp_norm": fill((d,), norm_fill),
            "w_gate": normal((d, ff), d**-0.5),
            "w_up": normal((d, ff), d**-0.5),
            "w_down": normal((ff, d), ff**-0.5),
        }
        if c.post_norms:
            lp["attn_post_norm"] = fill((d,), norm_fill)
            lp["mlp_post_norm"] = fill((d,), norm_fill)
        if c.qkv_bias:
            lp["bq"] = fill((H * hd,), 0.0)
            lp["bk"] = fill((KH * hd,), 0.0)
            lp["bv"] = fill((KH * hd,), 0.0)
        if c.qk_norm:
            lp["q_norm"] = fill((hd,), 1.0)
            lp["k_norm"] = fill((hd,), 1.0)
        layers.append(lp)
    params: Params = {
        "embed": normal((c.vocab_size, d), 1.0),
        "layers": layers,
        "final_norm": fill((d,), norm_fill),
    }
    if not c.tie_word_embeddings:
        params["lm_head"] = normal((d, c.vocab_size), d**-0.5)
    return params


def init_kv_cache(
    config: ModelConfig, num_blocks: int, block_size: int, device: DeviceLike = None,
    *, kv_dtype: Optional[str] = None,
) -> Tuple[List[KVPool], List[KVPool]]:
    """Zeroed per-layer K and V pools (the JAX ``init_kv_cache(layered=True,
    kv_dtype=...)``): each [NB, BS, KH, D] in the model dtype, or with
    ``kv_dtype="int8"`` an int8 pool {"q8": int8 [NB, BS, KH, D], "s":
    float32 [NB, KH, BS]} whose zero scales dequantize to exact zeros.
    Every tensor is an ops/attention.sink_pool_tensor: the first NB blocks
    of NB + 1, the spare block the sink that dropped cache writes land in
    (ops/attention.write_chunk_to_cache), outside every block table."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (None or 'int8')")
    dev = resolve_device(device)
    shape = (num_blocks, block_size, config.n_kv_heads, config.head_dim_)

    def one() -> KVPool:
        if kv_dtype == "int8":
            return {"q8": sink_pool_tensor(shape, torch.int8, dev),
                    "s": sink_pool_tensor((num_blocks, config.n_kv_heads, block_size),
                                          torch.float32, dev)}
        return sink_pool_tensor(shape, config.dtype, dev)

    k = [one() for _ in range(config.n_layers)]
    v = [one() for _ in range(config.n_layers)]
    return k, v


def _rms_norm(
    x: torch.Tensor, w: torch.Tensor, eps: float, unit_offset: bool = False
) -> torch.Tensor:
    """RMSNorm with the JAX rounding points (llama.py:272-276): normalise in
    float32, cast to x's dtype, THEN multiply by the weight."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * (1.0 + w) if unit_offset else normed * w


def _act(x: torch.Tensor, act_fn: str) -> torch.Tensor:
    if act_fn == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def decoder_layer(
    c: ModelConfig,
    lp: Params,
    win: int,  # sliding window of this layer (0 = full)
    x: torch.Tensor,  # [B, C, d]
    cos: torch.Tensor,
    sin: torch.Tensor,
    k_c: KVPool,  # this layer's pools, updated in place
    v_c: KVPool,
    block_tables: torch.Tensor,
    start_pos: torch.Tensor,
    chunk_lens: torch.Tensor,
    *,
    first_chunk: bool = False,
    cos_loc: Optional[torch.Tensor] = None,
    sin_loc: Optional[torch.Tensor] = None,
    write_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decoder layer (attention + FFN). Writes the chunk's K/V into the
    pools, then attends: densely over the chunk itself when
    ``first_chunk`` (fresh prefill), else through ``paged_attention``."""
    B, C = x.shape[:2]
    hd = c.head_dim_
    uo = c.rmsnorm_unit_offset
    sm_scale = c.query_scale**-0.5 if c.query_scale is not None else hd**-0.5
    cap = float(c.attn_logit_softcap or 0.0)

    h = _rms_norm(x, lp["attn_norm"], c.rms_norm_eps, uo)
    q = qeinsum("bcd,dh->bch", h, lp["wq"])
    k = qeinsum("bcd,dh->bch", h, lp["wk"])
    v = qeinsum("bcd,dh->bch", h, lp["wv"])
    if c.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.reshape(B, C, c.n_heads, hd)
    k = k.reshape(B, C, c.n_kv_heads, hd)
    v = v.reshape(B, C, c.n_kv_heads, hd)
    if c.qk_norm:  # per-head RMSNorm over head_dim, before RoPE
        q = _rms_norm(q, lp["q_norm"], c.rms_norm_eps, uo)
        k = _rms_norm(k, lp["k_norm"], c.rms_norm_eps, uo)
    if cos_loc is not None and win > 0:  # Gemma-3: local layers, local table
        cos, sin = cos_loc, sin_loc
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    write_chunk_to_cache(k_c, k, block_tables, start_pos, chunk_lens, write_index)
    write_chunk_to_cache(v_c, v, block_tables, start_pos, chunk_lens, write_index)

    if first_chunk:
        attn = dense_chunk_attention(
            q, k, v, chunk_lens, sm_scale=sm_scale, window=win, logit_cap=cap
        )
    else:
        attn = paged_attention(
            q, k_c, v_c, block_tables, start_pos, chunk_lens,
            sm_scale=sm_scale, window=win, logit_cap=cap,
        )
    attn_out = qeinsum("bch,hd->bcd", attn.reshape(B, C, -1), lp["wo"])
    if c.post_norms:
        attn_out = _rms_norm(attn_out, lp["attn_post_norm"], c.rms_norm_eps, uo)
    x = x + attn_out

    h = _rms_norm(x, lp["mlp_norm"], c.rms_norm_eps, uo)
    gate = _act(qeinsum("bcd,df->bcf", h, lp["w_gate"]), c.act_fn)
    up = qeinsum("bcd,df->bcf", h, lp["w_up"])
    mlp_out = qeinsum("bcf,fd->bcd", gate * up, lp["w_down"])
    if c.post_norms:
        mlp_out = _rms_norm(mlp_out, lp["mlp_post_norm"], c.rms_norm_eps, uo)
    return x + mlp_out


def embed_tokens(params: Params, config: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings with family scaling."""
    c = config
    x = embed_lookup(params["embed"], tokens, c.dtype)
    if c.embed_scale:  # Gemma: embeddings scaled by sqrt(d_model), rounded to the dtype
        # (torch.full fills on the device: no host copy, so a decode step
        # that embeds can be captured in a CUDA graph)
        x = x * torch.full((), c.d_model**0.5, dtype=c.dtype, device=x.device)
    return x


def lm_head_logits(params: Params, config: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm → vocab projection → final softcap. x: [..., d]."""
    c = config
    x = _rms_norm(x, params["final_norm"], c.rms_norm_eps, c.rmsnorm_unit_offset)
    head = params["embed"] if c.tie_word_embeddings else params["lm_head"]
    logits = q_lm_head(x, head, tied=c.tie_word_embeddings)
    if c.final_logit_softcap:
        fcap = float(c.final_logit_softcap)
        logits = fcap * torch.tanh(logits / fcap)
    return logits


def _fused_layers(
    params: Params,
    c: ModelConfig,
    x: torch.Tensor,  # [B, d]
    cos: torch.Tensor,  # [B, D]
    sin: torch.Tensor,
    cos_loc: Optional[torch.Tensor],
    sin_loc: Optional[torch.Tensor],
    k_cache: List[KVPool],
    v_cache: List[KVPool],
    block_tables: torch.Tensor,
    start_pos: torch.Tensor,
    chunk_lens: torch.Tensor,
    write_index: torch.Tensor,
) -> torch.Tensor:
    """The decode layers as fused_decoder_layer calls (JAX llama.py:481-560):
    the page counts are derived once a step, Gemma-3's local rope table
    is chosen on windowed layers, and each layer's k_new/v_new are
    scattered with the step's shared write index after the call."""
    if is_quantized_pool(k_cache[0]):
        raise ValueError("the fused layer reads bf16 pools, not int8 pools")
    sm = c.query_scale**-0.5 if c.query_scale is not None else c.head_dim_**-0.5
    pcounts = history_pcounts(start_pos, k_cache[0].shape[1], block_tables.shape[1])
    for l, win in enumerate(c.layer_windows()):
        local = cos_loc is not None and int(win) > 0
        x, k_n, v_n = fused_decoder_layer(
            x, cos_loc if local else cos, sin_loc if local else sin, params["layers"][l],
            k_cache[l], v_cache[l], block_tables, start_pos,
            eps=c.rms_norm_eps, sm_scale=sm, pcounts=pcounts, window=int(win),
            act_fn=c.act_fn, unit_offset=c.rmsnorm_unit_offset,
            softcap=float(c.attn_logit_softcap or 0.0),
        )
        write_chunk_to_cache(k_cache[l], k_n[:, None], block_tables, start_pos, chunk_lens,
                             write_index)
        write_chunk_to_cache(v_cache[l], v_n[:, None], block_tables, start_pos, chunk_lens,
                             write_index)
    return x


def forward_paged(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,  # [B, C] int
    start_pos: torch.Tensor,  # [B] int32
    chunk_lens: torch.Tensor,  # [B] int32
    block_tables: torch.Tensor,  # [B, P] int32
    k_cache: List[KVPool],  # per-layer pools, updated in place
    v_cache: List[KVPool],
    *,
    all_logits: bool = False,
    first_chunk: bool = False,
    use_megakernel: bool = False,
) -> Tuple[torch.Tensor, List[KVPool], List[KVPool]]:
    """One forward step over a chunk: returns (logits [B, V] of each row's
    last valid position — or [B, C, V] with ``all_logits`` — k_cache,
    v_cache). The chunk's K/V are written into the pools before attending,
    so one function serves prefill (large C), chunked prefill
    (start_pos > 0) and decode (C = 1). ``use_megakernel`` with C = 1 runs
    each layer as one fused_decoder_layer call (int8 weights), and scatters
    the token's K/V into the pools after each layer."""
    c = config
    _check_supported(c)
    B, C = tokens.shape
    hd = c.head_dim_
    x = embed_tokens(params, c, tokens)
    pos = start_pos.long()[:, None] + torch.arange(C, device=tokens.device)[None, :]
    cos, sin = rope_table(pos, hd, c.rope_theta, scale=c.rope_scaling_factor or 1.0)
    cos_loc = sin_loc = None
    if c.rope_local_theta is not None:
        cos_loc, sin_loc = rope_table(pos, hd, c.rope_local_theta)
    NB, BS = pool_values(k_cache[0]).shape[:2]
    write_index = cache_write_index(block_tables, start_pos, chunk_lens, C, BS, NB)
    if use_megakernel and C == 1:
        x = _fused_layers(
            params, c, x[:, 0], cos[:, 0], sin[:, 0],
            cos_loc[:, 0] if cos_loc is not None else None,
            sin_loc[:, 0] if sin_loc is not None else None,
            k_cache, v_cache, block_tables, start_pos, chunk_lens, write_index,
        )[:, None]
    else:
        for l, win in enumerate(c.layer_windows()):
            x = decoder_layer(
                c, params["layers"][l], int(win), x, cos, sin, k_cache[l], v_cache[l],
                block_tables, start_pos, chunk_lens, first_chunk=first_chunk,
                cos_loc=cos_loc, sin_loc=sin_loc, write_index=write_index,
            )
    if all_logits:
        return lm_head_logits(params, c, x), k_cache, v_cache
    last = torch.clamp(chunk_lens.long() - 1, 0, C - 1)
    x_last = x[torch.arange(B, device=x.device), last]  # [B, d]
    return lm_head_logits(params, c, x_last), k_cache, v_cache


class DecodeOut(NamedTuple):
    tokens: torch.Tensor  # [B, num_steps] sampled ids
    finite: torch.Tensor  # [B] bool: every step's logits were finite
    logits: Optional[torch.Tensor]  # [B, num_steps, V] with want_logits
    logprobs: Optional[torch.Tensor] = None  # [B, num_steps] with want_logprobs
    top_vals: Optional[torch.Tensor] = None  # [B, num_steps, N] with num_top_logprobs
    top_ids: Optional[torch.Tensor] = None  # [B, num_steps, N] int64


def decode_multi(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,  # [B] current input token per slot
    start_pos: torch.Tensor,  # [B] int32
    active: torch.Tensor,  # [B] int32 0/1
    block_tables: torch.Tensor,  # [B, P] int32
    k_cache: List[KVPool],
    v_cache: List[KVPool],
    seed: int,
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    *,
    num_steps: int,
    salts: torch.Tensor,  # [B] per-sequence sampling salt
    want_logits: bool = False,
    use_megakernel: bool = False,
    want_logprobs: bool = False,
    num_top_logprobs: int = 0,
    min_p: Optional[torch.Tensor] = None,  # [B]
    proc_params: Optional[logits_process.ProcParams] = None,
    proc_state: Optional[logits_process.ProcState] = None,  # updated IN PLACE
) -> DecodeOut:
    """``num_steps`` single-token forward + sample steps (the JAX
    ``lax.scan`` as a Python loop). Inactive rows keep their token and
    position, and their cache writes are dropped (chunk_lens = active).
    Row b's noise for the token it samples at index pos + 1 is keyed
    (seed, salts[b], pos + 1) — the index the prefill step uses for the
    first generated token, so a recompute redraws the same noise. Host
    stop conditions are applied afterwards; overshoot writes past the table
    capacity are dropped by write_chunk_to_cache.

    A step, as the JAX one (llama.py:765-806): forward; the processors
    (``proc_params``, with the counts of ``proc_state``) on the logits;
    sample (with ``min_p``); inactive rows held at their token; the
    chosen token's log-probability from the processed, unscaled logits
    (``want_logprobs``) and the ``num_top_logprobs`` best (no [B, V] pass
    when neither is asked for); the token counted into ``proc_state``."""
    toks = tokens.long()
    pos = start_pos.to(torch.int32)
    act = active.to(torch.int32)
    finite = torch.ones(tokens.shape[0], dtype=torch.bool, device=tokens.device)
    out_toks, out_logits, out_logp, out_tv, out_ti = [], [], [], [], []
    for _ in range(num_steps):
        logits, k_cache, v_cache = forward_paged(
            params, config, toks[:, None], pos, act, block_tables, k_cache, v_cache,
            use_megakernel=use_megakernel,
        )
        finite &= torch.isfinite(logits).all(dim=-1)
        if want_logits:
            out_logits.append(logits)
        if proc_params is not None:
            logits = logits_process.apply(logits, proc_params, proc_state)
        keys = fold_row_keys(seed, salts, pos + 1)
        nxt = sample_tokens(logits, temperature, top_k, top_p, min_p, row_keys=keys)
        toks = torch.where(act > 0, nxt, toks)
        if want_logprobs or num_top_logprobs > 0:
            logp = log_softmax_f32(logits)
            if want_logprobs:
                out_logp.append(pick_logprobs(logp, toks))
            if num_top_logprobs > 0:
                tv, ti = top_of(logp, num_top_logprobs)
                out_tv.append(tv)
                out_ti.append(ti)
        if proc_state is not None:
            logits_process.record_tokens(proc_state, toks, act)
        pos = pos + act
        out_toks.append(toks)
    return DecodeOut(
        tokens=torch.stack(out_toks, dim=1),
        finite=finite,
        logits=torch.stack(out_logits, dim=1) if want_logits else None,
        logprobs=torch.stack(out_logp, dim=1) if want_logprobs else None,
        top_vals=torch.stack(out_tv, dim=1) if num_top_logprobs > 0 else None,
        top_ids=torch.stack(out_ti, dim=1) if num_top_logprobs > 0 else None,
    )


# The device-resident decode slot state ``decode_burst`` reads, one row a
# slot (counterpart of the JAX runner's ``slot_state`` / ``slot_tables``,
# runner.py:392-438): name -> dtype; "tables" is [S, max_blocks_per_seq].
SLOT_STATE = {
    "tokens": torch.int64, "pos": torch.int32, "active": torch.int32,
    "temp": torch.float32, "topk": torch.int32, "topp": torch.float32,
    "salts": torch.int64, "tables": torch.int32,
}
# The processor parameters of each slot (the JAX runner's slot_state minp,
# rep, pres, freq, bias_ids, bias_vals): name -> dtype; the bias fields are
# [S, MAX_BIAS_SLOTS]. Read only by a burst with ``use_procs``.
PROC_SLOT_STATE = {
    "minp": torch.float32, "rep": torch.float32, "pres": torch.float32,
    "freq": torch.float32, "bias_ids": torch.int64, "bias_vals": torch.float32,
}


def decode_burst(
    params: Params,
    config: ModelConfig,
    state: Dict[str, torch.Tensor],  # SLOT_STATE tensors, carry updated IN PLACE
    k_cache: List[KVPool],
    v_cache: List[KVPool],
    seed: int,
    out_tokens: torch.Tensor,  # [S, num_steps] int64, written
    out_finite: torch.Tensor,  # [S] bool, written
    *,
    num_steps: int,
    width: int,
    use_megakernel: bool = False,
    proc_state: Optional[logits_process.ProcState] = None,  # with PROC_SLOT_STATE in state
    logprob_outputs: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> None:
    """One decode burst over the slot state (the body of the JAX runner's
    ``_build_decode_fn``, runner.py:700-780): ``decode_multi`` over every
    slot with the first ``width`` pages of each block table, its tokens and
    finite flags copied into ``out_tokens`` / ``out_finite``, and the carry
    (each slot's last sampled token, its position advanced by num_steps
    when active) written back into ``state["tokens"]`` / ``state["pos"]``
    where the JAX program donates and returns them. With ``proc_state``
    the processors and min_p of the state's PROC_SLOT_STATE rows apply and
    the counts advance in place; with ``logprob_outputs`` (logprobs [S, K],
    top values and ids [S, K, N]) the chosen tokens' logprobs and the top N
    are written there. It reads nothing back to the host and every tensor
    it keeps has a fixed address, so the same function runs eagerly and
    under CUDA graph capture (engines/gpu/runner.py)."""
    tables = state["tables"][:, :width].contiguous()
    procs = {}
    if proc_state is not None:
        proc_params = logits_process.ProcParams(
            rep=state["rep"], pres=state["pres"], freq=state["freq"],
            bias_ids=state["bias_ids"], bias_vals=state["bias_vals"])
        procs = dict(min_p=state["minp"], proc_state=proc_state, proc_params=proc_params)
    out = decode_multi(
        params, config, state["tokens"], state["pos"], state["active"], tables,
        k_cache, v_cache, seed, state["temp"], state["topk"], state["topp"],
        num_steps=num_steps, salts=state["salts"], use_megakernel=use_megakernel,
        want_logprobs=logprob_outputs is not None,
        num_top_logprobs=logprob_outputs[1].shape[-1] if logprob_outputs is not None else 0,
        **procs,
    )
    out_tokens.copy_(out.tokens)
    out_finite.copy_(out.finite)
    if logprob_outputs is not None:
        for buf, val in zip(logprob_outputs, (out.logprobs, out.top_vals, out.top_ids)):
            buf.copy_(val)
    state["tokens"].copy_(out.tokens[:, -1])
    state["pos"].add_(state["active"] * num_steps)
