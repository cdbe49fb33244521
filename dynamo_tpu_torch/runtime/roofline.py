"""Pure-arithmetic decode roofline model — the port's copy of
dynamo_tpu/runtime/roofline.py, with the formulas unchanged and the card's
constants.

A fused decode step must stream the full (active) weight set plus every
sequence's KV history from HBM, so the step-time floor is
``bytes_moved / HBM_BW`` and the throughput roofline is
``batch / step_time``. The perf ledger (runtime/perf_ledger.py) reports a
live achieved-fraction-of-roofline gauge against it.

KV is counted at 2 bytes an element whatever the pool's dtype, as JAX's
model counts it: over int8 pools the floor is above the true one (a kept
divergence from the truth, not from JAX).

Dependency-free: ``cfg`` is duck-typed on the plain-int attributes
ModelConfig carries (d_model, n_layers, head_dim_, n_heads, n_kv_heads,
d_ff, vocab_size, tie_word_embeddings, is_moe, moe_d_ff_, n_experts,
n_experts_per_tok).
"""

from __future__ import annotations

from typing import Callable, Optional

# The card's public figures (NVIDIA H100 SXM 80 GB data sheet, at its full
# 700 W power limit), the ones chip_smoke.py's bounds use. The card they
# were checked against reads "NVIDIA H100 80GB HBM3, 700.00 W" from
# nvidia-smi --query-gpu=name,power.limit --format=csv,noheader; a card
# set below 700 W runs slower and reads a lower fraction.
H100_BW = 3.35e12  # B/s HBM3
H100_PEAK_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores


def param_count(cfg) -> int:
    """Matmul-weight parameter count from the config (analytic)."""
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.head_dim_
    H, KH, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    per_layer = d * H * hd + 2 * d * KH * hd + H * hd * d  # wq wk wv wo
    if cfg.is_moe:
        eff = cfg.moe_d_ff_
        per_layer += cfg.n_experts * 3 * d * eff + d * cfg.n_experts
    else:
        per_layer += 3 * d * ff
    total = L * per_layer + cfg.vocab_size * d
    if not cfg.tie_word_embeddings:
        total += d * cfg.vocab_size
    return total


def active_param_count(cfg) -> int:
    """Params touched per token (MoE reads only top-k experts)."""
    if not cfg.is_moe:
        return param_count(cfg)
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.head_dim_
    H, KH, eff = cfg.n_heads, cfg.n_kv_heads, cfg.moe_d_ff_
    per_layer = (
        d * H * hd + 2 * d * KH * hd + H * hd * d
        + cfg.n_experts_per_tok * 3 * d * eff + d * cfg.n_experts
    )
    total = L * per_layer + cfg.vocab_size * d
    if not cfg.tie_word_embeddings:
        total += d * cfg.vocab_size
    return total


def decode_step_bytes(
    cfg, batch: int, avg_ctx: float, quant: Optional[str]
) -> float:
    """HBM bytes one fused decode step must move: the full (active)
    weight stream plus every sequence's KV history."""
    wbytes = active_param_count(cfg) * (1 if quant == "int8" else 2)
    kv_per_tok = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim_ * 2
    return wbytes + batch * avg_ctx * kv_per_tok


def decode_roofline_toks_per_sec(
    cfg,
    batch: int,
    avg_ctx: float,
    quant: Optional[str],
    hbm_bw: float = H100_BW,
) -> float:
    """Bandwidth-roofline decode throughput (tokens/s, whole card) for
    this model/batch/context: ``batch / (step_bytes / hbm_bw)``."""
    step_bytes = decode_step_bytes(cfg, batch, avg_ctx, quant)
    if step_bytes <= 0:
        return 0.0
    return batch * hbm_bw / step_bytes


def make_roofline_fn(
    cfg, quant: Optional[str], hbm_bw: float = H100_BW
) -> Callable[[int, float], float]:
    """Close over a config: ``(batch, avg_ctx) -> roofline tok/s``. The
    shape the perf ledger stores at configure time — the ledger itself
    stays model-agnostic."""
    def fn(batch: int, avg_ctx: float) -> float:
        return decode_roofline_toks_per_sec(
            cfg, batch, avg_ctx, quant, hbm_bw=hbm_bw
        )
    return fn
