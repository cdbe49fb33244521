"""Model architecture config — the port's copy of dynamo_tpu/models/config.py.

The JAX package's ModelConfig imports ``jax.numpy`` for its ``dtype`` field;
this copy is field for field the same dataclass with a ``torch`` dtype, the
same ``from_hf_config`` ingest, and the same presets
(tests/test_torch_llama.py pins them to the JAX presets).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    d_ff: int = 14336
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_position_embeddings: int = 8192
    qkv_bias: bool = False  # Qwen2-style
    # Qwen3-style per-head RMSNorm on q and k (over head_dim, before RoPE).
    qk_norm: bool = False
    tie_word_embeddings: bool = False
    # MoE knobs (0 experts = dense). Covers Mixtral/Qwen-MoE/DeepSeek-lite
    # shapes: every layer's FFN becomes top-k routed experts (ops/moe.py).
    n_experts: int = 0
    n_experts_per_tok: int = 2
    moe_d_ff: Optional[int] = None  # expert hidden dim (default: d_ff)
    norm_topk_prob: bool = True
    moe_capacity_factor: float = 2.0
    eos_token_ids: List[int] = field(default_factory=list)
    bos_token_id: Optional[int] = None
    dtype: Any = torch.bfloat16
    name: str = "llama"
    # Gemma-family knobs (defaults = llama semantics):
    act_fn: str = "silu"  # "silu" | "gelu_tanh"
    rmsnorm_unit_offset: bool = False  # weight stored as (w - 1), apply 1+w
    post_norms: bool = False  # extra norms AFTER attention and FFN blocks
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model)
    attn_logit_softcap: Optional[float] = None  # cap·tanh(s/cap) on scores
    final_logit_softcap: Optional[float] = None  # same on lm_head logits
    query_scale: Optional[float] = None  # q·scale⁻⁰·⁵ (query_pre_attn_scalar)
    # Sliding-window attention: window size in tokens (None = full) applied
    # to layers where ``layer_idx % sliding_window_every == 0`` (1 = all
    # layers, Mistral-style; 2 = alternating, Gemma-2-style).
    sliding_window: Optional[int] = None
    sliding_window_every: int = 1
    # HF-style pattern (Gemma-3): layer i is WINDOWED unless
    # (i + 1) % sliding_window_pattern == 0 (i.e. every pattern-th layer is
    # global — the 5:1 local/global layout). Takes precedence over
    # sliding_window_every when set.
    sliding_window_pattern: Optional[int] = None
    # Authoritative per-layer window list (overrides every pattern knob):
    # ingested verbatim from an HF ``layer_types`` list, so aperiodic
    # layouts are honored exactly.
    layer_window_overrides: Optional[List[int]] = None
    # Gemma-3 dual-frequency RoPE: LOCAL (windowed) layers use this theta;
    # global layers use rope_theta (optionally linearly position-scaled by
    # rope_scaling_factor, the HF rope_scaling={linear, factor} dialect).
    rope_local_theta: Optional[float] = None
    rope_scaling_factor: Optional[float] = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def moe_d_ff_(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    def layer_windows(self) -> List[int]:
        """Per-layer attention window (0 = unlimited)."""
        if self.layer_window_overrides is not None:
            assert len(self.layer_window_overrides) == self.n_layers
            return list(self.layer_window_overrides)
        if not self.sliding_window:
            return [0] * self.n_layers
        if self.sliding_window_pattern:
            p = self.sliding_window_pattern
            return [
                self.sliding_window if (i + 1) % p != 0 else 0
                for i in range(self.n_layers)
            ]
        return [
            self.sliding_window if i % max(self.sliding_window_every, 1) == 0 else 0
            for i in range(self.n_layers)
        ]

    @classmethod
    def from_hf_config(cls, cfg: Dict[str, Any], name: str = "") -> "ModelConfig":
        archs = cfg.get("architectures") or [""]
        arch = archs[0].lower()
        eos = cfg.get("eos_token_id")
        if eos is None:
            eos_ids: List[int] = []
        elif isinstance(eos, list):
            eos_ids = [int(e) for e in eos]
        else:
            eos_ids = [int(eos)]
        # MoE fields across HF dialects: Mixtral (num_local_experts),
        # Qwen-MoE (num_experts + moe_intermediate_size + norm_topk_prob)
        n_experts = cfg.get("num_local_experts") or cfg.get("num_experts") or 0
        model_type = str(cfg.get("model_type", ""))
        # Gemma-family: unit-offset norms, GeGLU, scaled/tied embeddings.
        # Gemma-2 ADDS post-norms, softcaps and 1:1 local/global layers;
        # Gemma-3 swaps softcaps for qk-norm, 5:1 local/global layers and
        # dual-frequency RoPE (implemented since r5).
        gemma = "gemma" in arch or "gemma" in model_type
        gemma2 = "gemma2" in arch or model_type == "gemma2"
        # Gemma-3 (text): gemma-2 layout + qk-norm, 5:1 local/global layers
        # (sliding_window_pattern / layer_types), dual-frequency RoPE
        # (rope_local_base_freq on windowed layers), softcaps removed.
        gemma3 = "gemma3" in arch or "gemma3" in model_type
        swp = cfg.get("sliding_window_pattern") or cfg.get(
            "_sliding_window_pattern"
        )
        # (gated: a vestigial sliding_window behind use_sliding_window=false
        # must not re-enter through the layer_types path either)
        _gated_window = (
            cfg.get("sliding_window")
            if cfg.get("use_sliding_window", True)
            else None
        )
        window_overrides = None
        if cfg.get("layer_types") and _gated_window:
            # layer_types is the authoritative per-layer layout — honor it
            # VERBATIM (aperiodic lists included) instead of inferring a
            # period from it.
            window_overrides = [
                int(_gated_window) if t == "sliding_attention" else 0
                for t in cfg["layer_types"]
            ]
        if gemma3 and not swp and window_overrides is None:
            # A gemma-3 config carrying neither field would silently fall
            # through to every-layer-windowed — the garbage-logits mode the
            # old refusal existed to prevent.
            raise ValueError(
                "gemma-3 config carries neither sliding_window_pattern nor "
                "layer_types; cannot determine the local/global layer layout"
            )
        rope_scaling = cfg.get("rope_scaling") or {}
        rope_factor = (
            float(rope_scaling.get("factor"))
            if rope_scaling.get("rope_type", rope_scaling.get("type")) == "linear"
            and rope_scaling.get("factor")
            else None
        )
        # Some configs (Qwen2 dialect) carry a vestigial sliding_window with
        # an explicit use_sliding_window=false gate — honor the gate.
        sliding = (
            cfg.get("sliding_window")
            if cfg.get("use_sliding_window", True)
            else None
        )
        return cls(
            vocab_size=cfg["vocab_size"],
            d_model=cfg["hidden_size"],
            n_layers=cfg["num_hidden_layers"],
            n_heads=cfg["num_attention_heads"],
            n_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim"),
            d_ff=cfg["intermediate_size"],
            n_experts=int(n_experts),
            n_experts_per_tok=int(cfg.get("num_experts_per_tok", 2)),
            moe_d_ff=cfg.get("moe_intermediate_size"),
            norm_topk_prob=bool(cfg.get("norm_topk_prob", True)),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            rope_theta=cfg.get("rope_theta", 10000.0),
            max_position_embeddings=cfg.get("max_position_embeddings", 8192),
            qkv_bias="qwen2" in arch and "qwen3" not in arch,
            qk_norm="qwen3" in arch or model_type == "qwen3" or gemma3,
            tie_word_embeddings=cfg.get("tie_word_embeddings", gemma),
            eos_token_ids=eos_ids,
            bos_token_id=cfg.get("bos_token_id"),
            name=name or cfg.get("model_type", "llama"),
            # Gemma-2 (ref: the HF Gemma2 config dialect)
            # Prefer the modern 'hidden_activation' key ('or', not a dict
            # default: real Gemma-1 hub configs carry an explicit
            # hidden_activation: null beside hidden_act). HF forces tanh-gelu
            # for the gemma family regardless of hidden_act, so plain 'gelu'
            # and an unset gemma config both resolve to gelu_tanh.
            act_fn=(
                "gelu_tanh"
                if (
                    (cfg.get("hidden_activation") or cfg.get("hidden_act"))
                    in ("gelu_pytorch_tanh", "gelu_tanh", "gelu")
                    or (
                        gemma
                        and not cfg.get("hidden_activation")
                        and not cfg.get("hidden_act")
                    )
                )
                else "silu"
            ),
            rmsnorm_unit_offset=gemma,
            post_norms=gemma2 or gemma3,
            embed_scale=gemma,
            attn_logit_softcap=cfg.get("attn_logit_softcapping"),
            final_logit_softcap=cfg.get("final_logit_softcapping"),
            query_scale=cfg.get("query_pre_attn_scalar"),
            sliding_window=int(sliding) if sliding else None,
            sliding_window_every=2 if gemma2 else 1,
            sliding_window_pattern=(
                int(swp) if (gemma3 and swp and window_overrides is None)
                else None
            ),
            layer_window_overrides=window_overrides,
            rope_local_theta=(
                float(cfg.get("rope_local_base_freq", 10000.0))
                if gemma3 else None
            ),
            rope_scaling_factor=rope_factor,
        )

    @classmethod
    def from_model_dir(cls, path: str) -> "ModelConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_hf_config(json.load(f), name=os.path.basename(path.rstrip("/")))


# Handy known shapes for tests/benchmarks (no downloads in this environment).
def tiny_config(**overrides) -> ModelConfig:
    base = dict(
        vocab_size=512,
        d_model=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        max_position_embeddings=512,
        eos_token_ids=[2],
        dtype=torch.float32,
        name="tiny-llama",
    )
    base.update(overrides)
    return ModelConfig(**base)


def tiny_moe_config(**overrides) -> ModelConfig:
    base = dict(
        n_experts=4,
        n_experts_per_tok=2,
        moe_d_ff=128,
        name="tiny-moe",
    )
    base.update(overrides)
    return tiny_config(**base)


def mixtral_8x7b_config() -> ModelConfig:
    """Mixtral-8x7B shape (BASELINE MoE class; ref: recipes/ MoE configs)."""
    return ModelConfig(
        vocab_size=32000,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        n_experts=8,
        n_experts_per_tok=2,
        rope_theta=1000000.0,
        max_position_embeddings=32768,
        eos_token_ids=[2],
        name="mixtral-8x7b",
    )


def qwen2_500m_config() -> ModelConfig:
    """Qwen2.5-0.5B shape (SURVEY §7 stage 5 first real model)."""
    return ModelConfig(
        vocab_size=151936,
        d_model=896,
        n_layers=24,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        rope_theta=1000000.0,
        max_position_embeddings=32768,
        qkv_bias=True,
        tie_word_embeddings=True,
        eos_token_ids=[151645],
        name="qwen2.5-0.5b",
    )


def llama3_8b_config() -> ModelConfig:
    return ModelConfig(
        vocab_size=128256,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        rope_theta=500000.0,
        max_position_embeddings=8192,
        eos_token_ids=[128001, 128009],
        name="llama-3-8b",
    )


def qwen3_8b_config() -> ModelConfig:
    """Qwen3-8B shape (HF Qwen/Qwen3-8B config.json values): qk-norm,
    no qkv bias, head_dim 128 — the architecture family of the reference's
    only hard in-tree perf anchor (aiconfigurator Qwen3-32B,
    docs/performance/aiconfigurator.md:55-59)."""
    return ModelConfig(
        vocab_size=151936,
        d_model=4096,
        n_layers=36,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        rms_norm_eps=1e-6,
        rope_theta=1000000.0,
        max_position_embeddings=40960,
        qk_norm=True,
        eos_token_ids=[151645],
        name="qwen3-8b",
    )


def llama3_3b_config() -> ModelConfig:
    """Llama-3.2-3B shape (HF meta-llama/Llama-3.2-3B config.json values).
    The largest dense shape whose bf16 AND int8 forms both fit one 16 GB
    chip — the apples-to-apples proof shape for weight-only quantization."""
    return ModelConfig(
        vocab_size=128256,
        d_model=3072,
        n_layers=28,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        rope_theta=500000.0,
        max_position_embeddings=8192,
        tie_word_embeddings=True,
        eos_token_ids=[128001, 128009],
        name="llama-3.2-3b",
    )


def llama3_70b_config() -> ModelConfig:
    return ModelConfig(
        vocab_size=128256,
        d_model=8192,
        n_layers=80,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        rope_theta=500000.0,
        max_position_embeddings=8192,
        eos_token_ids=[128001, 128009],
        name="llama-3-70b",
    )


def gemma3_1b_config() -> ModelConfig:
    """Gemma-3-1B text shape (HF google/gemma-3-1b-it config.json values):
    5:1 local/global layers, dual-frequency RoPE, qk-norm."""
    return ModelConfig(
        vocab_size=262144,
        d_model=1152,
        n_layers=26,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        rms_norm_eps=1e-6,
        rope_theta=1000000.0,
        rope_local_theta=10000.0,
        max_position_embeddings=32768,
        qk_norm=True,
        tie_word_embeddings=True,
        act_fn="gelu_tanh",
        rmsnorm_unit_offset=True,
        post_norms=True,
        embed_scale=True,
        query_scale=256,
        sliding_window=512,
        sliding_window_pattern=6,
        eos_token_ids=[1, 106],
        name="gemma-3-1b",
    )


def all_presets() -> Dict[str, "ModelConfig"]:
    """Every named preset, keyed by its ``name`` (the same names as the
    JAX package's registry, so a model name means one shape in both)."""
    presets = [
        tiny_config(), tiny_moe_config(), mixtral_8x7b_config(),
        qwen2_500m_config(), llama3_8b_config(), llama3_3b_config(),
        llama3_70b_config(), qwen3_8b_config(), gemma3_1b_config(),
        gemma2_2b_config(),
    ]
    return {c.name: c for c in presets}


def gemma2_2b_config() -> ModelConfig:
    """Gemma-2-2B shape (HF google/gemma-2-2b config.json values)."""
    return ModelConfig(
        vocab_size=256000,
        d_model=2304,
        n_layers=26,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        rms_norm_eps=1e-6,
        rope_theta=10000.0,
        max_position_embeddings=8192,
        tie_word_embeddings=True,
        eos_token_ids=[1, 107],
        name="gemma-2-2b",
        act_fn="gelu_tanh",
        rmsnorm_unit_offset=True,
        post_norms=True,
        embed_scale=True,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        query_scale=256.0,
        sliding_window=4096,
        sliding_window_every=2,
    )
