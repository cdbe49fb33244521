"""Random inputs for the fused decoder layer and the int8 lm-head at given
shapes, made on a device from a seed: the cases that chip_smoke.py, the card
tests (tests/test_torch_cuda_kernels.py) and tools/fused_layer_phases.py
run the kernels on."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from dynamo_tpu_torch.ops.rope import rope_table


def q8_weight(g: torch.Generator, K: int, N: int, device: Any) -> Dict[str, torch.Tensor]:
    """int8 codes [K, N] uniform in [-127, 127] with per-column scales that
    vary by ±50 % around the ``llama.init_params`` std."""
    codes = torch.randint(-127, 128, (K, N), generator=g, device=device, dtype=torch.int8)
    scale = (torch.rand(1, N, generator=g, device=device) + 0.5) * (K**-0.5 / 73.3)
    return {"q8": codes, "s": scale}


def layer_case(B, d, H, KH, D, F, starts, *, device, BS=16, P=None, qk_norm=False, bias=False,
               post=False, unit=False, seed=0) -> Dict[str, Any]:
    """One layer's int8 weights with non-neutral norm weights and biases (a
    neutral 1 or 0 would hide a missing epilogue), pools, block tables and
    rope tables for rows at contexts ``starts``."""
    g = torch.Generator(device=device).manual_seed(seed)
    lo = -0.5 if unit else 0.5  # unit-offset norms store w - 1

    def vec(n):
        return (torch.rand(n, generator=g, device=device) + lo).to(torch.bfloat16)

    lp = {"attn_norm": vec(d), "mlp_norm": vec(d), "wq": q8_weight(g, d, H * D, device),
          "wk": q8_weight(g, d, KH * D, device), "wv": q8_weight(g, d, KH * D, device),
          "wo": q8_weight(g, H * D, d, device), "w_gate": q8_weight(g, d, F, device),
          "w_up": q8_weight(g, d, F, device), "w_down": q8_weight(g, F, d, device)}
    if qk_norm:
        lp["q_norm"], lp["k_norm"] = vec(D), vec(D)
    if bias:
        for name, n in (("bq", H * D), ("bk", KH * D), ("bv", KH * D)):
            lp[name] = (torch.randn(n, generator=g, device=device) * 0.3).to(torch.bfloat16)
    if post:
        lp["attn_post_norm"], lp["mlp_post_norm"] = vec(d), vec(d)
    P = P or max(s // BS + 1 for s in starts)
    NB = B * P + 3
    start = torch.tensor(starts, dtype=torch.int32, device=device)
    cos, sin = rope_table(start, D, 10000.0)
    return dict(
        x=(torch.randn(B, d, generator=g, device=device) * 0.5).to(torch.bfloat16),
        cos=cos, sin=sin, lp=lp,
        k=(torch.randn(NB, BS, KH, D, generator=g, device=device) * 0.5).to(torch.bfloat16),
        v=(torch.randn(NB, BS, KH, D, generator=g, device=device) * 0.5).to(torch.bfloat16),
        tables=torch.randperm(NB, generator=g, device=device)[: B * P].reshape(B, P).int(),
        start=start, shape=(B, d, H, KH, D, F, BS),
    )


def bf16_steps(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |out - ref| in bf16 steps: one step of a value v is at
    most 2^-7·|v|, so the unit is 2^-7·(|ref| + rms(ref)) — a step of the
    value, plus a step at the output's scale for values near zero, where a
    sum of many terms cancels."""
    out, ref = out.float(), ref.float()
    unit = 2.0**-7 * (ref.abs() + ref.pow(2).mean().sqrt())
    return float(((out - ref).abs() / unit).max())


def run_layer(fn: Callable, case: Dict[str, Any], call: Dict[str, Any]):
    """fn(x, cos, sin, lp, k_pool, v_pool, tables, start, **call): the
    kernel's wrapper or its plain version."""
    return fn(case["x"], case["cos"], case["sin"], case["lp"], case["k"], case["v"],
              case["tables"], case["start"], **call)


# label: (B, d, H, KH, D, F, starts, layer_case knobs, call knobs). The
# Llama-3-8B layer: 16 rows at ragged contexts with 0, page edges (16, 32)
# and a row past its table (1,600 > 94 pages x 16). The rest are the
# epilogue variants at the JAX package's test miniature.
LAYER_CASES = {
    "llama3-8b B16": (16, 4096, 32, 8, 128, 14336,
                      [0, 1, 15, 16, 32, 100, 257, 511, 640, 777, 1000, 1023, 1200, 1399, 1500,
                       1600], dict(P=94), dict(eps=1e-5, sm_scale=128**-0.5)),
    "llama miniature": (8, 256, 4, 2, 128, 512, [0, 1, 15, 16, 19, 31, 45, 63], {},
                        dict(eps=1e-5, sm_scale=128**-0.5)),
    # block size 1: a 1,101-page table, longer than the kernel keeps in
    # shared memory (pages past 1,024 are read from the table itself)
    "llama miniature, 1,101-page table": (2, 256, 4, 2, 128, 512, [1100, 5], dict(BS=1),
                                          dict(eps=1e-5, sm_scale=128**-0.5)),
    "qwen3 qk-norm": (8, 256, 4, 2, 128, 512, [0, 1, 15, 16, 19, 31, 45, 63], dict(qk_norm=True),
                      dict(eps=1e-6, sm_scale=128**-0.5)),
    "gemma2 softcap post-norms geglu unit-offset window 32": (
        8, 256, 4, 2, 128, 512, [0, 1, 15, 16, 19, 31, 45, 63], dict(post=True, unit=True),
        dict(eps=1e-6, sm_scale=128.0**-0.5, window=32, act_fn="gelu_tanh", unit_offset=True,
             softcap=30.0)),
    "gemma3 qk-norm window 24 straddling pages": (
        8, 256, 4, 2, 128, 512, [0, 20, 33, 47, 48, 55, 60, 63],
        dict(qk_norm=True, post=True, unit=True),
        dict(eps=1e-6, sm_scale=128.0**-0.5, window=24, act_fn="gelu_tanh", unit_offset=True)),
    "qwen2 qkv-bias": (8, 256, 4, 2, 128, 512, [0, 1, 15, 16, 19, 31, 45, 63], dict(bias=True),
                       dict(eps=1e-6, sm_scale=128**-0.5)),
    "head_dim 256 gemma3-like": (8, 512, 2, 1, 256, 512, [0, 15, 19, 31, 45, 48, 55, 63],
                                 dict(qk_norm=True, post=True, unit=True),
                                 dict(eps=1e-6, sm_scale=256.0**-0.5, window=24,
                                      act_fn="gelu_tanh", unit_offset=True)),
}


def make_layer_case(label: str, device: Any):
    """(case, call knobs) of LAYER_CASES[label], seeded by the label."""
    B, d, H, KH, D, F, starts, knobs, call = LAYER_CASES[label]
    return layer_case(B, d, H, KH, D, F, starts, device=device, seed=len(label), **knobs), call
