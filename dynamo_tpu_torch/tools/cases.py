"""Random inputs for the kernels at given shapes, made on a device from a
seed: the cases that chip_smoke.py, the card tests
(tests/test_torch_cuda_kernels.py) and tools/fused_layer_phases.py run the
kernels on — paged attention over bf16 and int8 pools, the fused decoder
layer, the int8 lm-head, the int8 weight-streaming product, decode
attention with bf16 probabilities and the int8 FFN."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from dynamo_tpu_torch.ops.kv_quant import quantize_kv_chunk
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


# Full-width layers of served models, on the card only (the CPU tests
# emulate every LAYER_CASES entry): Gemma-3-1B's layer at the decode of its
# engine phase — 32 rows at contexts 100-850 and one at 4,600 — on a local
# layer (512-key window, its first key inside a page) and a global one.
_GEMMA3_STARTS = [100 + 25 * i for i in range(31)] + [4600]
# The kernel against its plain version at these layers: x_out within four
# bf16 steps, and at most MODEL_PAST_ONE_SHARE of its values past one step
# (LAYER_CASES: one step everywhere). The kernel's attention sums in other
# orders (256-key items, 16-key groups, q and P in three bf16 terms), so an
# attention output may round to its bf16 neighbour, which the o-proj
# carries into x_out. The CPU emulation of that arithmetic
# (ops/fused_layer.fused_decoder_layer_mma_ref) against the plain version
# at these cases (tests/test_torch_fused_attention_mma.py): 2.41 steps at
# the local layer, 8 of 36,864 values past one step; 1.16 and 2 at the
# global one. On the card (chip_smoke.py): 1.28 at both, 4 and 9 values
# past one step, k_new bit-equal. A wrong scale, window or rope table
# moves most values by many steps.
MODEL_STEP_LIMIT = 4.0
MODEL_PAST_ONE_SHARE = 0.001
_GEMMA3_CALL = dict(eps=1e-6, sm_scale=256.0**-0.5, act_fn="gelu_tanh", unit_offset=True)
MODEL_LAYER_CASES = {
    "gemma3-1b B32 local": (32, 1152, 4, 1, 256, 6912, _GEMMA3_STARTS,
                            dict(qk_norm=True, post=True, unit=True),
                            dict(_GEMMA3_CALL, window=512)),
    "gemma3-1b B32 global": (32, 1152, 4, 1, 256, 6912, _GEMMA3_STARTS,
                             dict(qk_norm=True, post=True, unit=True), dict(_GEMMA3_CALL)),
}


def make_layer_case(label: str, device: Any):
    """(case, call knobs) of LAYER_CASES[label] or MODEL_LAYER_CASES[label],
    seeded by the label."""
    B, d, H, KH, D, F, starts, knobs, call = {**LAYER_CASES, **MODEL_LAYER_CASES}[label]
    return layer_case(B, d, H, KH, D, F, starts, device=device, seed=len(label), **knobs), call


# -- paged attention ----------------------------------------------------------


def quantize_pool(pool: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A [NB, BS, KH, D] pool as an int8 pool (ops/kv_quant.py layout):
    each token's codes and scale as write_chunk_to_cache would store them."""
    q8, s = quantize_kv_chunk(pool)  # [NB, BS, KH, D], [NB, BS, KH]
    return {"q8": q8.contiguous(), "s": s.transpose(1, 2).contiguous()}


def ragged(n: int, hi: int, seed: int, lo: int = 0) -> List[int]:
    """n context lengths drawn uniformly from [lo, hi]."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(lo, hi + 1, (n,), generator=g).tolist()


def attention_case(B, C, starts, clens, seed, *, device, H=14, KH=2, D=64, BS=16,
                   int8=False) -> Dict[str, Any]:
    """q [B, C, H, D], K/V pools of N(0, 1) bf16 values (int8 pools of the
    same values with ``int8``), shuffled block tables just long enough for
    start + C, start and chunk lengths."""
    g = torch.Generator(device=device).manual_seed(seed)
    P = (max(s + C for s in starts) + BS - 1) // BS
    NB = B * P + 8
    q = torch.randn(B, C, H, D, generator=g, device=device).to(torch.bfloat16)
    k = torch.randn(NB, BS, KH, D, generator=g, device=device).to(torch.bfloat16)
    v = torch.randn(NB, BS, KH, D, generator=g, device=device).to(torch.bfloat16)
    tables = torch.randperm(NB, generator=g, device=device)[: B * P].reshape(B, P).to(torch.int32)
    if int8:
        k, v = quantize_pool(k), quantize_pool(v)
    return dict(
        q=q, k=k, v=v, tables=tables,
        start=torch.tensor(starts, dtype=torch.int32, device=device),
        clens=torch.tensor(clens, dtype=torch.int32, device=device),
    )


QWEN_HEADS = dict(H=14, KH=2, D=64)  # Qwen2.5-0.5B: G 7
LLAMA_HEADS = dict(H=32, KH=8, D=128)  # Llama-3-8B: G 4
GEMMA2_HEADS = dict(H=8, KH=4, D=256)  # Gemma-2-2B: G 2
GEMMA3_HEADS = dict(H=4, KH=1, D=256)  # Gemma-3-1B: G 4

# label: (kernel, kind, B, C, starts (a list, or ("ragged", lo, hi)), chunk
# lengths, window, softcap, heads, seed) — bf16 pools at head_dim 256. The
# "B16 C1" and "B4 C512" cases of each geometry are the timing cases. The
# Gemma-2 cases sit at contexts of 4,000-6,600, past the 4,096-key window of
# its local layers, so the window masks: in the chunk case the first
# visible key moves through the chunk's rows (start 4,601: key 506, inside
# page 31 and inside the 64-key tile 448-511). The "boundary" cases put the
# first visible key at chosen places: one key into a page (start 4,096),
# inside a page and a tile (4,133: key 38; 5,000: key 905), and not yet past
# the window (4,095; 4,090).
D256_ATTENTION_CASES: Dict[str, Tuple] = {
    "gemma2 D256 B16 C1 window 4096 softcap 50": (
        "paged_attention_decode", "decode", 16, 1, ("ragged", 4000, 6000), [1] * 16, 4096, 50.0,
        GEMMA2_HEADS, 61),
    "gemma2 D256 B4 C512 window 4096 softcap 50": (
        "paged_attention_chunk", "chunk", 4, 512, [4000, 4601, 5200, 6000], [512, 300, 37, 1],
        4096, 50.0, GEMMA2_HEADS, 62),
    "gemma2 D256 B4 C1 window boundary": (
        "paged_attention_decode", "decode", 4, 1, [4133, 5000, 4095, 4096], [1] * 4, 4096, 50.0,
        GEMMA2_HEADS, 63),
    "gemma2 D256 B2 C40 window boundary": (
        "paged_attention_chunk", "chunk", 2, 40, [4133, 4090], [40, 17], 4096, 50.0,
        GEMMA2_HEADS, 64),
    "gemma3 D256 B16 C1 window 512": (
        "paged_attention_decode", "decode", 16, 1, ("ragged", 0, 1500), [1] * 16, 512, 0.0,
        GEMMA3_HEADS, 65),
    "gemma3 D256 B4 C512 window 512": (
        "paged_attention_chunk", "chunk", 4, 512, [512] * 4, [512, 300, 37, 1], 512, 0.0,
        GEMMA3_HEADS, 66),
    "gemma3 D256 B4 C2 window 512": (
        "paged_attention_decode", "decode", 4, 2, [0, 90, 600, 1000], [2] * 4, 512, 0.0,
        GEMMA3_HEADS, 67),
}

# label: (kernel, kind, B, C, starts, chunk lengths, window, softcap, heads,
# seed) — int8 pools at head_dim 256, Gemma-3-1B's heads (KH 1, G 4; window
# 512 on its local layers, 0 on its global ones). The "B32 C1" and "B4 C512"
# cases are the timing cases: decode at 32 sequences (the
# engine_gemma3_int8kv phase's slots) and a 512-token chunk. The windowed
# decode case mixes the engine's decode contexts (100-900) with one row at
# start 592, whose first visible key, 81, sits one key into page 5 and
# inside the 64-key tile 64-127; the global cases attend over 4,000-6,000
# keys. In the windowed chunk case the first visible key moves through the
# chunk's rows (start 4,601: key 4,090, inside page 255 and inside the
# tile 4,032-4,095). C·G = 160 in the "B2 C40" case: the 64-row layout's
# second and third row blocks; C·G = 12 in the "B4 C3" case: the decode
# wrapper's 64-row layout.
INT8_D256_ATTENTION_CASES: Dict[str, Tuple] = {
    "gemma3 int8 D256 B32 C1 window 512": (
        "paged_attention_decode_int8", "decode", 32, 1, [592] + ragged(31, 900, 81, lo=100),
        [1] * 32, 512, 0.0, GEMMA3_HEADS, 81),
    "gemma3 int8 D256 B32 C1 global": (
        "paged_attention_decode_int8", "decode", 32, 1, ("ragged", 4000, 6000), [1] * 32, 0, 0.0,
        GEMMA3_HEADS, 82),
    "gemma3 int8 D256 B4 C512 window 512": (
        "paged_attention_chunk_int8", "chunk", 4, 512, [4000, 4601, 5200, 6000],
        [512, 300, 37, 1], 512, 0.0, GEMMA3_HEADS, 83),
    "gemma3 int8 D256 B4 C512 global": (
        "paged_attention_chunk_int8", "chunk", 4, 512, [4000, 4601, 5200, 6000],
        [512, 300, 37, 1], 0, 0.0, GEMMA3_HEADS, 84),
    "gemma3 int8 D256 B2 C40 window 512": (
        "paged_attention_chunk_int8", "chunk", 2, 40, [4133, 600], [40, 17], 512, 0.0,
        GEMMA3_HEADS, 85),
    "gemma3 int8 D256 B4 C3 window 512": (
        "paged_attention_decode_int8", "decode", 4, 3, [0, 90, 600, 1000], [3] * 4, 512, 0.0,
        GEMMA3_HEADS, 86),
}

# label: (kernel, kind, B, C, starts (a list, or ("ragged", hi)), chunk
# lengths, window, softcap, heads, seed) — the int8-pool cases. The D 128
# "B32 C1" and "B4 C512" cases are the timing cases: Llama-3-8B decode at
# 32 sequences (the engine_int8kv phase's slots) and a 512-token chunk.
INT8_ATTENTION_CASES: Dict[str, Tuple] = {
    "int8 D64 B16 C1 ragged starts": (
        "paged_attention_decode_int8", "decode", 16, 1, ("ragged", 1500), [1] * 16, 0, 0.0,
        QWEN_HEADS, 41),
    "int8 D64 B4 C3 window 100 softcap 30": (
        "paged_attention_decode_int8", "decode", 4, 3, [0, 90, 400, 1000], [3] * 4, 100, 30.0,
        QWEN_HEADS, 42),
    "int8 D64 B4 C512 start 512 ragged lens": (
        "paged_attention_chunk_int8", "chunk", 4, 512, [512] * 4, [512, 300, 37, 1], 0, 0.0,
        QWEN_HEADS, 43),
    "int8 D64 B2 C40 window 64 softcap 20": (
        "paged_attention_chunk_int8", "chunk", 2, 40, [200, 37], [40, 17], 64, 20.0,
        QWEN_HEADS, 44),
    "int8 D128 B32 C1 ragged starts": (
        "paged_attention_decode_int8", "decode", 32, 1, ("ragged", 1500), [1] * 32, 0, 0.0,
        LLAMA_HEADS, 45),
    "int8 D128 B4 C2 window 100 softcap 30": (
        "paged_attention_decode_int8", "decode", 4, 2, [0, 90, 400, 1000], [2] * 4, 100, 30.0,
        LLAMA_HEADS, 46),
    "int8 D128 B4 C512 start 512 ragged lens": (
        "paged_attention_chunk_int8", "chunk", 4, 512, [512] * 4, [512, 300, 37, 1], 0, 0.0,
        LLAMA_HEADS, 47),
    "int8 D128 B2 C40 window 64 softcap 20": (
        "paged_attention_chunk_int8", "chunk", 2, 40, [200, 37], [40, 17], 64, 20.0,
        LLAMA_HEADS, 48),
}


# label: (kernel, kind, B, C, starts (a list, or ("ragged", lo, hi)), chunk
# lengths, window, softcap, heads, seed) — block size 128, each over bf16
# and over int8 pools (chip_smoke.py's bs128 phase, the card tests). A page
# of 128 keys spans two of the kernels' 64-key tiles (and at D 128 one
# decode tile of 128). Window boundaries: decode start 300 with window 100
# puts the first visible key at 201 (page 1, offset 73: the page's second
# 64-key tile); the chunk at start 230 crosses the page edge at 256, and
# with window 64 its first visible key moves from 167 to 206 (page 1,
# offsets 39-78: both tiles). The D 64 case is Qwen2.5-0.5B's heads (the
# decode layout's 256-key tile holds two pages).
BS128_ATTENTION_CASES: Dict[str, Tuple] = {
    "bs128 D128 B16 C1 ragged starts": (
        "paged_attention_decode", "decode", 16, 1, ("ragged", 0, 1500), [1] * 16, 0, 0.0,
        LLAMA_HEADS, 91),
    "bs128 D128 B4 C2 window 100 softcap 30": (
        "paged_attention_decode", "decode", 4, 2, [0, 90, 300, 1000], [2] * 4, 100, 30.0,
        LLAMA_HEADS, 92),
    "bs128 D128 B4 C512 ragged lens": (
        "paged_attention_chunk", "chunk", 4, 512, [0, 100, 300, 700], [512, 300, 37, 1], 0, 0.0,
        LLAMA_HEADS, 93),
    "bs128 D128 B2 C40 window 64 softcap 20 across a page": (
        "paged_attention_chunk", "chunk", 2, 40, [230, 37], [40, 17], 64, 20.0, LLAMA_HEADS, 94),
    "bs128 D64 B8 C1 window 100": (
        "paged_attention_decode", "decode", 8, 1, [300, 0, 127, 128, 255, 256, 700, 1500], [1] * 8,
        100, 0.0, QWEN_HEADS, 95),
}


def make_bs128_attention_case(label: str, device: Any, int8: bool):
    """(kernel name, kind, case, window, softcap) of BS128_ATTENTION_CASES[label]
    at block size 128, over int8 pools with ``int8`` (the kernel name then
    takes the ``_int8`` suffix)."""
    name, kind, B, C, starts, clens, window, cap, heads, seed = BS128_ATTENTION_CASES[label]
    if starts[0] == "ragged":
        starts = ragged(B, starts[2], seed, lo=starts[1])
    case = attention_case(B, C, starts, clens, seed, device=device, int8=int8, BS=128, **heads)
    return name + ("_int8" if int8 else ""), kind, case, window, cap


# The speculative verify's rows a sequence: spec_k + 1 at the engine's
# default spec_k of 4.
SPEC_VERIFY_C = 5
# label: (B, heads, contexts (lo, hi), int8 pools, seed) — decode attention
# (kernel #1) at the speculative verify's shape: SPEC_VERIFY_C query rows a
# sequence, every row valid, block size 16, one row a slot of the engines'
# 16. Qwen2.5-0.5B: C·G = 35 rows, the decode kernel's 64-row layout at D
# 64; Llama-3-8B: C·G = 20 at D 128, over bf16 and over int8 pools.
SPEC_VERIFY_CASES: Dict[str, Tuple] = {
    "spec verify qwen2.5-0.5b B16 C5 D64": (16, QWEN_HEADS, (100, 1300), False, 111),
    "spec verify llama3-8b B16 C5 D128": (16, LLAMA_HEADS, (100, 1300), False, 112),
    "spec verify llama3-8b int8 B16 C5 D128": (16, LLAMA_HEADS, (100, 1300), True, 113),
}


def make_spec_verify_case(label: str, device: Any):
    """(kernel name, case) of SPEC_VERIFY_CASES[label]."""
    B, heads, (lo, hi), int8, seed = SPEC_VERIFY_CASES[label]
    C = SPEC_VERIFY_C
    case = attention_case(B, C, ragged(B, hi, seed, lo=lo), [C] * B, seed, device=device,
                          int8=int8, **heads)
    return ("paged_attention_decode_int8" if int8 else "paged_attention_decode"), case


# label: (B, heads, block size, starts (a list, or ("ragged", lo, hi)),
# window, softcap, seed) — decode attention with bf16 probabilities
# (decode_packed and decode_bf16, one query token a sequence over bf16
# pools). The first is _prof_attn.py's case (the timing case), the second
# leaves B 13 (not a multiple of the prototypes' blocks of 8) at ragged
# contexts, the third is Gemma-2's heads, window and softcap at contexts of
# 4,000-6,000, the last block size 16.
PROTO_ATTENTION_CASES: Dict[str, Tuple] = {
    "llama3-8b B64 ctx 160 bs128": (64, LLAMA_HEADS, 128, [160] * 64, 0, 0.0, 101),
    "llama3-8b B13 ragged bs128": (13, LLAMA_HEADS, 128, ("ragged", 0, 1000), 0, 0.0, 102),
    "gemma2 D256 B16 window 4096 softcap 50 bs128": (16, GEMMA2_HEADS, 128, ("ragged", 4000, 6000),
                                                     4096, 50.0, 103),
    "llama3-8b B16 ragged bs16": (16, LLAMA_HEADS, 16, ("ragged", 0, 1500), 0, 0.0, 104),
}


def make_proto_attention_case(label: str, device: Any):
    """(case, window, softcap) of PROTO_ATTENTION_CASES[label]."""
    B, heads, BS, starts, window, cap, seed = PROTO_ATTENTION_CASES[label]
    if starts[0] == "ragged":
        starts = ragged(B, starts[2], seed, lo=starts[1])
    return attention_case(B, 1, starts, [1] * B, seed, device=device, BS=BS, **heads), window, cap


def ffn_case(M: int, d: int, F: int, *, device: Any, seed: int = 0):
    """(x, wg, wu, wd, sg, su, sd) of the int8 FFN as _prof_fused_ffn.py
    draws them: codes in [-127, 127), scales N(0, 0.01²), x N(0, 1) bf16."""
    g = torch.Generator(device=device).manual_seed(seed + M + d + F)

    def codes(*shape):
        return torch.randint(-127, 127, shape, generator=g, device=device, dtype=torch.int8)

    wg, wu, wd = codes(d, F), codes(d, F), codes(F, d)
    sg = torch.randn(1, F, generator=g, device=device) * 0.01
    su = torch.randn(1, F, generator=g, device=device) * 0.01
    sd = torch.randn(1, d, generator=g, device=device) * 0.01
    x = torch.randn(M, d, generator=g, device=device).to(torch.bfloat16)
    return x, wg, wu, wd, sg, su, sd


def make_int8_attention_case(label: str, device: Any):
    """(kernel name, kind, case, window, softcap) of INT8_ATTENTION_CASES[label]
    or INT8_D256_ATTENTION_CASES[label]."""
    entry = INT8_ATTENTION_CASES.get(label) or INT8_D256_ATTENTION_CASES[label]
    return _make_attention_case(entry, device, int8=True)


def make_d256_attention_case(label: str, device: Any):
    """(kernel name, kind, case, window, softcap) of D256_ATTENTION_CASES[label]."""
    return _make_attention_case(D256_ATTENTION_CASES[label], device, int8=False)


def make_chunk_case(label: str, device: Any, int8: bool):
    """(case, window, softcap) of a chunk case of D256_ATTENTION_CASES,
    INT8_ATTENTION_CASES, INT8_D256_ATTENTION_CASES or BS128_ATTENTION_CASES
    over int8 pools with ``int8``, else bf16 pools."""
    if label in BS128_ATTENTION_CASES:
        _, _, case, window, cap = make_bs128_attention_case(label, device, int8)
    else:
        entry = {**D256_ATTENTION_CASES, **INT8_ATTENTION_CASES, **INT8_D256_ATTENTION_CASES}[label]
        _, _, case, window, cap = _make_attention_case(entry, device, int8)
    return case, window, cap


# The labels of every chunk case above.
CHUNK_CASE_LABELS: List[str] = [
    label for table in (D256_ATTENTION_CASES, INT8_ATTENTION_CASES, INT8_D256_ATTENTION_CASES,
                        BS128_ATTENTION_CASES)
    for label, entry in table.items() if entry[1] == "chunk"]


def _make_attention_case(entry: Tuple, device: Any, int8: bool):
    name, kind, B, C, starts, clens, window, cap, heads, seed = entry
    if starts[0] == "ragged":
        starts = ragged(B, starts[-1], seed, lo=starts[1] if len(starts) == 3 else 0)
    case = attention_case(B, C, starts, clens, seed, device=device, int8=int8, **heads)
    return name, kind, case, window, cap


# -- the int8 weight-streaming product ------------------------------------------

# The weight shapes of one Llama-3-8B decoder layer's seven products, (K, N)
# and how many times a layer runs each.
MATMUL_SHAPES: Dict[str, Tuple[int, int, int]] = {
    "q/o 4096x4096": (4096, 4096, 2),
    "k/v 4096x1024": (4096, 1024, 2),
    "gate/up 4096x14336": (4096, 14336, 2),
    "down 14336x4096": (14336, 4096, 1),
}


# The same for one Gemma-3-1B layer (d 1,152, 4 q heads and 1 KV head of
# 256, d_ff 6,912).
GEMMA3_MATMUL_SHAPES: Dict[str, Tuple[int, int, int]] = {
    "q 1152x1024": (1152, 1024, 1),
    "k/v 1152x256": (1152, 256, 2),
    "gate/up 1152x6912": (1152, 6912, 2),
    "o 1024x1152": (1024, 1152, 1),
    "down 6912x1152": (6912, 1152, 1),
}


def matmul_case(M: int, K: int, N: int, *, device: Any, seed: int = 0) -> Dict[str, torch.Tensor]:
    """x [M, K] bf16 and an int8 weight [K, N] with per-column scales
    ({"q8", "s" [1, N]}, as quantize_q8 keeps them)."""
    g = torch.Generator(device=device).manual_seed(seed + M + K + N)
    w = q8_weight(g, K, N, device)
    x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
    return {"x": x, "q8": w["q8"], "s": w["s"]}


# The raw product against its plain version: both sum exact bf16 x int8
# products in float32, in other orders (the tensor cores' adds among them).
# The limit is 1e-5 of the sum of the terms' magnitudes, (|x| @ |w|): ~100x
# the rounding such a sum typically collects, while a 128-deep chunk left
# out or counted twice moves an output by ~10^3 times the limit.
RAW_RTOL = 1e-5


def raw_product_ok(out: torch.Tensor, x: torch.Tensor, q8: torch.Tensor,
                   ref: torch.Tensor) -> Tuple[float, bool]:
    """(max |out - ref|, within RAW_RTOL·(|x| @ |w|) everywhere)."""
    mag = torch.matmul(x.float().abs(), q8.float().abs())
    err = (out.float() - ref.float()).abs()
    return float(err.max()), bool((err <= RAW_RTOL * mag).all())


def epilogue_ok(out: torch.Tensor, raw: torch.Tensor, raw_ref: torch.Tensor, x: torch.Tensor,
                q8: torch.Tensor, s: torch.Tensor, ref: torch.Tensor) -> Tuple[float, bool]:
    """The epilogue form ``out`` of a kernel whose raw form gave ``raw``,
    against the plain version's ``ref`` (and its float32 product
    ``raw_ref``). Two conditions: ``out`` is bit for bit qeinsum's rounding
    points applied to the kernel's own sums, bf16(bf16(raw)·s) — the two
    launches sum in the same order; and it is within one bf16 step of the
    product of the plain version's, carried through the scale:
    |out - ref| <= s·(2^-7·|raw_ref| + 2·RAW_RTOL·(|x| @ |w|)) + 2^-7·|ref|
    (the product may round to the next bf16 value, each side's float32 sum
    holds the raw limit, and each side rounds once more after the scale).
    Returns (max |out - ref|, both hold)."""
    s = s.reshape(-1).float()
    exact = torch.equal(out, (raw.to(torch.bfloat16).float() * s).to(torch.bfloat16))
    mag = torch.matmul(x.float().abs(), q8.float().abs())
    err = (out.float() - ref.float()).abs()
    tol = s * (2.0**-7 * raw_ref.abs() + 2 * RAW_RTOL * mag) + 2.0**-7 * ref.float().abs()
    return float(err.max()), exact and bool((err <= tol).all())
