"""Wrapper of the hand-written fused decoder-layer kernel
(csrc/fused_layer.cu), counterpart of the TPU kernel
``_fused_decoder_layer_impl`` (dynamo_tpu/ops/pallas/fused_layer.py:712).

It checks device, dtype, shape, contiguity and alignment of every operand,
chooses the launch's plan from the shapes and the card's co-resident grid
(``plan``: the four products' K splits, the attention items a (row, KV
head) and the keys a tensor-copy box of the pools), allocates the outputs
and one scratch workspace with ``torch.empty``, and makes one cooperative
launch on the current stream. A refused launch (a grid that cannot be
co-resident, or any other error) raises; nothing falls back. The CPU path
is ops/fused_layer.fused_decoder_layer_ref.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from dynamo_tpu_torch.ops.cuda import build
from dynamo_tpu_torch.ops.fused_layer import (
    _SUPPORTED_ACTS,
    BUILT_HEAD_DIMS,
    MAX_GROUP,
    history_pcounts,
)

launch_counts: Dict[str, int] = {"fused_decoder_layer": 0}

_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# Plain (bf16) leaves: norms always, the others only for the families
# that have them (null pointers select the epilogue off).
_VECTORS = ("attn_norm", "mlp_norm", "q_norm", "k_norm", "bq", "bk", "bv",
            "attn_post_norm", "mlp_post_norm")


class _Params(ctypes.Structure):
    """csrc/fused_layer.cu's FusedLayerParams, field for field."""

    _fields_ = (
        [(n, _P) for n in ("x", "cos", "sin")]
        + [(n, _P) for n in _VECTORS]
        + [(n, _P) for n in _WEIGHTS]
        + [("s_" + n, _P) for n in _WEIGHTS]
        + [(n, _P) for n in ("k_pool", "v_pool", "tables", "start", "pcounts",
                              "x_out", "k_new", "v_new", "workspace")]
        + [(n, _I) for n in ("B", "d", "H", "KH", "D", "F", "NB", "BS", "P", "window",
                              "act", "unit_offset", "s_qkv", "s_o", "s_gu", "s_down", "n_split",
                              "box_keys")]
        + [(n, _F) for n in ("eps", "sm_scale", "softcap")]
    )


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C functions' argument and result types on a build of
    csrc/fused_layer.cu (this module's, or tools/fused_layer_phases.py's)."""
    lib.fused_decoder_layer_bf16.argtypes = [_Params, _P]
    lib.fused_decoder_layer_bf16.restype = _I
    # B d H KH D F P BS, s_qkv s_o s_gu s_down n_split box_keys
    lib.fused_layer_workspace_bytes.argtypes = [_I] * 14
    lib.fused_layer_workspace_bytes.restype = ctypes.c_longlong
    lib.fused_layer_grid.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.fused_layer_grid.restype = _I
    lib.fused_layer_cluster_probe.argtypes = [_I, _I, _P, _P]
    lib.fused_layer_cluster_probe.restype = _I
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(build.build("fused_layer").lib)
    return _lib


TILE_N = 128  # a product item's output columns (csrc/fused_layer.cu kTileN)
CHUNK_K = 128  # contracted values a staged chunk holds
ROWS = 16  # activation rows a product item takes
SPLIT_KEYS = 256  # history keys an attention item takes, at most
MAX_SPLITS = 16  # K splits of a product, at most


def choose_split(items: int, chunks: int, grid: int, mats: int = 1) -> int:
    """K splits of a product of ``items`` (column tiles x row groups, each
    ``mats`` matrices wide) over a ``grid`` of blocks: the least time in
    chunk-steps — rounds of items over the grid, times the chunks an item
    streams plus about two of its own (the ring's first copies, the halves'
    exchange, the partial sums written and added) — among splits that cut
    the chunks evenly; the fewest splits on a tie."""
    best, best_cost = 1, float("inf")
    for s in range(1, min(MAX_SPLITS, chunks) + 1):
        if chunks % s:
            continue
        cost = -(-items * s // grid) * (mats * chunks / s + 2.0)
        if cost < best_cost - 1e-9:
            best, best_cost = s, cost
    return best


def box_keys(BS: int) -> int:
    """Keys a tensor-copy box of the pools holds: the largest power of two
    up to 16 that divides the block size, so a box never crosses a page."""
    n = 16
    while BS % n:
        n //= 2
    return n


def plan(B: int, d: int, H: int, KH: int, D: int, F: int, P: int, BS: int,
         grid: int) -> Dict[str, int]:
    """The launch plan for these shapes on a ``grid`` of co-resident
    blocks: K splits of the q/k/v, o, gate/up (two matrices an item) and
    down products, attention items a (row, KV head) at most (256 keys each,
    the table's P·BS keys), and the keys a copy box of the pools holds."""
    groups = -(-B // ROWS)
    HD, KHD = H * D, KH * D
    return dict(
        s_qkv=choose_split((HD + 2 * KHD) // TILE_N * groups, d // CHUNK_K, grid),
        s_o=choose_split(d // TILE_N * groups, HD // CHUNK_K, grid),
        s_gu=choose_split(F // TILE_N * groups, d // CHUNK_K, grid, mats=2),
        s_down=choose_split(d // TILE_N * groups, F // CHUNK_K, grid),
        n_split=-(-P * BS // SPLIT_KEYS),
        box_keys=box_keys(BS),
    )


@functools.lru_cache(maxsize=64)
def grid_for(device_index: int, D: int, G: int) -> int:
    """The kernel's co-resident grid on this card (occupancy x SMs)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _library().fused_layer_grid(D, G, ctypes.byref(n))
    if rc != 0 or n.value <= 0:
        raise RuntimeError(f"fused_layer grid query failed: cudaError {rc}")
    return n.value


def cluster_probe(device: Any, cluster: int = 2) -> Dict[str, Any]:
    """Whether the card takes a cooperative launch with a thread block
    cluster dimension (a grid barrier and a cluster barrier in one kernel):
    the launch's CUDA error (0 = launched) and how many blocks ran (None
    when it did not launch)."""
    blocks = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    ran = torch.zeros(1, dtype=torch.int32, device=device)
    rc = _library().fused_layer_cluster_probe(cluster, blocks, ran.data_ptr(),
                                              torch.cuda.current_stream(device).cuda_stream)
    torch.cuda.synchronize(device)
    return {"cluster": cluster, "blocks": blocks, "launch_error": int(rc),
            "blocks_ran": int(ran.item()) if rc == 0 else None}


def _check(name: str, t: torch.Tensor, dev: torch.device, dtype: torch.dtype,
           shape: Tuple[int, ...], align: int = 16) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


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
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    if x.dim() != 2:
        raise ValueError(f"x must be [B, d], got {tuple(x.shape)}")
    B, d = x.shape
    NB, BS, KH, D = k_pool.shape
    HD = lp["wq"]["q8"].shape[1]
    F = lp["w_gate"]["q8"].shape[1]
    H = HD // D
    P = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if D not in BUILT_HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {BUILT_HEAD_DIMS}")
    if HD % D or H % KH or H // KH > MAX_GROUP:
        raise ValueError(f"q width {HD}, {KH} KV heads of {D}: unsupported grouping")
    if d % 128 or F % 128:
        raise ValueError(f"d_model {d} and d_ff {F} must be multiples of 128")
    if act_fn not in _SUPPORTED_ACTS:
        raise ValueError(f"unsupported activation {act_fn!r}")
    if pcounts is None:
        pcounts = history_pcounts(start_pos, BS, P)
    _check("x", x, dev, bf, (B, d))
    _check("cos", cos, dev, f32, (B, D))
    _check("sin", sin, dev, f32, (B, D))
    _check("k_pool", k_pool, dev, bf, (NB, BS, KH, D))
    _check("v_pool", v_pool, dev, bf, (NB, BS, KH, D))
    _check("block_tables", block_tables, dev, i32, (B, P), 4)
    _check("start_pos", start_pos, dev, i32, (B,), 4)
    _check("pcounts", pcounts, dev, i32, (B,), 4)
    shapes = {"wq": (d, HD), "wk": (d, KH * D), "wv": (d, KH * D), "wo": (HD, d),
              "w_gate": (d, F), "w_up": (d, F), "w_down": (F, d)}
    vec_len = {"attn_norm": d, "mlp_norm": d, "q_norm": D, "k_norm": D, "bq": HD,
               "bk": KH * D, "bv": KH * D, "attn_post_norm": d, "mlp_post_norm": d}
    if ("q_norm" in lp) != ("k_norm" in lp) or len({"bq", "bk", "bv"} & lp.keys()) not in (0, 3) \
            or ("attn_post_norm" in lp) != ("mlp_post_norm" in lp):
        raise ValueError("q/k norms, q/k/v biases and the two post-norms come in sets")
    p = _Params()
    for name in _WEIGHTS:
        w = lp[name]
        _check(name, w["q8"], dev, torch.int8, shapes[name])
        _check("scale of " + name, w["s"], dev, f32, (1, shapes[name][1]), 4)
        setattr(p, name, w["q8"].data_ptr())
        setattr(p, "s_" + name, w["s"].data_ptr())
    for name in _VECTORS:
        if name in lp:
            _check(name, lp[name], dev, bf, (vec_len[name],), 4)
            setattr(p, name, lp[name].data_ptr())
        else:
            setattr(p, name, None)
    lib = _library()
    x_out = torch.empty_like(x)
    k_new = torch.empty(B, KH, D, dtype=bf, device=dev)
    v_new = torch.empty(B, KH, D, dtype=bf, device=dev)
    dev_index = dev.index if dev.index is not None else torch.cuda.current_device()
    pl = plan(B, d, H, KH, D, F, P, BS, grid_for(dev_index, D, H // KH))
    nbytes = int(lib.fused_layer_workspace_bytes(B, d, H, KH, D, F, P, BS, pl["s_qkv"], pl["s_o"],
                                                 pl["s_gu"], pl["s_down"], pl["n_split"],
                                                 pl["box_keys"]))
    if nbytes < 0:
        raise RuntimeError(f"fused_decoder_layer refused the shapes B {B} d {d} H {H} KH {KH} "
                           f"D {D} F {F} P {P} BS {BS}")
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    for name, t in (("x", x), ("cos", cos), ("sin", sin), ("k_pool", k_pool),
                    ("v_pool", v_pool), ("tables", block_tables), ("start", start_pos),
                    ("pcounts", pcounts), ("x_out", x_out), ("k_new", k_new),
                    ("v_new", v_new), ("workspace", ws)):
        setattr(p, name, t.data_ptr())
    p.B, p.d, p.H, p.KH, p.D, p.F = B, d, H, KH, D, F
    p.NB, p.BS, p.P, p.window = NB, BS, P, int(window or 0)
    p.act, p.unit_offset = int(act_fn == "gelu_tanh"), int(bool(unit_offset))
    for name, value in pl.items():
        setattr(p, name, value)
    p.eps, p.sm_scale, p.softcap = float(eps), float(sm_scale), float(softcap)
    rc = lib.fused_decoder_layer_bf16(p, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_decoder_layer launch failed: cudaError {rc}")
    launch_counts["fused_decoder_layer"] += 1
    return x_out, k_new, v_new
