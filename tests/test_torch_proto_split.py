"""The algebra of the two decode-attention kernels with bf16 probabilities
(csrc/decode_attention_proto.cu: decode_packed and decode_bf16, split over
the keys) on the CPU: ops/attention.decode_attention_bf16_split_ref cuts each
(sequence, KV head)'s visible keys into the kernels' whole-tile shares,
runs each 16-key group's online softmax with bf16 probabilities, keeps each
share's float32 (m, l, acc) and combines the shares in a fixed order. It is
held against the plain version (decode_attention_bf16_ref) and against the
TPU prototypes ``decode_packed`` and ``decode_bf16`` of _prof_attn.py under
``force_tpu_interpret_mode()``. Inputs are made from numpy seeds.

Tolerance: |a - r| <= 2e-3 + 1e-2·|r| throughout, the card's limit for the
attention kernels and tests/test_torch_proto_attention.py's against the
prototypes. All three round the probabilities to bf16 against different
running maxima (the plain version one global max, the prototypes one a
page, the emulation one a 16-key step and share), so a probability may
land a bf16 step away, and the outputs round to bf16.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.ops.cuda import decode_attention_proto as tproto
from dynamo_tpu_torch.ops.cuda import paged_attention as tkernels

ROOT = Path(__file__).resolve().parents[1]
ATOL, RTOL = 2e-3, 1e-2
NEG_INF = -1e30
SPLITS = [1, 2, 3, 7, 16]


def _bf16(a):
    return np.asarray(jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16))


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _case(B, KH, G, D, BS, starts, seed):
    """q [B, 1, KH·G, D] and pools of N(0, 1) bf16 values, shuffled tables
    one page longer than the longest start needs."""
    rng = np.random.default_rng(seed)
    P = max(starts) // BS + 2
    NB = B * P + 3
    return dict(
        q=_bf16(rng.standard_normal((B, 1, KH * G, D))),
        k=_bf16(rng.standard_normal((NB, BS, KH, D))),
        v=_bf16(rng.standard_normal((NB, BS, KH, D))),
        tables=rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32),
        start=np.asarray(starts, np.int32),
    )


def _args(c):
    return _t(c["q"]), _t(c["k"]), _t(c["v"]), _t(c["tables"]), _t(c["start"])


def _close(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert bool((err <= ATOL + RTOL * want.abs()).all()), float(err.max())


# label: (B, KH, G, D, BS, starts, window, softcap, seed)
CASES = {
    # Llama-3-8B's heads at _prof_attn.py's context 160 and block size 128:
    # decode_packed's 16-key tiles (11 of them), decode_bf16's 64-key ones
    "llama heads bs128 ctx 160": (2, 8, 4, 128, 128, [160, 97], 0, 0.0, 11),
    # block size 16 (a 64-key tile spans four pages), window 40 whose first
    # visible keys (21, 91) lie inside pages and tiles, softcap 30
    "bs16 D128 window 40 softcap 30": (3, 2, 4, 128, 16, [5, 60, 130], 40, 30.0, 12),
    # Gemma-2's heads (KH 4, G 2, D 256), softcap 50, window 100
    "gemma2 heads bs128 window 100 softcap 50": (3, 4, 2, 256, 128, [0, 127, 300], 100, 50.0,
                                                 13),
    # Gemma-3's heads (KH 1): decode_packed's tile is 64 keys too
    "gemma3 heads bs16 window 20": (3, 1, 4, 256, 16, [19, 36, 50], 20, 0.0, 14),
    # one to two tiles a sequence: most of 7 and 16 shares are empty
    "short contexts": (3, 2, 2, 128, 16, [0, 3, 20], 0, 0.0, 15),
}


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bf16"])
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("label", list(CASES))
def test_split_ref_matches_plain(label, splits, packed):
    B, KH, G, D, BS, starts, window, cap, seed = CASES[label]
    q, k, v, tables, start = _args(_case(B, KH, G, D, BS, starts, seed))
    tile = tproto.tile_keys(packed, KH)
    got, m, l, acc = tattn.decode_attention_bf16_split_ref(
        q, k, v, tables, start, window, splits=splits, tile=tile, logit_cap=cap)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 1, KH * G, D)
    _close(got, tattn.decode_attention_bf16_ref(q, k, v, tables, start, window, logit_cap=cap))
    # an empty share carries the empty state, and so zero weight
    empty = l == 0
    assert bool((m[empty] == NEG_INF).all()) and bool((acc[empty] == 0).all())
    assert bool((m[~empty] > NEG_INF).all())
    if splits == 16:  # more splits than any sequence here has tiles
        assert bool(empty.any())


def test_split_ref_keeps_its_shares_whole_tiles():
    """At _prof_attn.py's context 160 decode_packed walks 11 tiles of 16
    keys: 4 splits take 2, 3, 3 and 3 of them, so share 0 sums the rounded
    probabilities (each at most 1, its share's top key's exactly 1) of keys
    0-31 only, the others of 48 keys at most."""
    B, KH, G, D, BS, starts, window, cap, seed = CASES["llama heads bs128 ctx 160"]
    q, k, v, tables, start = _args(_case(B, KH, G, D, BS, starts, seed))
    _, m, l, _ = tattn.decode_attention_bf16_split_ref(q, k, v, tables, start, splits=4, tile=16)
    # probabilities <= 1 and at least one of them 1 (its share's max key)
    assert bool((l[0, 0] >= 1).all()) and bool((l[0, 0] <= 32).all())
    assert bool((l[1:, 0] <= 48).all())
    out1, *_ = tattn.decode_attention_bf16_split_ref(q, k, v, tables, start, splits=1, tile=64)
    _close(out1, tattn.decode_attention_bf16_ref(q, k, v, tables, start))


@pytest.fixture(scope="module")
def proto():
    """_prof_attn.py loaded by path, as tests/test_torch_proto_attention.py
    loads it; jax_compilation_cache_dir restored right after."""
    old = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("_prof_attn_split_test", ROOT / "_prof_attn.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    return mod


@pytest.mark.parametrize("kernel", ["decode_packed", "decode_bf16"])
@pytest.mark.parametrize("label", ["bs16 D128 window 40 softcap 30",
                                   "gemma2 heads bs128 window 100 softcap 50"])
def test_split_ref_matches_the_prototype(proto, kernel, label):
    """Through the TPU prototype of the same work split (Pallas, interpret
    mode) on the same inputs, at 1, 3 and 7 splits."""
    B, KH, G, D, BS, starts, window, cap, seed = CASES[label]
    c = _case(B, KH, G, D, BS, starts, seed)
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(getattr(proto, kernel)(
            *(jnp.asarray(c[n]) for n in ("q", "k", "v", "tables", "start")), window,
            batch_block=B, logit_cap=cap))
    want = torch.from_numpy(np.asarray(want, np.float32))
    tile = tproto.tile_keys(kernel == "decode_packed", KH)
    for splits in (1, 3, 7):
        got, *_ = tattn.decode_attention_bf16_split_ref(*_args(c), window, splits=splits,
                                                        tile=tile, logit_cap=cap)
        _close(got, want)


def test_tile_keys_are_the_kernels():
    """16 keys a warp's group; max(1, 4 // NH) groups a tile."""
    assert tproto.tile_keys(True, 8) == 16 and tproto.tile_keys(True, 4) == 16
    assert tproto.tile_keys(True, 2) == 32 and tproto.tile_keys(True, 1) == 64
    assert tproto.tile_keys(False, 8) == 64 and tproto.tile_keys(False, 1) == 64


def test_split_count_from_shapes():
    """From the shapes alone, over each kernel's blocks of one pass (B for
    decode_packed, B·KH for decode_bf16) at an H100's two blocks an SM
    (264): as many splits as fit the card once beside them, at most 16; 1
    where fewer than two fit, so one pass that (nearly) fills the card is
    not split."""
    assert tkernels.H100_CAPACITY == 264

    def count(B, KH, packed):
        q = torch.zeros(B, 1, KH * 4, 128, dtype=torch.bfloat16)
        k = torch.zeros(4, 16, KH, 128, dtype=torch.bfloat16)
        return tproto.split_count(q, k, packed)

    assert count(64, 8, True) == 4  # _prof_attn.py / _prof_8b.py: B 64 sequences
    assert count(64, 8, False) == 1  # 512 (sequence, head) blocks: one pass fills it
    assert count(33, 8, False) == 1 and count(264, 8, True) == 1
    assert count(200, 8, True) == 1  # 200 of 264: a second split would not fit
    assert count(16, 4, True) == 16 and count(16, 4, False) == 4  # Gemma-2's heads, B 16
    assert count(13, 8, True) == 16 and count(13, 8, False) == 2
    assert count(1, 1, False) == 16


def test_proto_splits_at_a_card_capacity():
    """At decode_bf16's four blocks an SM on an H100 (528): B 64 x KH 8 is
    one wave, so no split; decode_packed's 64 blocks at two an SM: 4."""
    assert tproto.proto_splits(512, 528) == 1 and tproto.proto_splits(64, 264) == 4
    assert tproto.proto_splits(263, 528) == 2 and tproto.proto_splits(1, 528) == 16


@pytest.mark.parametrize("splits", [0, 17])
def test_wrappers_refuse_a_split_count_out_of_range(splits):
    c = _case(2, 2, 2, 128, 16, [3, 40], seed=16)
    for fn in (tproto.decode_packed, tproto.decode_bf16):
        with pytest.raises(ValueError, match="splits"):
            fn(*_args(c), splits=splits)


def test_wrappers_take_a_forced_split_count_on_the_cpu():
    """On CPU tensors the wrappers are the plain version whatever the
    count, and count no launch."""
    c = _case(2, 2, 2, 128, 16, [3, 40], seed=17)
    want = tattn.decode_attention_bf16_ref(*_args(c), 8)
    tproto.reset_launch_counts()
    for fn in (tproto.decode_packed, tproto.decode_bf16):
        for splits in (None, 1, 5):
            assert torch.equal(fn(*_args(c), 8, splits=splits), want)
    assert tproto.launch_counts == {"decode_packed": 0, "decode_bf16": 0}


def test_wrapper_check_refuses_a_pool_off_a_16_byte_boundary():
    c = _case(2, 2, 2, 128, 16, [3, 40], seed=18)
    q, k, v, tables, start = _args(c)
    flat = torch.empty(k.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(k.shape)  # 2 bytes off
    shifted.copy_(k)
    with pytest.raises(ValueError, match="16-byte"):
        tproto.check(q, shifted, v, tables, start, True)
