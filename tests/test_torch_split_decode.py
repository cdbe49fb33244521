"""The algebra of the split decode kernel (csrc/paged_attention.cu with
splits > 1, flash-decoding) on the CPU: ops/attention.paged_attention_split_ref
cuts each (sequence, KV head)'s tile range into equal shares of whole tiles,
as the kernel does, takes each share's float32 partials (m, l, acc) and
combines them. It is held against paged_attention_ref and, through the
same route as tests/test_torch_ops.py and tests/test_torch_kv_quant.py,
against the JAX decode kernel in interpret mode. Inputs are made from numpy
seeds.

Tolerances:
  - against paged_attention_ref: 1e-5 absolute and relative. Both compute
    softmax attention in float32 over the same values, the split version
    with per-share maxima and sums, so they differ in rounding only (~4e-7
    seen at outputs ~0.1).
  - against the Pallas decode kernel in interpret mode: 1e-4, the limit
    tests/test_torch_ops.py and tests/test_torch_kv_quant.py hold the
    one-pass plain version to against it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas.paged_attention import paged_attention_decode_kernel
from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.ops.cuda import paged_attention as tkernels
from dynamo_tpu_torch.tools.cases import quantize_pool

NEG_INF = -1e30
SPLITS = [1, 2, 3, 7, 16]


def _case(seed, B, C, H, KH, D, BS, P, starts, int8):
    """q float32; pools of bf16 values, or int8 pools of the same values."""
    rng = np.random.default_rng(seed)
    NB = B * P + 3
    q = torch.from_numpy(rng.standard_normal((B, C, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((NB, BS, KH, D)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    if int8:
        k, v = quantize_pool(k.float()), quantize_pool(v.float())
    tables = torch.from_numpy(rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32))
    return q, k, v, tables, torch.tensor(starts, dtype=torch.int32)


def _plain(q, k, v, tables, start, window, cap):
    full = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32)
    return tattn.paged_attention_ref(q, k, v, tables, start, full, window=window, logit_cap=cap)


CASES = {
    # label: (seed, B, C, H, KH, D, BS, P, starts, window, softcap)
    # Qwen2.5-0.5B's heads (G 7), C 1: the decode layout's 256-key tiles,
    # 1 to 3 of them a sequence.
    "D64 C1 G7": (1, 3, 1, 14, 2, 64, 16, 48, [0, 300, 700], 0, 0.0),
    # Gemma-3-1B's heads (G 4, 64-key tiles), window 512: at start 574 the
    # first visible key of row c = 0 is 63, the last key of tile 0, and row
    # c = 1 first sees key 64, so a split holding tile 0 alone lies wholly
    # before row 1's window.
    "D256 C2 G4 window 512": (2, 2, 2, 4, 1, 256, 16, 64, [574, 1000], 512, 0.0),
    # Llama-3-8B's heads, C·G 12: the 64-row layout's 64-key tiles; softcap.
    "D128 C3 G4 softcap 30": (3, 2, 3, 32, 8, 128, 16, 40, [100, 500], 0, 30.0),
    # C·G 56, the 64-row layout; window and softcap.
    "D64 C7 G8 window 100 softcap 20": (4, 2, 7, 16, 2, 64, 16, 30, [150, 333], 100, 20.0),
    # C 1 over one to three tiles: 7 and 16 splits leave most shares empty.
    "D256 C1 G4 short": (5, 2, 1, 4, 1, 256, 16, 10, [10, 130], 0, 0.0),
}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("label", list(CASES))
def test_split_ref_matches_plain(label, splits, int8):
    seed, B, C, H, KH, D, BS, P, starts, window, cap = CASES[label]
    q, k, v, tables, start = _case(seed, B, C, H, KH, D, BS, P, starts, int8)
    tile = tkernels.decode_tile(C * H // KH, D)
    got, m, l, acc = tattn.paged_attention_split_ref(q, k, v, tables, start, splits=splits,
                                                     tile=tile, window=window, logit_cap=cap)
    want = _plain(q, k, v, tables, start, window, cap)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    # an empty share carries the empty state, and so zero weight
    empty = l == 0
    assert bool((m[empty] == NEG_INF).all()) and bool((acc[empty] == 0).all())
    if splits == 16:  # more splits than every case's sequences have tiles
        assert bool(empty.any())


def test_a_split_before_a_rows_window_carries_no_weight():
    """In the window case at 9 splits, one tile each, split 0 holds tile 0
    of sequence 0 alone and sees no key of its row c = 1: its max stays
    -1e30, so e^(m - M) = 0 there, while row c = 0 sees key 63 in it."""
    seed, B, C, H, KH, D, BS, P, starts, window, cap = CASES["D256 C2 G4 window 512"]
    q, k, v, tables, start = _case(seed, B, C, H, KH, D, BS, P, starts, False)
    _, m, l, _ = tattn.paged_attention_split_ref(q, k, v, tables, start, splits=9, tile=64,
                                                 window=window)
    assert bool((m[0, 0, 1] == NEG_INF).all()) and bool((l[0, 0, 1] > 0).all())
    assert bool((m[0, 0, 0] > NEG_INF).all())
    assert bool((torch.exp(m[0, 0, 1] - m[:, 0, 1].amax(dim=0)) == 0).all())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("splits", [1, 2, 16])
def test_all_masked_padding_row_stays_finite_and_equals_plain(splits, int8):
    """Row 0 sits at start -1, so no key is visible to it: every score is
    -1e30 and every share's max stays -1e30, so the combine weighs the
    shares equally and the row is the mean of the values the kernel walks,
    finite. Its one tile here is the whole table (one page of 64 keys, the
    D 256 decode tile), so that mean is paged_attention_ref's uniform
    softmax over the table; the other shares are empty."""
    q, k, v, tables, start = _case(6, 2, 1, 4, 1, 256, 64, 1, [-1, 50], int8)
    got, m, l, _ = tattn.paged_attention_split_ref(q, k, v, tables, start, splits=splits, tile=64)
    want = _plain(q, k, v, tables, start, 0, 0.0)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    assert bool((m[:, 0] == NEG_INF).all())
    walked = l[:, 0, 0, 0] > 0  # the one share that holds the tile
    assert int(walked.sum()) == 1 and bool((l[walked, 0] == 64).all())


def _jpool(pool):
    if isinstance(pool, dict):
        return {"q8": jnp.asarray(pool["q8"].numpy()), "s": jnp.asarray(pool["s"].numpy())}
    return jnp.asarray(pool.float().numpy())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("label", ["D256 C2 G4 window 512", "D64 C7 G8 window 100 softcap 20"])
def test_split_ref_matches_jax_decode_kernel(label, int8):
    """Through the JAX package's decode kernel (Pallas, interpret mode) on
    the same inputs, at 3 and 7 splits."""
    seed, B, C, H, KH, D, BS, P, starts, window, cap = CASES[label]
    q, k, v, tables, start = _case(seed, B, C, H, KH, D, BS, P, starts, int8)
    want = np.asarray(jax.block_until_ready(paged_attention_decode_kernel(
        jnp.asarray(q.numpy()), _jpool(k), _jpool(v), jnp.asarray(tables.numpy()),
        jnp.asarray(start.numpy()), window, interpret=True, batch_block=2, logit_cap=cap,
    )).astype(np.float32))
    tile = tkernels.decode_tile(C * H // KH, D)
    for splits in (3, 7):
        got, *_ = tattn.paged_attention_split_ref(q, k, v, tables, start, splits=splits,
                                                  tile=tile, window=window, logit_cap=cap)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_decode_splits_from_shapes():
    """Split while one pass would leave the card less than full: as many
    splits as fill it once with the split kernel's blocks (264 on an H100
    at two an SM), at least 2, at most 16; 1 once one pass fills it — at
    the geometries the kernel is timed at."""
    split = tkernels.decode_splits
    assert tkernels.H100_CAPACITY == 264
    assert split(32, 1) == 8  # Gemma-3-1B global layers, B 32 x KH 1
    assert split(16, 4) == 4  # Gemma-2-2B, B 16 x KH 4
    assert split(16, 2) == 8 and split(16, 2, capacity=132) == 4  # Qwen2.5-0.5B, B 16 x KH 2
    assert split(16, 8) == 2  # Llama-3-8B, B 16 x KH 8
    assert split(32, 8) == 2  # Llama-3-8B int8 KV, B 32 x KH 8: 256 blocks, one pass not full
    assert split(64, 8) == 1  # _prof_attn.py / _prof_8b.py, B 64 x KH 8: today's path
    assert split(33, 8) == 1 and split(264, 1) == 1  # one pass fills the card
    assert split(16, 1) == 16 and split(1, 1) == 16  # capped
    assert split(4, 1, row_blocks=2) == 16 and split(200, 1) == 2


def test_decode_tile_is_the_kernels():
    assert tkernels.decode_tile(4, 256) == 64 and tkernels.decode_tile(8, 128) == 128
    assert tkernels.decode_tile(7, 64) == 256 and tkernels.decode_tile(12, 128) == 64


@pytest.mark.parametrize("splits", [0, 17])
def test_decode_wrapper_refuses_a_split_count_out_of_range(splits):
    q, k, v, tables, start = _case(7, 1, 1, 4, 1, 64, 16, 4, [20], False)
    with pytest.raises(ValueError, match="splits"):
        tkernels.paged_attention_decode(q, k, v, tables, start, splits=splits)
    # a forced count in range runs the plain version on the CPU
    out = tkernels.paged_attention_decode(q, k, v, tables, start, splits=5)
    np.testing.assert_allclose(out.numpy(), _plain(q, k, v, tables, start, 0, 0.0).numpy())
