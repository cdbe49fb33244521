"""The algebra of the chunk kernel on the tensor cores (csrc/paged_attention.cu,
paged_attention_chunk_kernel) on the CPU: ops/attention.paged_attention_chunk_mma_ref
walks each block of 64 query rows over 64-key tiles in the kernel's order,
keeps the online softmax per tile and multiplies P·V as the bf16 halves
hi + lo of the float32 probabilities. It is held against paged_attention_ref
and, through the same route as tests/test_torch_ops.py and
tests/test_torch_kv_quant.py, against the JAX chunk kernel in interpret mode,
on inputs made from numpy seeds: bf16 and int8 pools, head_dim 64, 128 and
256, block sizes 16 and 128, window edges inside a tile and a page, a
softcap, and ragged chunk_lens with padding rows and whole row blocks of
padding.

Tolerances:
  - against paged_attention_ref: 5e-5 absolute and 1e-5 relative on valid
    rows. hi + lo carries each probability to within 2^-16 of itself
    (test_hi_lo_split_keeps_float32_probabilities), so an output moves by at
    most ~2^-16 of the weighted mean of |v|, beside float32 sums in another
    order: ~1e-5 at |v| ~ 1-4 (int8 pools hold the codes, up to 127, with
    the scale applied to p).
  - against the Pallas chunk kernel in interpret mode: 1e-4, the limit
    tests/test_torch_ops.py and tests/test_torch_kv_quant.py hold the plain
    version to against it.
chip_smoke.py holds the kernel on the card to its own limit (2e-3 +
1e-2·|plain|), unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas.paged_attention import paged_attention_kernel
from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.tools.cases import quantize_pool

ATOL, RTOL = 5e-5, 1e-5
JAX_TOL = 1e-4

CASES = {
    # label: (seed, B, C, H, KH, D, BS, P, starts, lens, window, softcap)
    # Qwen2.5-0.5B's heads (G 7): 280 rows in 5 row blocks; sequence 1's
    # 23 valid tokens leave rows 161+ as padding (its last two row blocks
    # whole), sequence 2 is all padding.
    "D64 G7 bs16 ragged": (1, 3, 40, 14, 2, 64, 16, 12, [0, 17, 120], [40, 23, 0], 0, 0.0),
    # Llama-3-8B's heads; window 50 at start 150: row 0's first visible key
    # is 101, inside page 6 (keys 96-111) and inside tile 1 (64-127).
    "D128 G4 bs16 window inside a tile and a page, softcap": (
        2, 2, 36, 8, 2, 128, 16, 20, [150, 70], [36, 20], 50, 30.0),
    # Gemma-3-1B's heads (KH 1, G 4) at block size 128: 160 rows in 3 row
    # blocks, window 100 at start 200: the first visible key, 101, inside
    # the first page's second tile.
    "D256 G4 bs128 window": (3, 2, 40, 4, 1, 256, 128, 4, [200, 5], [40, 17], 100, 0.0),
    # Gemma-2-2B's heads (G 2), softcap 50.
    "D256 G2 bs16 softcap": (4, 2, 24, 4, 2, 256, 16, 20, [290, 0], [24, 9], 0, 50.0),
    # block size 128, window 64 across a page edge (keys 167-206 first visible)
    "D64 G4 bs128 window across a page": (5, 2, 40, 8, 2, 64, 128, 4, [230, 37], [40, 17], 64,
                                          20.0),
    # 192 rows in 3 row blocks; sequence 1's one valid token leaves its
    # second and third row blocks all padding.
    "D128 G4 bs128 all-padding row blocks": (6, 2, 48, 8, 2, 128, 128, 3, [0, 260], [48, 1], 0,
                                             0.0),
}


def _case(seed, B, C, H, KH, D, BS, P, starts, lens, int8):
    """q of bf16 values in float32 (the kernel takes bf16 q, exactly); pools
    of bf16 values, or int8 pools of the same values."""
    rng = np.random.default_rng(seed)
    NB = B * P + 3
    q = torch.from_numpy(rng.standard_normal((B, C, H, D)).astype(np.float32))
    q = q.to(torch.bfloat16).to(torch.float32)
    k, v = (torch.from_numpy(rng.standard_normal((NB, BS, KH, D)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    if int8:
        k, v = quantize_pool(k.float()), quantize_pool(v.float())
    tables = torch.from_numpy(rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32))
    return (q, k, v, tables, torch.tensor(starts, dtype=torch.int32),
            torch.tensor(lens, dtype=torch.int32))


def _valid(out, lens):
    return [out[b, :n] for b, n in enumerate(lens)]


def _jpool(pool):
    if isinstance(pool, dict):
        return {"q8": jnp.asarray(pool["q8"].numpy()), "s": jnp.asarray(pool["s"].numpy())}
    return jnp.asarray(pool.float().numpy())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("label", list(CASES))
def test_chunk_mma_ref_matches_plain(label, int8):
    seed, B, C, H, KH, D, BS, P, starts, lens, window, cap = CASES[label]
    args = _case(seed, B, C, H, KH, D, BS, P, starts, lens, int8)
    got = tattn.paged_attention_chunk_mma_ref(*args, window=window, logit_cap=cap)
    want = tattn.paged_attention_ref(*args, window=window, logit_cap=cap)
    assert got.shape == want.shape and torch.isfinite(got).all()  # padding rows too
    for a, r in zip(_valid(got, lens), _valid(want, lens)):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("label", list(CASES))
def test_chunk_mma_ref_matches_jax_chunk_kernel(label, int8):
    """Through the JAX package's chunk kernel (Pallas, interpret mode) on the
    same inputs."""
    seed, B, C, H, KH, D, BS, P, starts, lens, window, cap = CASES[label]
    q, k, v, tables, start, clens = _case(seed, B, C, H, KH, D, BS, P, starts, lens, int8)
    want = np.asarray(jax.block_until_ready(paged_attention_kernel(
        jnp.asarray(q.numpy()), _jpool(k), _jpool(v), jnp.asarray(tables.numpy()),
        jnp.asarray(start.numpy()), jnp.asarray(clens.numpy()), window, interpret=True,
        logit_cap=cap)).astype(np.float32))
    got = tattn.paged_attention_chunk_mma_ref(q, k, v, tables, start, clens, window=window,
                                              logit_cap=cap)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n], atol=JAX_TOL, rtol=JAX_TOL)


def test_padding_row_blocks_are_zeros():
    """A row block whose rows are all past chunk_lens is written as zeros,
    as the kernel writes it; a partly valid one keeps finite padding rows."""
    seed, B, C, H, KH, D, BS, P, starts, lens, window, cap = CASES[
        "D128 G4 bs128 all-padding row blocks"]
    args = _case(seed, B, C, H, KH, D, BS, P, starts, lens, False)
    got = tattn.paged_attention_chunk_mma_ref(*args)
    G = H // KH
    rows = got[1].reshape(C, KH, G, D).permute(1, 0, 2, 3).reshape(KH, C * G, D)
    assert bool((rows[:, 64:] == 0).all())  # row blocks 1 and 2 of sequence 1
    assert bool((rows[:, 4:64] != 0).any()) and torch.isfinite(rows).all()


def test_hi_lo_split_keeps_float32_probabilities():
    """|p - (hi + lo)| <= 2^-16 p for p in [0, 1], hi = bf16(p) and
    lo = bf16(p - hi), the two halves the kernel multiplies into P·V: on a
    dense grid of [0, 1], at every power of two down to 2^-126, and at
    random probabilities."""
    rng = np.random.default_rng(0)
    p = torch.cat([
        torch.linspace(0.0, 1.0, 1_000_001, dtype=torch.float64).to(torch.float32),
        torch.tensor([2.0**-e for e in range(127)], dtype=torch.float32),
        torch.from_numpy(rng.random(100_000).astype(np.float32)),
        torch.from_numpy(np.exp(-rng.random(100_000) * 80).astype(np.float32)),
    ])
    hi = p.to(torch.bfloat16).to(torch.float32)
    lo = (p - hi).to(torch.bfloat16).to(torch.float32)
    err = (p.double() - (hi.double() + lo.double())).abs()
    assert bool((err <= 2.0**-16 * p.double()).all()), float((err / p.double()).max())
    # bf16 alone is 2^-9 off at worst: the split is what keeps the TPU
    # kernel's float32 probabilities
    assert float(((p.double() - hi.double()).abs() / p.double().clamp_min(1e-38)).max()) > 2.0**-10


def test_hi_lo_is_closer_to_float32_attention_than_bf16_probabilities():
    """With P rounded to bf16 alone the emulated kernel drifts from the
    float32 plain version by far more than with hi + lo."""
    seed, B, C, H, KH, D, BS, P, starts, lens, window, cap = CASES[
        "D128 G4 bs16 window inside a tile and a page, softcap"]
    args = _case(seed, B, C, H, KH, D, BS, P, starts, lens, False)
    want = tattn.paged_attention_ref(*args, window=window, logit_cap=cap)
    got = tattn.paged_attention_chunk_mma_ref(*args, window=window, logit_cap=cap)
    err_hi_lo = max(float((a - r).abs().max()) for a, r in zip(_valid(got, lens), _valid(want, lens)))
    # the same attention with P rounded to bf16
    q, k, v, tables, start, clens = args
    G = H // KH
    out = torch.zeros_like(want)
    kf = k[tables.long()].reshape(B, P * BS, KH, D).float()
    vf = v[tables.long()].reshape(B, P * BS, KH, D).float()
    for b in range(B):
        for h in range(KH):
            c = torch.arange(C)[:, None].expand(C, G).reshape(-1)
            qb = q[b].reshape(C, KH, G, D)[:, h].reshape(-1, D)
            s = qb @ kf[b, :, h].T * D**-0.5
            s = cap * torch.tanh(s / cap)
            t = torch.arange(P * BS)[None]
            lim = int(start[b]) + c[:, None]
            s = torch.where((t <= lim) & (t > lim - window), s, torch.full_like(s, -1e30))
            p = torch.softmax(s, dim=-1)
            o = p.to(torch.bfloat16).float() @ vf[b, :, h]
            out[b].reshape(C, KH, G, D)[:, h] = o.reshape(C, G, D)
    err_bf16 = max(float((a - r).abs().max()) for a, r in zip(_valid(out, lens), _valid(want, lens)))
    assert err_hi_lo < ATOL and err_bf16 > 20 * err_hi_lo, (err_hi_lo, err_bf16)
