"""Decode attention with bf16 probabilities (the port's
ops/attention.decode_attention_bf16_ref and the wrappers of
ops/cuda/decode_attention_proto.py) against the TPU prototypes
``decode_packed`` and ``decode_bf16`` of _prof_attn.py, run on the CPU under
``force_tpu_interpret_mode``; and paged attention at block size 128 (the
wrappers' block-size check, the plain version against the Pallas kernels
in interpret mode, bf16 and int8 pools). Inputs are made from numpy seeds
and handed to both packages.

Tolerances:
  - prototypes against decode_attention_bf16_ref: |a - r| <= 2e-3 +
    1e-2·|r|, the card's limit for the attention kernels. Both round the
    probabilities to bf16, the prototypes against a running max page by
    page and the plain version against the global max, so a probability
    may land one bf16 step away, and the outputs round to bf16 (a step is
    2^-8..2^-7 of |r|); measured: 0.0039 at |r| <= 2.3, ~0.55 of the limit.
  - prototypes against paged_attention_ref (float32 probabilities): the
    looser 1e-2 + 1e-2·|r|; measured: 0.0078 at |r| <= 2.3.
  - paged_attention_ref against the Pallas kernels #1 and #2 at block size
    128: 1e-4, as tests/test_torch_ops.py and test_torch_kv_quant.py hold
    other block sizes (float32 in both, sums in other orders).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dynamo_tpu.ops.pallas.paged_attention import (
    paged_attention_decode_kernel,
    paged_attention_kernel,
)
from dynamo_tpu_torch.ops.attention import decode_attention_bf16_ref, paged_attention_ref
from dynamo_tpu_torch.ops.cuda import decode_attention_proto as tproto
from dynamo_tpu_torch.ops.cuda import paged_attention as tkernels

ROOT = Path(__file__).resolve().parents[1]
ATOL, RTOL = 2e-3, 1e-2  # against decode_attention_bf16_ref
F32_ATOL, F32_RTOL = 1e-2, 1e-2  # against paged_attention_ref


def load_script(name: str):
    """A root prototype script (``_prof_*.py``), loaded by path. Its import
    points ``jax_compilation_cache_dir`` at the checkout's .jax_cache; the
    previous setting is restored right after, so nothing is cached there."""
    old = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(f"{name}_under_test", ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    return mod


@pytest.fixture(scope="module")
def proto():
    return load_script("_prof_attn")


def _bf16(a):
    return np.asarray(jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16))


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def decode_case(B, KH, G, D, BS, starts, seed):
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


# label: (B, KH, G, D, BS, starts, window, softcap, batch_block)
PROTO_CASES = {
    # B 3 in blocks of 2: the prototypes pad to 4 and drop the padded row
    "bs16 D128 B3 batch_block 2": (3, 2, 2, 128, 16, [5, 17, 40], 0, 0.0, 2),
    # first visible keys 123, 193, 248: inside pages 0, 1, 1 of 128
    "bs128 D128 window 8 softcap 30": (3, 2, 2, 128, 128, [130, 200, 255], 8, 30.0, 8),
    # first visible keys 0, 17, 31: inside pages 1 and 1 of 16
    "bs16 D256 window 20": (3, 2, 2, 256, 16, [19, 36, 50], 20, 0.0, 8),
    # Gemma-2's heads and softcap; B 5 in blocks of 4
    "bs128 D256 KH4 G2 B5 batch_block 4 softcap 50": (5, 4, 2, 256, 128, [0, 127, 128, 300, 511],
                                                      0, 50.0, 4),
}


def _torch_args(c):
    return _t(c["q"]), _t(c["k"]), _t(c["v"]), _t(c["tables"]), _t(c["start"])


@pytest.mark.parametrize("kernel", ["decode_packed", "decode_bf16"])
@pytest.mark.parametrize("label", list(PROTO_CASES))
def test_plain_version_matches_the_prototype(proto, kernel, label):
    B, KH, G, D, BS, starts, window, cap, bb = PROTO_CASES[label]
    c = decode_case(B, KH, G, D, BS, starts, seed=len(label))
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(getattr(proto, kernel)(
            *(jnp.asarray(c[n]) for n in ("q", "k", "v", "tables", "start")), window,
            batch_block=bb, logit_cap=cap))
    want = torch.from_numpy(np.asarray(want, np.float32))
    ref = decode_attention_bf16_ref(*_torch_args(c), window, logit_cap=cap)
    assert ref.dtype == torch.bfloat16 and ref.shape == (B, 1, KH * G, D)
    err = (ref.float() - want).abs()
    assert bool((err <= ATOL + RTOL * ref.float().abs()).all()), float(err.max())
    f32 = paged_attention_ref(*_torch_args(c), torch.ones(B, dtype=torch.int32), window=window,
                              logit_cap=cap).float()
    err = (want - f32).abs()
    assert bool((err <= F32_ATOL + F32_RTOL * f32.abs()).all()), float(err.max())
    # on CPU tensors the wrapper is the plain version, and counts no launch
    tproto.reset_launch_counts()
    got = getattr(tproto, kernel)(*_torch_args(c), window, logit_cap=cap)
    assert torch.equal(got, ref)
    assert tproto.launch_counts == {"decode_packed": 0, "decode_bf16": 0}


def test_plain_version_takes_sm_scale_and_one_query_token():
    c = decode_case(2, 2, 4, 128, 16, [3, 40], seed=7)
    args = _torch_args(c)
    a = decode_attention_bf16_ref(*args, sm_scale=0.05)
    b = decode_attention_bf16_ref(*args)
    assert not torch.equal(a, b)
    q2 = args[0].expand(2, 2, 8, 128).contiguous()
    with pytest.raises(ValueError, match="one query token"):
        decode_attention_bf16_ref(q2, *args[1:])


def test_proto_wrappers_check_what_the_kernels_take():
    """The wrappers' checks, reached directly on CPU tensors (a CUDA tensor
    meets them before its launch)."""
    c = decode_case(2, 8, 4, 128, 128, [3, 140], seed=8)
    q, k, v, tables, start = _torch_args(c)
    for packed in (True, False):
        tproto.check(q, k, v, tables, start, packed)
    with pytest.raises(ValueError, match="one query token"):
        tproto.check(q.expand(2, 2, 32, 128).contiguous(), k, v, tables, start, True)
    with pytest.raises(TypeError):
        tproto.check(q.float(), k, v, tables, start, True)
    with pytest.raises(ValueError, match="head_dim"):
        tproto.check(q[..., :64].contiguous(), k[..., :64].contiguous(),
                     v[..., :64].contiguous(), tables, start, False)
    wide = decode_case(1, 8, 16, 128, 16, [5], seed=9)  # G 16 > 8
    with pytest.raises(ValueError, match="at most"):
        tproto.check(*_torch_args(wide), False)
    odd = decode_case(1, 2, 2, 128, 48, [5], seed=10)  # block size 48
    with pytest.raises(ValueError, match="block_size"):
        tproto.check(*_torch_args(odd), True)
    with pytest.raises(ValueError, match="device"):
        tproto.decode_packed(q.to("meta"), k, v, tables, start)


def test_prof_attn_entry_point_runs_on_the_cpu():
    """tools/prof_attn at B 4 with device="cpu": the wrappers are the plain
    versions there, so the parity lines read the plain versions' distance
    from the oracle, and both timings read the host clock."""
    from dynamo_tpu_torch.tools import prof_attn

    res = prof_attn.main(["4"], device="cpu")
    assert res["B"] == 4 and res["device"].startswith("cpu")
    assert res["v1 vs oracle"] == 0.0 and res["packed vs plain"] == 0.0
    assert 0.0 < res["packed vs oracle"] <= prof_attn.F32_ATOL + 0.05
    assert res["packed vs v1"] == res["packed vs oracle"]  # v1 is the oracle on the CPU
    assert res["v1 kernel ms"] > 0 and res["v2 packed ms"] > 0


# -- block size 128 for the serving kernels (#1, #2) ------------------------


@pytest.mark.parametrize("BS", [1, 2, 16, 32, 64, 128, 192, 256])
def test_block_size_check_admits_divisors_of_64_and_multiples_of_64(BS):
    tkernels.check_block_size(BS)


@pytest.mark.parametrize("BS", [0, 3, 48, 97, 320, 512])
def test_block_size_check_refuses_other_sizes(BS):
    with pytest.raises(ValueError, match="block_size"):
        tkernels.check_block_size(BS)


def test_wrapper_check_accepts_block_size_128_and_refuses_48():
    for BS, ok in ((128, True), (48, False)):
        c = decode_case(2, 2, 2, 128, BS, [3, 140], seed=BS)
        args = _torch_args(c)
        if ok:
            tkernels._check(*args)
        else:
            with pytest.raises(ValueError, match="block_size 48"):
                tkernels._check(*args)


def _int8_pool(rng, NB, BS, KH, D):
    return {"q8": rng.integers(-127, 128, (NB, BS, KH, D)).astype(np.int8),
            "s": rng.uniform(0.5, 1.5, (NB, KH, BS)).astype(np.float32) * (2.5 / 127)}


def _serving_case(B, C, H, KH, D, BS, starts, lens, seed, int8):
    rng = np.random.default_rng(seed)
    P = (max(s + C for s in starts) + BS - 1) // BS + 1
    NB = B * P + 3
    if int8:
        k, v = _int8_pool(rng, NB, BS, KH, D), _int8_pool(rng, NB, BS, KH, D)
    else:
        k, v = (_bf16(rng.standard_normal((NB, BS, KH, D))) for _ in range(2))
    return dict(q=rng.standard_normal((B, C, H, D)).astype(np.float32), k=k, v=v,
                tables=rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32),
                start=np.asarray(starts, np.int32), lens=np.asarray(lens, np.int32))


def _pool(p, to):
    return {n: to(a) for n, a in p.items()} if isinstance(p, dict) else to(p)


# (kind, B, C, H, KH, D, starts, lens, window, softcap): block size 128,
# windows whose first visible key lies in a page's second 64-key tile
# (start 250 - 100 + 1 = 151 = page 1 + 23; 300 - 90 + 1 = 211 = page 1 + 83)
BS128_CASES = [
    ("decode", 3, 1, 8, 2, 128, [0, 130, 250], [1, 1, 1], 100, 30.0),
    ("decode", 2, 2, 8, 2, 64, [127, 255], [2, 2], 0, 0.0),
    ("chunk", 2, 40, 8, 2, 128, [100, 300], [40, 17], 90, 20.0),
]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kind,B,C,H,KH,D,starts,lens,window,cap", BS128_CASES)
def test_plain_version_matches_pallas_kernels_at_block_size_128(kind, B, C, H, KH, D, starts,
                                                                lens, window, cap, int8):
    c = _serving_case(B, C, H, KH, D, 128, starts, lens, seed=B * C + D, int8=int8)
    jq, jk, jv = jnp.asarray(c["q"]), _pool(c["k"], jnp.asarray), _pool(c["v"], jnp.asarray)
    jt, js, jl = jnp.asarray(c["tables"]), jnp.asarray(c["start"]), jnp.asarray(c["lens"])
    if kind == "decode":
        want = paged_attention_decode_kernel(jq, jk, jv, jt, js, window, interpret=True,
                                              batch_block=B, logit_cap=cap)
    else:
        want = paged_attention_kernel(jq, jk, jv, jt, js, jl, window, interpret=True,
                                      logit_cap=cap)
    want = np.asarray(jax.block_until_ready(want), np.float32)
    got = paged_attention_ref(_t(c["q"]), _pool(c["k"], _t), _pool(c["v"], _t), _t(c["tables"]),
                              _t(c["start"]), _t(c["lens"]), window=window, logit_cap=cap)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n], atol=1e-4, rtol=1e-4)
