"""The fused layer's attention as its CUDA kernel computes it
(csrc/fused_layer.cu), emulated on the CPU by ops/fused_layer: 256-key items
from the window's first key rounded down to 16, tiles of 16,384 / D keys,
16-key groups each with an online softmax, q and the f32 probabilities
entering their tensor-core products as three bf16 terms, the groups of an
item and the items of a (row, KV head) merged in order with the current
token. Held against the plain version and against the JAX Pallas kernel in
interpret mode.

Tolerances (tools.cases.bf16_steps, one step = 2^-7·(|ref| + rms(ref))):
  * emulation vs the plain version: 1 step of every output, the card's
    limit for the kernel. Three terms carry an f32 value's 24 bits; with
    two (hi + lo) about 2^-17 of each value is lost, which flips ~8 in 4,096
    attention outputs by a bf16 step and moved the layer's output 1.21
    steps at the Gemma-3 window case (the kernel note in fused_layer.cu).
  * attention alone, emulation vs plain: one bf16 step of the output
    (2^-8·|ref|, plus 2^-8·rms for values near zero).
  * emulation vs the JAX kernel: 1.25 steps. The plain version itself sits
    1.22 steps from the JAX kernel at the Gemma-3 window miniature (both
    keep f32 sums and bf16 intermediates, rounded at other points of their
    sums; a flipped attention output moves the residual, h2 and gu
    roundings after it), and the emulation equals the plain version there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas import fused_layer as jfused
from dynamo_tpu_torch.ops import fused_layer as tfused
from dynamo_tpu_torch.tools.cases import (
    LAYER_CASES,
    MODEL_LAYER_CASES,
    MODEL_PAST_ONE_SHARE,
    MODEL_STEP_LIMIT,
    bf16_steps,
    make_layer_case,
    run_layer,
)

MINIATURES = [label for label in LAYER_CASES if not label.startswith("llama3-8b")]


def _jax(t):
    if isinstance(t, dict):
        return {k: _jax(v) for k, v in t.items()}
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("label", MINIATURES)
def test_emulated_kernel_layer_matches_plain_version(label):
    c, call = make_layer_case(label, "cpu")
    want = run_layer(tfused.fused_decoder_layer_ref, c, call)
    got = run_layer(tfused.fused_decoder_layer_mma_ref, c, call)
    for name, a, b in zip(("x_out", "k_new", "v_new"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert bf16_steps(a, b) <= 1.0, (name, bf16_steps(a, b))


@pytest.mark.parametrize("label", list(MODEL_LAYER_CASES))
def test_emulated_kernel_layer_at_full_gemma3_layers(label):
    """At a full Gemma-3-1B layer (32 rows, contexts to 4,600) the kernel's
    attention arithmetic alone moves a few x_out values past one bf16 step
    (a flipped attention output, carried by the o-proj): the limits the
    card holds the kernel to there, tools.cases.MODEL_STEP_LIMIT and
    MODEL_PAST_ONE_SHARE; k_new and v_new come before attention."""
    c, call = make_layer_case(label, "cpu")
    want = run_layer(tfused.fused_decoder_layer_ref, c, call)
    got = run_layer(tfused.fused_decoder_layer_mma_ref, c, call)
    assert bf16_steps(got[0], want[0]) <= MODEL_STEP_LIMIT
    x, rx = got[0].float(), want[0].float()
    unit = 2.0**-7 * (rx.abs() + rx.pow(2).mean().sqrt())
    assert int(((x - rx).abs() > unit).sum()) <= MODEL_PAST_ONE_SHARE * x.numel()
    assert all(bf16_steps(a, b) <= 1.0 for a, b in zip(got[1:], want[1:]))


@pytest.mark.parametrize("label", MINIATURES)
def test_emulated_kernel_layer_matches_pallas_kernel(label):
    """Against _fused_decoder_layer_impl in interpret mode, compiled with
    XLA's excess precision off (its bf16 intermediates rounded as on the
    TPU)."""
    c, call = make_layer_case(label, "cpu")
    B = c["x"].shape[0]
    win = int(call.get("window", 0) or 0)

    def layer(x, cos, sin, lp, kp, vp, tables, start, window):
        return jfused._fused_decoder_layer_impl(
            x, cos, sin, lp, kp, vp, tables, start, eps=call["eps"], sm_scale=call["sm_scale"],
            interpret=True, batch_block=min(4, B), window=window if win else None,
            act_fn=call.get("act_fn", "silu"), unit_offset=call.get("unit_offset", False),
            softcap=call.get("softcap", 0.0))

    args = tuple(_jax(c[k]) for k in ("x", "cos", "sin", "lp", "k", "v", "tables", "start"))
    args += (jnp.asarray(win, jnp.int32),)
    want = jax.block_until_ready(jax.jit(layer).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args))
    got = run_layer(tfused.fused_decoder_layer_mma_ref, c, call)
    for name, a, b in zip(("x_out", "k_new", "v_new"), got, want):
        steps = bf16_steps(a, torch.from_numpy(np.asarray(b, np.float32)))
        assert steps <= 1.25, (name, steps)


def _attention_case(B, KH, G, D, BS, starts, seed):
    g = torch.Generator().manual_seed(seed)
    P = max(s // BS + 1 for s in starts)
    NB = B * P + 3
    return dict(
        q=torch.randn(B, KH * G, D, generator=g),
        k_new=torch.randn(B, KH, D, generator=g).to(torch.bfloat16),
        v_new=torch.randn(B, KH, D, generator=g).to(torch.bfloat16),
        k_pool=torch.randn(NB, BS, KH, D, generator=g).to(torch.bfloat16),
        v_pool=torch.randn(NB, BS, KH, D, generator=g).to(torch.bfloat16),
        block_tables=torch.randperm(NB, generator=g)[: B * P].reshape(B, P).int(),
        start_pos=torch.tensor(starts, dtype=torch.int32),
    )


@pytest.mark.parametrize("D,BS,starts,window,softcap", [
    (128, 16, [0, 5, 255, 256, 700, 1500], 0, 0.0),       # one to six 256-key items
    (128, 16, [40, 300, 777, 1500, 1501, 900], 300, 30.0),  # window edges inside pages
    (256, 16, [17, 600, 1200, 64], 512, 50.0),            # D 256: 64-key tiles
    (128, 8, [3, 100, 513, 260], 77, 0.0),                # 8-key boxes
    (256, 4, [1, 90, 400, 333], 0, 0.0),                  # 4-key boxes (no swizzle)
])
def test_emulated_kernel_attention_matches_plain(D, BS, starts, window, softcap):
    """The items, groups and their merges at contexts of up to six items,
    windows whose first key lies inside a page and a 16-key group, softcap,
    D 128 and 256 and small block sizes, against the plain attention."""
    c = _attention_case(len(starts), 2, 4, D, BS, starts, seed=D + BS)
    P = c["block_tables"].shape[1]
    pcounts = tfused.history_pcounts(c["start_pos"], BS, P)
    kw = dict(window=window, sm_scale=D**-0.5, softcap=softcap)
    args = (c["q"], c["k_new"], c["v_new"], c["k_pool"], c["v_pool"], c["block_tables"],
            c["start_pos"], pcounts)
    want = tfused._attention_plain(*args, **kw).float()
    got = tfused._attention_mma(*args, **kw).float()
    unit = 2.0**-8 * (want.abs() + want.pow(2).mean().sqrt())
    assert bool(((got - want).abs() <= unit).all()), float(((got - want).abs() / unit).max())


def test_three_terms_keep_the_f32_products():
    """Three bf16 terms of q and P flip fewer attention outputs against the
    plain (f32) attention than two, and two fewer than one."""
    c = _attention_case(6, 2, 4, 128, 16, [0, 5, 255, 256, 700, 1500], seed=5)
    pcounts = tfused.history_pcounts(c["start_pos"], 16, c["block_tables"].shape[1])
    args = (c["q"] * 4, c["k_new"], c["v_new"], c["k_pool"], c["v_pool"], c["block_tables"],
            c["start_pos"], pcounts)
    kw = dict(window=0, sm_scale=128**-0.5, softcap=0.0)
    want = tfused._attention_plain(*args, **kw)
    moved = {t: int((functools.partial(tfused._attention_mma, terms=t)(*args, **kw) != want).sum())
             for t in (1, 2, 3)}
    assert moved[3] < moved[2] < moved[1], moved
