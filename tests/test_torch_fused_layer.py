"""The port's fused decoder layer (ops/fused_layer.py) against the JAX
package's, on the CPU: the eligibility reasons, the page bounds, the plain
version against the Pallas kernel (interpret mode) and against the XLA
layer, and decode through the fused layer against the JAX int8 path.

Tolerances. The plain version keeps the TPU kernel's rounding points, so
against the Pallas kernel it is held to one bf16 step (``bf16_steps``) — with
XLA's excess precision turned off for that compile: by default XLA on the
CPU skips the kernel's intermediate bf16 roundings (h = bf16(x·rsqrt) × w
becomes one rounding), which moves outputs by up to ~2 % of their largest
value on these shapes. Against the XLA ``decoder_layer`` (other rounding
points: q/k/v rounded to bf16, the cache written before attending) the
bound is 3e-2 of the largest output, below the 4e-2 that the JAX package's
own fused-vs-XLA tests allow.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.quantize import quantize_params as jquantize_params
from dynamo_tpu.ops.pallas import fused_layer as jfused
from dynamo_tpu.ops.rope import rope_table as jrope_table
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.ops import fused_layer as tfused
from dynamo_tpu_torch.tools.cases import bf16_steps

BASE = dict(name="fused-test", d_model=256, n_layers=1, n_heads=4, n_kv_heads=2, d_ff=512,
            vocab_size=128, head_dim=128, rope_theta=10000.0)
VARIANTS = {
    "plain": {},
    "qwen3": dict(qk_norm=True, rms_norm_eps=1e-6),
    # softcap + post-norms + GeGLU + unit offset + window 32
    "gemma2": dict(act_fn="gelu_tanh", rmsnorm_unit_offset=True, post_norms=True,
                   attn_logit_softcap=30.0, query_scale=128.0, sliding_window=32),
    # qk-norm + GeGLU + unit offset + post-norms, window 24 straddling pages
    "gemma3": dict(qk_norm=True, act_fn="gelu_tanh", rmsnorm_unit_offset=True,
                   post_norms=True, query_scale=128.0, rms_norm_eps=1e-6, sliding_window=24),
    "qwen2": dict(qkv_bias=True, rms_norm_eps=1e-6),
}
STARTS = [0, 1, 15, 16, 19, 31, 45, 63]
STARTS_STRADDLE = [0, 20, 33, 47, 48, 55, 60, 63]  # pos - 24 lands mid-page


def _configs(name, **over):
    kw = {**BASE, **VARIANTS[name], "name": f"fused-{name}", **over}
    return (jconfig.ModelConfig(**kw, dtype=jnp.bfloat16),
            tconfig.ModelConfig(**kw, dtype=torch.bfloat16))


def _jax_layer(jc, seed):
    """Layer 0 of a JAX int8 tree, with non-neutral norm weights and biases
    (a neutral 1 or 0 would hide a missing epilogue)."""
    q, _ = jquantize_params(jllama.init_params(jc, jax.random.PRNGKey(seed)))
    lp = jax.tree.map(lambda a: np.asarray(a[0]), q["layers"])
    r = np.random.default_rng(seed + 100)
    lo = -0.5 if jc.rmsnorm_unit_offset else 0.5  # unit-offset norms store w - 1
    for k in ("q_norm", "k_norm", "attn_post_norm", "mlp_post_norm", "attn_norm", "mlp_norm"):
        if k in lp:
            lp[k] = np.asarray(jnp.asarray(r.uniform(lo, lo + 1, lp[k].shape), jnp.bfloat16))
    for k in ("bq", "bk", "bv"):
        if k in lp:
            lp[k] = np.asarray(jnp.asarray(r.standard_normal(lp[k].shape) * 0.3, jnp.bfloat16))
    return lp


def _torch_layer(lp, tc):
    tree = {"embed": np.zeros((1, 1), np.float32), "final_norm": np.zeros(1, np.float32),
            "layers": [lp]}
    return params_from_jax(tree, tc, "cpu")["layers"][0]


def _inputs(jc, starts, seed, P=4, BS=16):
    rng = np.random.default_rng(seed)
    B, KH, D = len(starts), jc.n_kv_heads, jc.head_dim_
    NB = B * P + 4
    bf = lambda a: np.asarray(jnp.asarray(a.astype(np.float32), jnp.bfloat16))  # noqa: E731
    x = bf(rng.standard_normal((B, jc.d_model)) * 0.3)
    k_pool = bf(rng.standard_normal((NB, BS, KH, D)) * 0.2)
    v_pool = bf(rng.standard_normal((NB, BS, KH, D)) * 0.2)
    tables = rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32)
    start = np.asarray(starts, np.int32)
    cos, sin = jrope_table(jnp.asarray(start)[:, None], D, jc.rope_theta)
    return x, np.asarray(cos[:, 0]), np.asarray(sin[:, 0]), k_pool, v_pool, tables, start


def _t(a, dtype=None):
    a = np.asarray(a)
    out = torch.from_numpy(np.array(a.astype(np.float32) if a.dtype.name == "bfloat16" else a))
    return out.to(dtype) if dtype is not None else out


def _sm(c):
    return c.query_scale**-0.5 if c.query_scale is not None else c.head_dim_**-0.5


def _plain(tc, lp, inputs, window):
    x, cos, sin, kp, vp, tables, start = inputs
    bf = torch.bfloat16
    return tfused.fused_decoder_layer(
        _t(x, bf), _t(cos), _t(sin), _torch_layer(lp, tc), _t(kp, bf), _t(vp, bf), _t(tables),
        _t(start), eps=tc.rms_norm_eps, sm_scale=_sm(tc), window=window, act_fn=tc.act_fn,
        unit_offset=tc.rmsnorm_unit_offset, softcap=float(tc.attn_logit_softcap or 0.0),
    )


def _steps(out, ref):
    return bf16_steps(out, torch.as_tensor(np.asarray(ref, np.float32)))


def test_supports_reason_matches_jax_for_every_preset(monkeypatch):
    jp, tp = jconfig.all_presets(), tconfig.all_presets()
    assert jp.keys() == tp.keys() and len(jp) >= 10
    for name in jp:
        for lora in (False, True):
            for qw in (True, False):
                assert tfused.supports_reason(tp[name], lora=lora, quantized_weights=qw) == \
                    jfused.supports_reason(jp[name], lora=lora, quantized_weights=qw), name
        assert tfused.supports(tp[name], lora=False, quantized_weights=True) == \
            jfused.supports(jp[name], lora=False, quantized_weights=True)
    assert tfused.supports(tp["llama-3-8b"], lora=False, quantized_weights=True)
    # The port's own reasons come after the JAX ones: a head dim that the
    # JAX kernel takes but the CUDA kernel was not built for (none while 128
    # and 256 are both built), and a GQA group wider than it holds.
    jc, tc = _configs("plain", head_dim=256, n_heads=2, n_kv_heads=1)
    assert jfused.supports_reason(jc, lora=False, quantized_weights=True) is None
    assert tfused.supports_reason(tc, lora=False, quantized_weights=True) is None
    monkeypatch.setattr(tfused, "BUILT_HEAD_DIMS", (128,))
    assert "not built" in tfused.supports_reason(tc, lora=False, quantized_weights=True)
    jc, tc = _configs("plain", n_heads=128, n_kv_heads=1, d_model=1024)
    assert jfused.supports_reason(jc, lora=False, quantized_weights=True) is None
    assert "shared memory" in tfused.supports_reason(tc, lora=False, quantized_weights=True)


def test_history_pcounts_and_window_page_bounds_match_jax():
    start = np.array([0, 1, 5, 16, 17, 64, 100, 200, 5000], np.int32)
    for BS, P in ((16, 4), (16, 400), (4, 9)):
        np.testing.assert_array_equal(
            tfused.history_pcounts(torch.from_numpy(start), BS, P).numpy(),
            np.asarray(jfused.history_pcounts(jnp.asarray(start), BS, P)))
        for window in (0, 1, 17, 40, 512):
            want = jax.block_until_ready(jfused.window_page_bounds(jnp.asarray(start), window, BS))
            got = tfused.window_page_bounds(torch.from_numpy(start), window, BS)
            for a, b in zip(got, want):
                assert a.dtype == torch.int32
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@functools.lru_cache(maxsize=None)
def _strict_pallas(eps, sm_scale, act_fn, unit_offset, softcap, windowed):
    """The JAX fused layer in interpret mode, compiled with XLA's excess
    precision off so its bf16 intermediates are rounded as on the TPU."""
    def call(x, cos, sin, lp, kp, vp, tables, start, window):
        return jfused._fused_decoder_layer_impl(
            x, cos, sin, lp, kp, vp, tables, start, eps=eps, sm_scale=sm_scale, interpret=True,
            window=window if windowed else None, act_fn=act_fn, unit_offset=unit_offset,
            softcap=softcap)
    return jax.jit(call)


@pytest.mark.parametrize("name", ["plain", "qwen3", "gemma2", "gemma3"])
def test_plain_version_matches_pallas_kernel(name):
    jc, tc = _configs(name)
    win = int(jc.sliding_window or 0)
    lp = _jax_layer(jc, seed=3)
    inputs = _inputs(jc, STARTS_STRADDLE if name == "gemma3" else STARTS, seed=11)
    x, cos, sin, kp, vp, tables, start = inputs
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(cos), jnp.asarray(sin),
             jax.tree.map(jnp.asarray, lp), jnp.asarray(kp, jnp.bfloat16),
             jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables), jnp.asarray(start),
             jnp.asarray(win, jnp.int32))
    fn = _strict_pallas(jc.rms_norm_eps, _sm(jc), jc.act_fn, jc.rmsnorm_unit_offset,
                        float(jc.attn_logit_softcap or 0.0), win > 0)
    want = jax.block_until_ready(fn.lower(*jargs).compile(
        compiler_options={"xla_allow_excess_precision": False})(*jargs))
    got = _plain(tc, lp, inputs, win)
    for label, a, b in zip(("x_out", "k_new", "v_new"), got, want):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
        assert _steps(a, b) <= 1.0, (label, _steps(a, b))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_plain_version_matches_xla_layer(name):
    """Against the JAX XLA decoder_layer (write the token, then attend)."""
    jc, tc = _configs(name)
    win = int(jc.sliding_window or 0)
    lp = _jax_layer(jc, seed=4)
    inputs = _inputs(jc, STARTS_STRADDLE if win else STARTS, seed=12)
    x, cos, sin, kp, vp, tables, start = inputs
    B = len(start)
    jcos, jsin = jrope_table(jnp.asarray(start)[:, None], jc.head_dim_, jc.rope_theta)
    want, k_c, _ = jax.block_until_ready(jllama.decoder_layer(
        jc, jax.tree.map(jnp.asarray, lp), {}, jnp.asarray(win, jnp.int32),
        jnp.asarray(x, jnp.bfloat16)[:, None], jcos, jsin, jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables), jnp.asarray(start),
        jnp.ones((B,), jnp.int32), use_kernel=False, adapter_ids=None,
    ))
    want = np.asarray(want[:, 0], np.float32)
    got, k_new, _ = _plain(tc, lp, inputs, win)
    assert float((got.float() - torch.from_numpy(want)).abs().max()) <= 3e-2 * np.abs(want).max()
    # the token's K where the XLA layer wrote it
    pages = tables[np.arange(B), start // kp.shape[1]]
    k_written = np.asarray(k_c, np.float32)[pages, start % kp.shape[1]]
    assert float((k_new.float() - torch.from_numpy(k_written)).abs().max()) <= \
        3e-2 * np.abs(k_written).max()


def test_decode_multi_through_the_fused_layer_matches_jax_int8():
    """Two layers, int8 weights: greedy bursts through the port's fused
    layer (plain version on the CPU) give the JAX int8 XLA path's tokens.
    Row 2 is inactive; row 1 starts at zero history."""
    jc, tc = _configs("plain", n_layers=2, vocab_size=512)
    q, _ = jquantize_params(jllama.init_params(jc, jax.random.PRNGKey(9)))
    tp = params_from_jax(jax.tree.map(np.asarray, q), tc, "cpu")
    rng = np.random.default_rng(5)
    B, NB, BS, P, K = 3, 30, 16, 4, 6
    tables = rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32)
    prompt = rng.integers(0, jc.vocab_size, (B, 20)).astype(np.int32)
    lens = np.array([20, 0, 20], np.int32)
    jk, jv = jllama.init_kv_cache(jc, NB, BS, layered=True)
    _, jk, jv = jllama.forward_paged(q, jc, jnp.asarray(prompt), jnp.zeros(B, jnp.int32),
                                     jnp.asarray(lens), jnp.asarray(tables), jk, jv,
                                     first_chunk=True)
    tk, tv = ([tattn.copy_to_sink_pool(torch.from_numpy(np.asarray(a, np.float32))
                                       .to(torch.bfloat16)) for a in pools] for pools in (jk, jv))
    pos, active = np.array([20, 0, 20], np.int32), np.array([1, 1, 0], np.int32)
    tok0, zeros = np.array([5, 9, 0], np.int32), np.zeros(B, np.float32)
    out = jax.block_until_ready(jllama.decode_multi(
        q, jc, jnp.asarray(tok0), jnp.asarray(pos), jnp.asarray(active), jnp.asarray(tables),
        jk, jv, jax.random.PRNGKey(0), jnp.asarray(zeros), jnp.zeros(B, jnp.int32),
        jnp.ones(B, jnp.float32), num_steps=K, salts=jnp.arange(B, dtype=jnp.int32),
        want_logprobs=False, use_megakernel=False,
    ))
    got = tllama.decode_multi(
        tp, tc, _t(tok0), _t(pos), _t(active), _t(tables), tk, tv, 0, _t(zeros),
        torch.zeros(B, dtype=torch.int32), torch.ones(B), num_steps=K, salts=torch.arange(B),
        use_megakernel=True,
    )
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(out[0]))
    assert bool(got.finite.all())
