"""The port's int8 weight path (ops/quant.py, models/quantize.py,
models/weights.py) against the JAX package's, on the CPU.

Codes and scales are bit-equal (both round half to even in float32).
Products on bf16 activations agree to one bf16 step of the output (2^-8
relative): both sides sum bf16 × int8 products in float32 and round the
sum to bf16 once, and different summation orders may land the sum on the
other side of a rounding boundary. float32 products agree to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import quantize as jquantize
from dynamo_tpu.ops import quant as jquant
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models import quantize as tquantize
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.ops import quant as tquant

T = torch.from_numpy


def _bf16_np(a):
    """float32 numpy values that are exactly representable in bf16."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("shape,axes", [((64, 48), (0,)), ((48, 64), (1,)), ((3, 40, 24), (1,))])
def test_quantize_q8_codes_and_scales_bit_equal(shape, axes):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 0] = 0.0 if axes == (1,) else w[..., 0]  # an all-zero channel: scale 1
    if axes == (0,):
        w[:, 1] = 0.0
    want = jquant.quantize_q8(w, axes)  # numpy in → numpy out
    got_np = tquant.quantize_q8(w, axes)
    got_t = tquant.quantize_q8(T(w), axes)
    jx = jquant.quantize_q8(jnp.asarray(w), axes)
    for got in (got_np, {k: v.numpy() for k, v in got_t.items()}):
        assert got["q8"].dtype == np.int8 and got["s"].dtype == np.float32
        np.testing.assert_array_equal(got["q8"], want["q8"])
        np.testing.assert_array_equal(got["s"], want["s"])
        np.testing.assert_array_equal(got["q8"], np.asarray(jx["q8"]))
        np.testing.assert_array_equal(got["s"], np.asarray(jx["s"]))
    assert isinstance(got_np["q8"], np.ndarray) and isinstance(got_t["q8"], torch.Tensor)
    assert tquant.is_q8(got_t) and not tquant.is_q8(T(w))
    np.testing.assert_allclose(tquant.dequantize(got_t).numpy(),
                               np.asarray(jquant.dequantize(jx)), rtol=0, atol=0)


def _q_pair(shape, axis, seed):
    rng = np.random.default_rng(seed)
    return jquant.quantize_q8((rng.standard_normal(shape) * 0.1).astype(np.float32), (axis,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qeinsum_int8_matches_jax(dtype):
    rng = np.random.default_rng(3)
    w = _q_pair((96, 80), 0, 4)
    x = _bf16_np(rng.standard_normal((2, 5, 96)).astype(np.float32))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jquant.qeinsum("bcd,dh->bch", jnp.asarray(x, jd), jax.tree.map(jnp.asarray, w)))
    tw = {"q8": T(w["q8"]), "s": T(w["s"])}
    got = tquant.qeinsum("bcd,dh->bch", T(x).to(td), tw)
    assert got.dtype == td
    got = got.float().numpy()
    want = want.astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:  # one bf16 step of the output
        np.testing.assert_allclose(got, want, rtol=2**-8, atol=1e-6)
    # a plain weight is a plain product
    plain = rng.standard_normal((96, 80)).astype(np.float32)
    np.testing.assert_allclose(tquant.qeinsum("bcd,dh->bch", T(x), T(plain)).numpy(),
                               np.einsum("bcd,dh->bch", x, plain), rtol=1e-5, atol=1e-5)


def test_embed_lookup_int8_matches_jax():
    emb = _q_pair((50, 32), 1, 5)
    tok = np.array([[1, 7, 49], [0, 3, 3]], np.int32)
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jquant.embed_lookup(jax.tree.map(jnp.asarray, emb), jnp.asarray(tok), jd))
        got = tquant.embed_lookup({"q8": T(emb["q8"]), "s": T(emb["s"])}, T(tok).long(), td)
        assert got.dtype == td
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("tied", [False, True])
def test_lm_head_int8_matches_jax(tied):
    rng = np.random.default_rng(6)
    w = _q_pair((40, 64), 1, 7) if tied else _q_pair((64, 40), 0, 7)
    x = _bf16_np(rng.standard_normal((3, 64)).astype(np.float32))
    tw = {"q8": T(w["q8"]), "s": T(w["s"])}
    for jd, td, tol in ((jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 2**-8)):
        want = np.asarray(jquant.lm_head(jnp.asarray(x, jd), jax.tree.map(jnp.asarray, w), tied=tied))
        got = tquant.lm_head(T(x).to(td), tw, tied=tied)
        assert got.dtype == torch.float32 and got.shape == (3, 40)
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=1e-6)
        # the wrapper's plain version is what a CPU tensor runs
        np.testing.assert_array_equal(got.numpy(), tquant.lm_head_ref(T(x).to(td), tw, tied=tied).numpy())


def _per_layer_numpy(params, n):
    return {**jax.tree.map(np.asarray, params),
            "layers": jax.tree.map(np.asarray, jllama.unstack_layer_params(params["layers"], n))}


@pytest.mark.parametrize("tied", [False, True])
def test_quantize_params_matches_jax(tied):
    jc = jconfig.tiny_config(qkv_bias=True, tie_word_embeddings=tied)
    tc = tconfig.tiny_config(qkv_bias=True, tie_word_embeddings=tied)
    params = jllama.init_params(jc, jax.random.PRNGKey(2))
    want, _ = jax.block_until_ready(jquantize.quantize_params(params))
    plain = params_from_jax(jax.tree.map(np.asarray, params), tc, "cpu")
    assert not tquantize.is_quantized(plain)
    got = tquantize.quantize_params(plain)
    assert tquantize.is_quantized(got) and jquantize.is_quantized(want)
    assert tquantize.quantize_params(got)["layers"][0]["wq"] is got["layers"][0]["wq"]  # idempotent
    for name in ("embed",) + (() if tied else ("lm_head",)):
        for part in ("q8", "s"):
            np.testing.assert_array_equal(got[name][part].numpy(), np.asarray(want[name][part]))
    assert "lm_head" not in got if tied else got["lm_head"]["s"].shape == (1, jc.vocab_size)
    assert got["embed"]["s"].shape == (jc.vocab_size, 1)
    for l in range(jc.n_layers):
        for name, leaf in got["layers"][l].items():
            ref = want["layers"][name]
            if isinstance(leaf, dict):
                np.testing.assert_array_equal(leaf["q8"].numpy(), np.asarray(ref["q8"][l]))
                np.testing.assert_array_equal(leaf["s"].numpy(), np.asarray(ref["s"][l]))
            else:
                np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref[l]))


def test_init_quantized_params_shapes_dtypes_and_std():
    c = tconfig.tiny_config(d_model=256, d_ff=512, qk_norm=True, post_norms=True, qkv_bias=True,
                            rmsnorm_unit_offset=True, dtype=torch.bfloat16)
    a = tquantize.init_quantized_params(c, 3, "cpu")
    b = tquantize.init_quantized_params(c, 3, "cpu")
    ref = jax.block_until_ready(jquantize.init_quantized_params(jconfig.tiny_config(
        d_model=256, d_ff=512, qk_norm=True, post_norms=True, qkv_bias=True,
        rmsnorm_unit_offset=True)))
    assert tquantize.is_quantized(a) and len(a["layers"]) == c.n_layers
    assert a["embed"]["q8"].shape == ref["embed"]["q8"].shape and a["embed"]["s"].shape == (c.vocab_size, 1)
    assert a["lm_head"]["s"].shape == (1, c.vocab_size)
    for name, leaf in a["layers"][0].items():
        want = ref["layers"][name]
        if isinstance(leaf, dict):
            assert leaf["q8"].dtype == torch.int8 and leaf["s"].dtype == torch.float32
            assert leaf["q8"].shape == want["q8"].shape[1:] and leaf["s"].shape == want["s"].shape[1:]
            assert int(leaf["q8"].min()) >= -127 and int(leaf["q8"].max()) <= 127
            np.testing.assert_allclose(leaf["s"].numpy(), np.asarray(want["s"][0]), rtol=1e-7)
        else:
            assert leaf.dtype == torch.bfloat16 and leaf.shape == want.shape[1:]
            np.testing.assert_array_equal(leaf.float().numpy(), np.asarray(want[0], np.float32))
    assert torch.equal(a["layers"][1]["w_up"]["q8"], b["layers"][1]["w_up"]["q8"])
    assert not torch.equal(tquantize.init_quantized_params(c, 4, "cpu")["embed"]["q8"], a["embed"]["q8"])
    # dequantised std matches llama.init_params' scaling (uniform codes: std 73.3)
    w = tquant.dequantize(a["layers"][0]["w_gate"])
    assert abs(float(w.std()) - c.d_model**-0.5) < 0.03 * c.d_model**-0.5
    assert abs(float(tquant.dequantize(a["embed"]).std()) - 1.0) < 0.03


@pytest.mark.parametrize("form", ["stacked", "per_layer"])
def test_params_from_jax_keeps_int8_codes_and_f32_scales(form):
    jc = jconfig.tiny_config(qk_norm=True, dtype=jnp.bfloat16)
    tc = tconfig.tiny_config(qk_norm=True, dtype=torch.bfloat16)
    q, _ = jquantize.quantize_params(jllama.init_params(jc, jax.random.PRNGKey(1)))
    tree = jax.tree.map(np.asarray, q) if form == "stacked" else _per_layer_numpy(q, jc.n_layers)
    got = params_from_jax(tree, tc, "cpu")
    assert got["embed"]["q8"].dtype == torch.int8 and got["embed"]["s"].dtype == torch.float32
    assert got["lm_head"]["s"].shape == (1, jc.vocab_size)
    assert got["final_norm"].dtype == torch.bfloat16
    for l, lp in enumerate(got["layers"]):
        assert lp["wq"]["q8"].dtype == torch.int8 and lp["wq"]["s"].dtype == torch.float32
        assert lp["wq"]["s"].shape == (1, jc.n_heads * jc.head_dim_)
        assert lp["q_norm"].dtype == torch.bfloat16
        np.testing.assert_array_equal(lp["w_down"]["q8"].numpy(), np.asarray(q["layers"]["w_down"]["q8"][l]))
        np.testing.assert_array_equal(lp["w_down"]["s"].numpy(), np.asarray(q["layers"]["w_down"]["s"][l]))
