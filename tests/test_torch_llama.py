"""The port's model (dynamo_tpu_torch/models) against the JAX package's on
the same weights (converted by params_from_jax), on the CPU in float32.

Logits agree to 1e-4 (float32 sums in another order over a few hundred
terms); greedy tokens agree exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.weights import params_from_jax

T = torch.from_numpy

# name → overrides of tiny_config shared by both packages
VARIANTS = {
    "llama": {},
    "qwen2": dict(n_heads=14, n_kv_heads=2, d_model=112, head_dim=16, qkv_bias=True,
                  tie_word_embeddings=True),  # G = 7, qkv-bias, tied embeddings
    "gemma2": dict(n_heads=4, n_kv_heads=2, head_dim=32, act_fn="gelu_tanh",
                   rmsnorm_unit_offset=True, post_norms=True, embed_scale=True,
                   attn_logit_softcap=20.0, final_logit_softcap=15.0, query_scale=24.0,
                   sliding_window=6, sliding_window_every=2, tie_word_embeddings=True),
    "qwen3": dict(qk_norm=True, rope_theta=1e6, rms_norm_eps=1e-6),
    "gemma3": dict(n_heads=4, n_kv_heads=1, head_dim=32, n_layers=3, qk_norm=True,
                   act_fn="gelu_tanh", rmsnorm_unit_offset=True, post_norms=True,
                   embed_scale=True, query_scale=32.0, sliding_window=5,
                   sliding_window_pattern=3, rope_local_theta=10000.0,
                   rope_scaling_factor=4.0, tie_word_embeddings=True),
}


def _models(name):
    over = VARIANTS[name]
    jc = jconfig.tiny_config(**over)
    tc = tconfig.tiny_config(**over)
    params = jllama.init_params(jc, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    for key in ("bq", "bk", "bv"):  # zero at init: make them count
        if key in tree["layers"]:
            tree["layers"][key] = (rng.standard_normal(tree["layers"][key].shape) * 0.2).astype(np.float32)
    for key in ("attn_norm", "mlp_norm", "q_norm", "k_norm", "attn_post_norm", "mlp_post_norm"):
        if key in tree["layers"]:
            tree["layers"][key] = tree["layers"][key] + (
                rng.standard_normal(tree["layers"][key].shape) * 0.1).astype(np.float32)
    return jc, tc, jax.tree.map(jnp.asarray, tree), tree


def _jax_dtype_name(d):
    return jnp.dtype(d).name


def test_config_twin_matches_every_jax_preset():
    jp, tp = jconfig.all_presets(), tconfig.all_presets()
    assert list(jp) == list(tp)
    for name in jp:
        for f in dataclasses.fields(jp[name]):
            a, b = getattr(jp[name], f.name), getattr(tp[name], f.name)
            if f.name == "dtype":
                assert _jax_dtype_name(a) == str(b).replace("torch.", ""), name
            else:
                assert a == b, (name, f.name)
    assert tp["qwen2.5-0.5b"].q_per_kv == 7 and tp["qwen2.5-0.5b"].head_dim_ == 64
    assert tp["qwen2.5-0.5b"].dtype == torch.bfloat16


def test_config_twin_hf_ingest_matches():
    cfg = {"architectures": ["Qwen2ForCausalLM"], "vocab_size": 1000, "hidden_size": 64,
           "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
           "intermediate_size": 128, "rope_theta": 1e6, "tie_word_embeddings": True,
           "eos_token_id": [3, 4], "sliding_window": 32, "use_sliding_window": False}
    a = jconfig.ModelConfig.from_hf_config(cfg, name="x")
    b = tconfig.ModelConfig.from_hf_config(cfg, name="x")
    for f in dataclasses.fields(a):
        if f.name != "dtype":
            assert getattr(a, f.name) == getattr(b, f.name), f.name


def test_params_from_jax_accepts_stacked_and_per_layer_forms():
    jc, tc, params, tree = _models("qwen2")
    stacked = params_from_jax(tree, tc, "cpu")
    listed = params_from_jax(
        {**tree, "layers": jax.tree.map(np.asarray, jllama.unstack_layer_params(params["layers"], jc.n_layers))},
        tc, "cpu",
    )
    assert len(stacked["layers"]) == jc.n_layers
    for a, b in zip(stacked["layers"], listed["layers"]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k])
            assert a[k].dtype == torch.float32
    np.testing.assert_array_equal(stacked["layers"][1]["wq"].numpy(), tree["layers"]["wq"][1])


def _forward_both(jc, tc, params, tree, tokens, start, lens, tables, caches=None, first_chunk=False):
    NB, BS = 40, 4
    if caches is None:
        caches = (jllama.init_kv_cache(jc, NB, BS, layered=True), tllama.init_kv_cache(tc, NB, BS, "cpu"))
    (jk, jv), (tk, tv) = caches
    jl, jk, jv = jax.block_until_ready(jllama.forward_paged(
        params, jc, jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(lens),
        jnp.asarray(tables), jk, jv, first_chunk=first_chunk,
    ))
    tp = params_from_jax(tree, tc, "cpu")
    tl, tk, tv = tllama.forward_paged(
        tp, tc, T(tokens), T(start), T(lens), T(tables), tk, tv, first_chunk=first_chunk,
    )
    return np.asarray(jl), tl.numpy(), ((jk, jv), (tk, tv))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_paged_matches_jax_first_chunk_then_paged(name):
    jc, tc, params, tree = _models(name)
    rng = np.random.default_rng(1)
    B = 3
    tables = np.arange(B * 8, dtype=np.int32).reshape(B, 8) + 2
    toks = rng.integers(0, jc.vocab_size, (B, 11)).astype(np.int32)
    lens = np.array([11, 7, 2], np.int32)
    start = np.zeros(B, np.int32)
    jl, tl, caches = _forward_both(jc, tc, params, tree, toks, start, lens, tables, first_chunk=True)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    for l in range(jc.n_layers):
        np.testing.assert_allclose(caches[1][0][l].numpy(), np.asarray(caches[0][0][l]), atol=1e-5)
    # Later chunks read the pages: C = 9 takes the chunk-kernel route,
    # C = 2 the decode-kernel route (their plain versions on the CPU).
    start = lens
    for C, lens in ((9, np.array([9, 4, 1], np.int32)), (2, np.array([2, 2, 1], np.int32))):
        toks = rng.integers(0, jc.vocab_size, (B, C)).astype(np.int32)
        jl, tl, caches = _forward_both(jc, tc, params, tree, toks, start, lens, tables, caches)
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
        assert (tl.argmax(-1) == jl.argmax(-1)).all()
        start = start + lens


@pytest.mark.parametrize("name", ["llama", "qwen2", "gemma2", "gemma3"])
def test_decode_multi_matches_jax(name):
    """Greedy bursts: tokens exact, and the per-step logits agree — read
    through the JAX package's logprob of each chosen token. Row 2 is
    inactive; row 1 runs past its table's capacity (its overshoot writes
    are dropped)."""
    jc, tc, params, tree = _models(name)
    rng = np.random.default_rng(2)
    B, NB, BS, P, K = 3, 40, 4, 6, 5
    tables = rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32)
    prompt = rng.integers(0, jc.vocab_size, (B, 10)).astype(np.int32)
    lens = np.array([10, 10, 10], np.int32)
    start = np.zeros(B, np.int32)
    _, _, caches = _forward_both(jc, tc, params, tree, prompt, start, lens, tables, first_chunk=True)
    (jk, jv), (tk, tv) = caches
    # row 1 continues from position 21 (capacity 24): steps 3.. overshoot
    pos = np.array([10, 21, 0], np.int32)
    active = np.array([1, 1, 0], np.int32)
    tok0 = np.array([5, 9, 0], np.int32)
    zeros = np.zeros(B, np.float32)
    out = jax.block_until_ready(jllama.decode_multi(
        params, jc, jnp.asarray(tok0), jnp.asarray(pos), jnp.asarray(active), jnp.asarray(tables),
        jk, jv, jax.random.PRNGKey(0), jnp.asarray(zeros), jnp.zeros(B, jnp.int32),
        jnp.ones(B, jnp.float32), num_steps=K, salts=jnp.arange(B, dtype=jnp.int32),
        want_logprobs=True,
    ))
    j_toks, j_logp = np.asarray(out[0]), np.asarray(out[1])
    tp = params_from_jax(tree, tc, "cpu")
    t = tllama.decode_multi(
        tp, tc, T(tok0), T(pos), T(active), T(tables), tk, tv, 0, T(zeros),
        torch.zeros(B, dtype=torch.int32), torch.ones(B), num_steps=K,
        salts=torch.arange(B), want_logits=True,
    )
    np.testing.assert_array_equal(t.tokens.numpy(), j_toks)
    t_logp = torch.log_softmax(t.logits, dim=-1).gather(-1, t.tokens[..., None])[..., 0]
    np.testing.assert_allclose(t_logp[:2].numpy(), j_logp[:2], atol=1e-4)
    assert bool(t.finite.all())
    # the caches agree after the burst (overshoot dropped on both sides)
    for l in range(jc.n_layers):
        np.testing.assert_allclose(tk[l].numpy(), np.asarray(out[2][l]), atol=1e-5)


def test_init_params_shapes_and_seed():
    c = tconfig.tiny_config(qkv_bias=True, tie_word_embeddings=True)
    a = tllama.init_params(c, 7, "cpu")
    b = tllama.init_params(c, 7, "cpu")
    assert "lm_head" not in a and len(a["layers"]) == c.n_layers
    assert a["layers"][0]["wq"].shape == (c.d_model, c.n_heads * c.head_dim_)
    assert all(torch.equal(a["layers"][1][k], b["layers"][1][k]) for k in a["layers"][1])
    assert not torch.equal(tllama.init_params(c, 8, "cpu")["embed"], a["embed"])
