"""The slice as a whole: a Llama-family decode with int8 weights whose
attention is the prototypes' decode attention with bf16 probabilities, in
the JAX package and in the port, on the same weights (params_from_jax) and
caches; and tools/prof_8b's entry point at a tiny size on the CPU.

JAX: llama.decode_multi(use_kernel=True) with ``llama.paged_attention``
patched to _prof_attn.decode_packed or decode_bf16 (as _prof_8b.py's modes
v2 and bf patch it), the Pallas kernels under force_tpu_interpret_mode,
compiled with XLA's excess precision off (so its bf16 roundings stay where
the TPU takes them). Port: models/llama.decode_multi with
``models.llama.paged_attention`` patched to decode_attention_bf16_ref. The
model is tiny_config in bf16 with int8 weights (head_dim 32, 4 q / 2 kv
heads, 2 layers) at block sizes 16 and 128; row 0 decodes across a page
edge, row 1 from an empty history, row 2 is inactive.

Greedy tokens agree exactly; the log-probability of each chosen token (the
JAX package's logprobs, the port's log-softmax of its logits) within
LOGP_ATOL = 0.05: both round the model's activations to bf16 at the same
points and sum in other orders, so a logit may land one bf16 step away (a
step is 2^-8..2^-7 of the logit, ~0.01-0.03 at these logits; measured
<= 0.019 at log-probabilities down to -4.3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.quantize import quantize_params as jquantize_params
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.quantize import init_quantized_params
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.ops.attention import decode_attention_bf16_ref
from dynamo_tpu_torch.tools import prof_8b
from tests.test_torch_proto_attention import load_script

LOGP_ATOL = 0.05
STRICT = {"xla_allow_excess_precision": False}
STEPS = 5


@pytest.fixture(scope="module")
def proto():
    return load_script("_prof_attn")


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _jax_patch(fn):
    def patched(q, k_c, v_c, bt, sp, cl, *, use_kernel, sm_scale, window, logit_cap):
        return fn(q, k_c, v_c, bt, sp, window, sm_scale=sm_scale, logit_cap=logit_cap)
    return patched


def _port_patch(q, k_c, v_c, bt, sp, cl, *, sm_scale, window, logit_cap):
    return decode_attention_bf16_ref(q, k_c, v_c, bt, sp, window, sm_scale=sm_scale,
                                     logit_cap=logit_cap)


@pytest.mark.parametrize("BS", [16, 128])
@pytest.mark.parametrize("kernel", ["decode_packed", "decode_bf16"])
def test_decode_multi_through_the_prototype_matches_the_port(proto, monkeypatch, kernel, BS):
    jc = jconfig.tiny_config(dtype=jnp.bfloat16)
    tc = tconfig.tiny_config(dtype=torch.bfloat16)
    q, _ = jquantize_params(jllama.init_params(jc, jax.random.PRNGKey(4)))
    tp = params_from_jax(jax.tree.map(np.asarray, q), tc, "cpu")
    rng = np.random.default_rng(BS)
    B, prompt_len = 3, 124  # row 0 crosses position 128 while decoding
    P = (prompt_len + STEPS + BS) // BS
    NB = B * P + 4
    tables = rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32)
    prompt = rng.integers(0, jc.vocab_size, (B, prompt_len)).astype(np.int32)
    lens = np.array([prompt_len, 0, prompt_len], np.int32)
    jk, jv = jllama.init_kv_cache(jc, NB, BS, layered=True)
    _, jk, jv = jax.block_until_ready(jllama.forward_paged(
        q, jc, jnp.asarray(prompt), jnp.zeros(B, jnp.int32), jnp.asarray(lens),
        jnp.asarray(tables), jk, jv, first_chunk=True))
    tk, tv = ([tattn.copy_to_sink_pool(_t(a)) for a in pools] for pools in (jk, jv))
    pos, active = np.array([prompt_len, 0, prompt_len], np.int32), np.array([1, 1, 0], np.int32)
    tok0, zeros = np.array([5, 9, 0], np.int32), np.zeros(B, np.float32)

    monkeypatch.setattr(jllama, "paged_attention", _jax_patch(getattr(proto, kernel)))

    def jax_decode(tok, p, act, tab, k, v):
        return jllama.decode_multi(
            q, jc, tok, p, act, tab, k, v, jax.random.PRNGKey(0), jnp.asarray(zeros),
            jnp.zeros(B, jnp.int32), jnp.ones(B, jnp.float32), num_steps=STEPS,
            use_kernel=True, salts=jnp.arange(B, dtype=jnp.int32), want_logprobs=True)

    jargs = (jnp.asarray(tok0), jnp.asarray(pos), jnp.asarray(active), jnp.asarray(tables),
             jk, jv)
    with pltpu.force_tpu_interpret_mode():
        out = jax.block_until_ready(
            jax.jit(jax_decode).lower(*jargs).compile(compiler_options=STRICT)(*jargs))
    j_toks, j_logp = np.asarray(out[0]), np.asarray(out[1])

    monkeypatch.setattr(tllama, "paged_attention", _port_patch)
    t = tllama.decode_multi(
        tp, tc, _t(tok0), _t(pos), _t(active), _t(tables), tk, tv, 0, _t(zeros),
        torch.zeros(B, dtype=torch.int32), torch.ones(B), num_steps=STEPS,
        salts=torch.arange(B), want_logits=True)
    np.testing.assert_array_equal(t.tokens.numpy(), j_toks)
    t_logp = torch.log_softmax(t.logits.float(), dim=-1).gather(-1, t.tokens[..., None])[..., 0]
    np.testing.assert_allclose(t_logp[:2].numpy(), j_logp[:2], atol=LOGP_ATOL, rtol=0)
    assert bool(t.finite.all())


def test_prof_8b_entry_point_runs_every_ported_mode_on_the_cpu(monkeypatch):
    """tools/prof_8b's main at a tiny size with device="cpu": every mode
    prints its time a step, the wrappers run their plain versions (no
    launch is counted), and the attention modes' first-step logits agree
    with each other while the floor's (no attention) do not."""
    for name, value in (("PB", "3"), ("PBS", "16"), ("PCTX", "20"), ("PSTEPS", "2")):
        monkeypatch.setenv(name, value)
    cfg = tconfig.tiny_config(dtype=torch.bfloat16)
    params = init_quantized_params(cfg, 0, "cpu")
    out = prof_8b.main([], device="cpu", config=cfg, params=params)
    assert list(out) == list(prof_8b.MODES)
    full = out["full"]["logits"]
    assert full.shape == (3, cfg.vocab_size) and bool(torch.isfinite(full).all())
    for mode in ("v2", "bf"):
        assert float((out[mode]["logits"] - full).abs().max()) <= 0.25
    assert float((out["floor"]["logits"] - full).abs().max()) > 0.25
    for mode, r in out.items():
        assert r["ms_step"] > 0 and r["tok_s"] > 0
        assert r["launches"] == {n: 0 for n in prof_8b.ATTENTION_KERNELS}
    # what chip_smoke.py holds the card's counts to: 2 layers x 2 steps x 4 calls
    assert prof_8b.expected_launches("v2", cfg, 2, 4) == {
        "paged_attention_decode": 0, "decode_packed": 16, "decode_bf16": 0}
    assert not any(prof_8b.expected_launches("floor", cfg, 2, 4).values())
    with pytest.raises(ValueError, match="not ported"):
        prof_8b.run(params, cfg, ["xla"], device="cpu")
