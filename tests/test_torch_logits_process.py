"""The port's logits processors and logprobs (dynamo_tpu_torch/ops/
logits_process.py, ops/sampling.compute_logprobs / top_logprobs) against
the JAX functions on the same inputs, made from seeds with numpy.

Tolerances: the processors are float32 elementwise arithmetic in the same
order as JAX's (a division or product by the repetition penalty, then two
subtractions, then a scatter-add), held to 1e-6 relative (XLA on the CPU
may contract a product and a subtraction into one fused step); logprobs
are float32 log-softmaxes, held to 2e-6 absolute. Integer outputs (counts,
masks, packed bias slots, top-N ids in order, ties included) are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import logits_process as jlp
from dynamo_tpu.ops import sampling as jsampling
from dynamo_tpu_torch.ops import logits_process as tlp
from dynamo_tpu_torch.ops import sampling as tsampling

B, V = 5, 97
RTOL, LOGP_ATOL = 1e-6, 2e-6


def _case(seed, bias_rows):
    """Logits, counts, prompt mask and parameters of B rows: row 0 neutral,
    the others with penalties and the given bias dicts packed."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (B, V)).astype(np.float32)
    counts = rng.integers(0, 3, (B, V)).astype(np.int32) * (rng.random((B, V)) < 0.2)
    pmask = rng.random((B, V)) < 0.15
    rep = np.array([1.0, 1.3, 0.8, 1.1, 2.0], np.float32)
    pres = np.array([0.0, 0.5, -0.4, 0.0, 1.5], np.float32)
    freq = np.array([0.0, 0.25, 0.0, -0.3, 2.0], np.float32)
    ids = np.full((B, jlp.MAX_BIAS_SLOTS), -1, np.int32)
    vals = np.zeros((B, jlp.MAX_BIAS_SLOTS), np.float32)
    for r, bias in enumerate(bias_rows):
        ids[r], vals[r] = jlp.pack_bias(bias, V)
    return logits, counts.astype(np.int32), pmask, (rep, pres, freq, ids, vals)


BIASES = {
    "empty": [{}, {}, {}, {}, {}],
    "additive": [{}, {3: 2.5, 90: -1.0}, {7: 0.5}, {}, {0: -3.0, 96: 4.0}],
    "ban and force": [{}, {5: -100}, {11: 100, 12: -100}, {13: -250.0}, {40: 150.0}],
    "out of vocabulary": [{}, {V: 5.0, -1: 2.0, 4: 1.0}, {}, {1000: -100}, {}],
}


def _jax_params(p):
    rep, pres, freq, ids, vals = p
    return jlp.ProcParams(rep=jnp.asarray(rep), pres=jnp.asarray(pres), freq=jnp.asarray(freq),
                          bias_ids=jnp.asarray(ids), bias_vals=jnp.asarray(vals))


def _torch_params(p):
    rep, pres, freq, ids, vals = p
    return tlp.ProcParams(*(torch.from_numpy(a) for a in (rep, pres, freq)),
                          bias_ids=torch.from_numpy(ids).long(), bias_vals=torch.from_numpy(vals))


@pytest.mark.parametrize("with_state", [True, False], ids=["state", "no-state"])
@pytest.mark.parametrize("bias", list(BIASES))
def test_apply_matches_jax(bias, with_state):
    logits, counts, pmask, p = _case(1, BIASES[bias])
    jstate = jlp.ProcState(out_counts=jnp.asarray(counts), prompt_mask=jnp.asarray(pmask))
    tstate = tlp.ProcState(torch.from_numpy(counts), torch.from_numpy(pmask))
    want = np.asarray(jax.block_until_ready(
        jlp.apply(jnp.asarray(logits), _jax_params(p), jstate if with_state else None)))
    got = tlp.apply(torch.from_numpy(logits), _torch_params(p), tstate if with_state else None)
    assert got.dtype == torch.float32 and got.shape == (B, V)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("bias", list(BIASES))
def test_apply_prompt_only_matches_jax(bias):
    logits, _, pmask, p = _case(2, BIASES[bias])
    want = np.asarray(jax.block_until_ready(
        jlp.apply_prompt_only(jnp.asarray(logits), jnp.asarray(pmask), _jax_params(p))))
    got = tlp.apply_prompt_only(torch.from_numpy(logits), torch.from_numpy(pmask),
                                _torch_params(p))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_neutral_rows_are_the_identity(dtype):
    """Neutral parameters leave every row as it was (cast to float32), bit
    for bit, whatever the counts and masks hold."""
    logits, counts, pmask, _ = _case(3, BIASES["empty"])
    x = torch.from_numpy(logits).to(dtype)
    state = tlp.ProcState(torch.from_numpy(counts), torch.from_numpy(pmask))
    for got in (tlp.apply(x, tlp.neutral_params(B), state),
                tlp.apply_prompt_only(x, state.prompt_mask, tlp.neutral_params(B))):
        assert torch.equal(got, x.float())


def test_record_tokens_matches_jax():
    _, counts, pmask, _ = _case(4, BIASES["empty"])
    toks = np.array([3, 3, 96, 0, 50], np.int32)
    active = np.array([1, 0, 1, 1, 0], np.int32)
    want = jlp.record_tokens(jlp.ProcState(jnp.asarray(counts), jnp.asarray(pmask)),
                             jnp.asarray(toks), jnp.asarray(active))
    state = tlp.ProcState(torch.from_numpy(counts.copy()), torch.from_numpy(pmask))
    got = tlp.record_tokens(state, torch.from_numpy(toks).long(), torch.from_numpy(active))
    assert got.out_counts is state.out_counts  # in place: a graph keeps its address
    np.testing.assert_array_equal(got.out_counts.numpy(), np.asarray(want.out_counts))


@pytest.mark.parametrize("generated", [(), (4, 4, 9, 96), (V + 3, -2, 1)],
                         ids=["fresh", "preempted", "out-of-vocabulary"])
def test_reset_slot_and_count_token_match_jax(generated):
    _, counts, pmask, _ = _case(5, BIASES["empty"])
    prompt = [0, 17, 17, 95, 300]
    jst = jlp.ProcState(jnp.asarray(counts), jnp.asarray(pmask))
    jst = jlp.count_token(jlp.reset_slot(jst, 2, prompt, generated), 2, 17)
    tst = tlp.ProcState(torch.from_numpy(counts.copy()), torch.from_numpy(pmask.copy()))
    tst = tlp.count_token(tlp.reset_slot(tst, 2, prompt, generated), 2, 17)
    np.testing.assert_array_equal(tst.out_counts.numpy(), np.asarray(jst.out_counts))
    np.testing.assert_array_equal(tst.prompt_mask.numpy(), np.asarray(jst.prompt_mask))
    np.testing.assert_array_equal(tlp.prompt_hot(prompt, V), jlp.prompt_hot(prompt, V))


@pytest.mark.parametrize("bias", [
    None, {}, {5: 1.0}, {5: -100, 6: 100, 7: 99.5, 8: -101.0},
    {k: float(k % 7) - 3.0 for k in range(400)},  # truncated to the 300 most extreme
    {-1: 3.0, V: 2.0, 10: -0.5},
], ids=["none", "empty", "one", "ban/force", "truncated", "out-of-vocabulary"])
def test_pack_bias_matches_jax(bias):
    vocab = 1000 if bias and len(bias) > 300 else V
    ids, vals = tlp.pack_bias(bias, vocab)
    want_ids, want_vals = jlp.pack_bias(bias, vocab)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(vals, want_vals)
    assert ids.dtype == np.int32 and vals.dtype == np.float32


def _logit_cases():
    rng = np.random.default_rng(6)
    normal = rng.normal(0, 2, (B, V)).astype(np.float32)
    # bf16 logits: many exact ties near the top
    coarse = np.round(rng.normal(0, 1, (B, V)) * 4) / 4
    flat = np.zeros((B, V), np.float32)
    banned = normal.copy()
    banned[:, 10:90] = -1e9
    return {"normal": normal, "ties": coarse.astype(np.float32), "flat": flat, "banned": banned}


@pytest.mark.parametrize("name", list(_logit_cases()))
@pytest.mark.parametrize("n", [1, 5, 20])
def test_logprobs_and_top_logprobs_match_jax(name, n):
    x = _logit_cases()[name]
    ids = np.random.default_rng(7).integers(0, V, B).astype(np.int32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jx = jnp.asarray(x, jdtype)
        tx = torch.from_numpy(x).to(dtype)
        want_lp = np.asarray(jax.block_until_ready(
            jsampling.compute_logprobs(jx, jnp.asarray(ids))))
        want_v, want_i = (np.asarray(a)
                          for a in jax.block_until_ready(jsampling.top_logprobs(jx, n)))
        got_lp = tsampling.compute_logprobs(tx, torch.from_numpy(ids).long())
        got_v, got_i = tsampling.top_logprobs(tx, n)
        assert got_lp.dtype == got_v.dtype == torch.float32 and got_v.shape == (B, n)
        np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=0, atol=LOGP_ATOL)
        np.testing.assert_allclose(got_v.numpy(), want_v, rtol=0, atol=LOGP_ATOL)
        np.testing.assert_array_equal(got_i.numpy(), want_i)  # ties to the lower id
