"""Speculative decoding in the port (engines/gpu/spec.py, DeviceRunner.run_spec,
ops/sampling.spec_verify_sample) against the JAX package on the same
inputs and weights:

  - ``spec_verify_sample``: greedy rows give JAX's ``emitted`` and
    ``counts`` exactly (proposals that all match, part, or fail at once,
    rows with fewer proposals, none); sampled rows keep the target
    distribution (total variation < 0.04 over 6,000 keys, as
    tests/test_spec_sampling.py holds JAX's), with top-k and top-p too;
  - ``NgramSpecDecoder.propose`` = JAX's on the same histories, its
    incremental index included;
  - ``TorchEngine(device="cpu", cuda_graphs=False, spec_mode="ngram")``
    greedy streams = ``JaxEngine(spec_mode="ngram")``'s and the plain
    port's, with equal ``spec_proposed`` / ``spec_accepted``: the arbitrary
    and repetitive prompts of tests/test_spec_decode.py, a concurrent
    batch, max_model_len 32, the int8 miniature with the fused layer;
  - the port alone: sampled and default-temperature requests complete, a
    logprobs or processor row keeps every tick on the fused path, the
    pipeline depth is 1 under spec and 2 when suspended, a failing verify
    takes the tick retry, the verify's captures count under
    ``runner.spec_verify`` with JAX's budget, and a worker main's occupancy
    brownout suspends spec and its recovery restores it.

Greedy comparisons are exact (token ids); the distribution checks hold a
total variation below 0.04."""

import asyncio
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.engines.tpu import spec as jspec
from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.quantize import quantize_params
from dynamo_tpu.ops import sampling as jsampling
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu_torch.engines.gpu import runner as trunner
from dynamo_tpu_torch.engines.gpu import spec as tspec
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.ops import sampling as tsampling
from dynamo_tpu_torch.runtime import context as tcontext
from dynamo_tpu_torch.runtime import device_observe as tdo

ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            prefill_chunk=32, decode_steps=4)
SPEC = dict(spec_mode="ngram", spec_ngram=2, spec_k=3)
TV_LIMIT = 0.04


# -- spec_verify_sample ------------------------------------------------------


def _verify_both(logits, props, plen, temp, topk=None, topp=None):
    B, C, _ = logits.shape
    topk = np.zeros(B, np.int32) if topk is None else topk
    topp = np.ones(B, np.float32) if topp is None else topp
    want = jax.block_until_ready(jsampling.spec_verify_sample(
        jnp.asarray(logits), jnp.asarray(props), jnp.asarray(plen), jax.random.PRNGKey(0),
        jnp.asarray(temp), jnp.asarray(topk), jnp.asarray(topp)))
    keys = tsampling.fold_row_keys(0, torch.arange(B)[:, None], torch.arange(C)[None, :] + 1)
    got = tsampling.spec_verify_sample(
        torch.from_numpy(logits), torch.from_numpy(props), torch.from_numpy(plen),
        torch.from_numpy(temp), torch.from_numpy(topk), torch.from_numpy(topp), row_keys=keys)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _greedy_case(kind):
    """(logits [B, C, V], proposals [B, C-1], prop_len [B]) with C 4."""
    rng = np.random.default_rng(1)
    B, C, V = 6, 4, 32
    logits = rng.standard_normal((B, C, V)).astype(np.float32)
    amax = logits.argmax(-1)
    props = amax[:, : C - 1].copy()
    plen = np.full(B, C - 1, np.int32)
    if kind == "part":
        for b in range(B):  # row b mismatches at position b % C (C - 1: all match)
            j = b % C
            if j < C - 1:
                props[b, j] = (props[b, j] + 1) % V
    elif kind == "short":
        plen = np.array([0, 1, 2, 3, 1, 2], np.int32)
        props[1, 0] = (props[1, 0] + 3) % V  # a mismatch at the only proposal
    elif kind == "random":
        props = rng.integers(0, V, (B, C - 1))
        props[:3] = amax[:3, : C - 1]
        plen = rng.integers(0, C, B).astype(np.int32)
    elif kind == "tie":  # two maximal logits: the lower id is the argmax on both
        logits[:, :, 7] = logits[:, :, 3] = logits.max() + 1.0
        props[:] = 3
    return logits, props.astype(np.int32), plen


@pytest.mark.parametrize("kind", ["match", "part", "short", "random", "tie"])
def test_greedy_verify_equals_jax(kind):
    logits, props, plen = _greedy_case(kind)
    (w_emit, w_counts), (g_emit, g_counts) = _verify_both(
        logits, props, plen, np.zeros(len(plen), np.float32))
    np.testing.assert_array_equal(g_counts, w_counts)
    np.testing.assert_array_equal(g_emit, w_emit)
    if kind == "match":
        assert (g_counts == 4).all()
    if kind == "tie":
        assert (g_emit[:, :3] == 3).all() and (g_counts == 4).all()


@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_zero_proposals_give_one_token(temp):
    B, C, V = 3, 3, 16
    logits = np.random.default_rng(2).standard_normal((B, C, V)).astype(np.float32)
    props = np.zeros((B, C - 1), np.int32)
    plen = np.zeros(B, np.int32)
    (w_emit, w_counts), (g_emit, g_counts) = _verify_both(
        logits, props, plen, np.full(B, temp, np.float32))
    assert g_counts.tolist() == w_counts.tolist() == [1] * B
    assert (g_emit[:, 1:] == 0).all()
    if temp == 0.0:
        np.testing.assert_array_equal(g_emit, w_emit)


def _first_token_dist(logits_row, prop, temp, topk, topp, n=6000):
    V = logits_row.shape[-1]
    logits = torch.from_numpy(logits_row).expand(n, 2, V).contiguous()
    keys = tsampling.fold_row_keys(7, torch.arange(n)[:, None], torch.tensor([[11, 12]]))
    emitted, counts = tsampling.spec_verify_sample(
        logits, torch.full((n, 1), prop), torch.ones(n, dtype=torch.int32),
        torch.full((n,), temp), torch.full((n,), topk, dtype=torch.int32),
        torch.full((n,), topp), row_keys=keys)
    assert int(counts.min()) >= 1 and int(counts.max()) <= 2
    return np.bincount(emitted[:, 0].numpy(), minlength=V) / n


def _target(logits_row, temp, topk, topp):
    """sample_tokens' filtered target: top-k, then top-p over the kept mass
    of the tempered softmax, renormalised."""
    z = logits_row.astype(np.float64) / temp
    order = np.argsort(-z, kind="stable")
    p = np.exp(z[order] - z[order].max())
    p /= p.sum()
    keep = np.ones_like(p, bool)
    if topk > 0:
        keep[topk:] = False
    keep &= (np.cumsum(p) - p) < topp
    out = np.zeros_like(p)
    out[order[keep]] = p[keep]
    return out / out.sum()


@pytest.mark.parametrize("temp,topk,topp", [(1.0, 0, 1.0), (0.7, 4, 1.0), (1.0, 0, 0.8)])
@pytest.mark.parametrize("which", ["argmax", "argmin", "3"])
def test_rejection_sampling_keeps_the_target_distribution(temp, topk, topp, which):
    logits = (np.random.default_rng(0).standard_normal(16) * 2.0).astype(np.float32)
    target = _target(logits, temp, topk, topp)
    prop = {"argmax": int(np.argmax(logits)), "argmin": int(np.argmin(logits)), "3": 3}[which]
    emp = _first_token_dist(logits, prop, temp, topk, topp)
    tv = 0.5 * np.abs(emp - target).sum()
    assert tv < TV_LIMIT, (tv, emp, target)


def test_verify_noise_is_keyed_by_position_with_its_own_tags():
    """A row's draws depend on (seed, salt, token index) alone: the same
    keys give the same tokens in another batch, and the uniform and the
    Gumbel draws use their own tags (uniforms are not the keys' plain
    hash)."""
    V = 16
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 3, V)).astype(
        np.float32))
    keys = tsampling.fold_row_keys(5, torch.arange(4)[:, None], torch.arange(3)[None, :] + 40)
    args = (torch.zeros((4, 2), dtype=torch.int64), torch.zeros(4, dtype=torch.int32),
            torch.ones(4), torch.zeros(4, dtype=torch.int32), torch.ones(4))
    a = tsampling.spec_verify_sample(logits, *args, row_keys=keys)
    b = tsampling.spec_verify_sample(logits[2:], *(x[2:] for x in args), row_keys=keys[2:])
    assert torch.equal(a[0][2:], b[0]) and torch.equal(a[1][2:], b[1])
    u = tsampling.row_uniform(keys ^ tsampling.SPEC_UNIFORM_TAG)
    assert not torch.equal(u, tsampling.row_uniform(keys))
    assert bool(((u > 0) & (u < 1)).all())


# -- proposals ---------------------------------------------------------------


def _decoder(pkg, n, k):
    return pkg.NgramSpecDecoder(types.SimpleNamespace(
        args=types.SimpleNamespace(spec_ngram=n, spec_k=k)))


@pytest.mark.parametrize("n,k,alphabet", [(2, 3, 4), (3, 4, 3), (1, 2, 3), (4, 5, 2)])
def test_propose_equals_jax_with_the_incremental_index(n, k, alphabet):
    rng = np.random.default_rng(n * 10 + k)
    hist = rng.integers(0, alphabet, 12).tolist()
    jseq = types.SimpleNamespace(all_tokens=list(hist), ngram_index={}, ngram_upto=0)
    tseq = types.SimpleNamespace(all_tokens=list(hist), ngram_index={}, ngram_upto=0)
    jd, td = _decoder(jspec, n, k), _decoder(tspec, n, k)
    proposed = 0
    for step in range(30):
        want, got = jd.propose(jseq), td.propose(tseq)
        assert got == want, step
        assert tseq.ngram_index == jseq.ngram_index and tseq.ngram_upto == jseq.ngram_upto
        proposed += bool(got)
        more = rng.integers(0, alphabet, int(rng.integers(1, 4))).tolist()
        jseq.all_tokens += more
        tseq.all_tokens += more
    assert proposed > 5


def test_propose_examples():
    d = _decoder(tspec, 2, 3)
    seq = lambda t: types.SimpleNamespace(all_tokens=list(t), ngram_index={}, ngram_upto=0)  # noqa: E731
    assert d.propose(seq([1, 2, 3, 4, 1, 2])) == [3, 4, 1]
    assert d.propose(seq([1, 2, 3, 4, 5, 6])) == []
    assert d.propose(seq([7, 8, 1, 7, 8, 9, 5, 7, 8]))[:1] == [9]  # the latest occurrence
    s = seq([1, 2, 3])
    assert d.propose(s) == []
    s.all_tokens += [1, 2]
    assert d.propose(s) == [3, 1, 2]


# -- engines -----------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jc = jconfig.tiny_config()
    params = jllama.init_params(jc, jax.random.PRNGKey(5))
    return jc, params, jax.tree.map(np.asarray, params)


def _jax_engine(weights, **over):
    jc, params, _ = weights
    return JaxEngine(JaxEngineArgs(config=jc, **{**ARGS, **over}), params=params)


def _torch_engine(weights, **over):
    _, _, tree = weights
    tc = tconfig.tiny_config()
    return TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                       **{**ARGS, **over}),
                       params=params_from_jax(tree, tc, "cpu"))


def _req(proto, prompt, max_tokens, **sampling):
    return proto.PreprocessedRequest(
        token_ids=[int(t) for t in prompt], request_id="r",
        sampling=proto.SamplingOptions(**{"temperature": 0.0, **sampling}),
        stop=proto.StopConditions(max_tokens=max_tokens))


async def _one(engine, proto, context, prompt, max_tokens, **sampling):
    toks, reason = [], None
    async for out in engine.generate(_req(proto, prompt, max_tokens, **sampling),
                                     context.Context()):
        assert out.error is None, out.error
        toks += out.token_ids
        reason = out.finish_reason
    return toks, reason.value


async def _serve(engine, proto, context, prompts, max_tokens):
    try:
        outs = await asyncio.gather(*(_one(engine, proto, context, p, max_tokens)
                                      for p in prompts))
        return outs, engine.stats()
    finally:
        await engine.stop()


def _three(weights, **over):
    """JaxEngine with spec, the port with spec, the port without."""
    return ((_jax_engine(weights, **SPEC, **over), jproto, jcontext),
            (_torch_engine(weights, **SPEC, **over), tproto, tcontext),
            (_torch_engine(weights, **over), tproto, tcontext))


@pytest.mark.parametrize("prompt", [list(range(10, 26)), [5, 6, 7, 8] * 5, [9, 4] * 8],
                         ids=["arbitrary", "repetitive", "looping"])
async def test_greedy_streams_and_counts_equal_jax(weights, prompt, monkeypatch):
    from dynamo_tpu_torch.runtime import perf_ledger

    monkeypatch.setattr(perf_ledger, "_LEDGER", None)  # a ledger of this test's own
    (je, jp, jc), (te, tp, tc), (pe, pp, pc) = _three(weights)
    want, jstats = await _serve(je, jp, jc, [prompt], 40)
    got, tstats = await _serve(te, tp, tc, [prompt], 40)
    ledger_samples = sum(r["samples"] for r in te._perf.snapshot()["decode"])
    plain, _ = await _serve(pe, pp, pc, [prompt], 40)
    assert got == want == plain
    assert (tstats["spec_proposed"], tstats["spec_accepted"]) == (
        jstats["spec_proposed"], jstats["spec_accepted"])
    assert tstats["spec_proposed"] > 0 and tstats["spec_ticks"] > 0
    assert tstats["pipeline_depth"] == 1 and tstats["nonfinite_logit_rows"] == 0
    # as JAX's, a verify feeds neither the step metrics nor the perf ledger:
    # only the fused bursts (steps counts both) are observed
    assert te.step_metrics.step_duration.count(phase="decode") == (
        tstats["decode_steps"] - tstats["spec_ticks"])
    assert ledger_samples == tstats["decode_steps"] - tstats["spec_ticks"]


async def test_concurrent_batch_equals_jax(weights):
    prompts = [[5, 6, 7, 8] * 4, list(range(30, 46)), [9, 9, 9, 9] * 4, [9, 4] * 8]
    (je, jp, jc), (te, tp, tc), (pe, pp, pc) = _three(weights)
    want, _ = await _serve(je, jp, jc, prompts, 24)
    got, stats = await _serve(te, tp, tc, prompts, 24)
    plain, _ = await _serve(pe, pp, pc, prompts, 24)
    assert got == want == plain
    assert stats["spec_ticks"] > 0


# Prompts on which the tiny model's greedy stream loops within a few
# tokens, so proposals fire early.
LOOPING = ([9, 9, 9, 9] * 4, [3, 4] * 12)


@pytest.mark.parametrize("prompt", [[3, 4] * 12, [9, 9, 9, 9] * 4], ids=["room-8", "room-16"])
async def test_max_model_len_caps_the_verify(weights, prompt):
    (je, jp, jc), (te, tp, tc), (pe, pp, pc) = _three(weights, max_model_len=32)
    want, jstats = await _serve(je, jp, jc, [prompt], 64)
    got, stats = await _serve(te, tp, tc, [prompt], 64)
    plain, _ = await _serve(pe, pp, pc, [prompt], 64)
    assert got == want == plain
    (toks, reason), = got
    assert len(prompt) + len(toks) == 32 - 1 + 1 and reason == "length"
    assert (stats["spec_proposed"], stats["spec_accepted"]) == (
        jstats["spec_proposed"], jstats["spec_accepted"])
    if len(prompt) == 16:
        assert stats["spec_ticks"] > 0


# A two-layer miniature the fused layer takes (head_dim 128, GQA 2), as
# tests/test_torch_engine_int8.py's.
INT8_CFG = dict(name="int8-mini", d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
                d_ff=512, vocab_size=512, head_dim=128, rope_theta=10000.0)
INT8_ARGS = dict(ARGS, block_size=16)


# Two int8 streams computed on other paths (the port's unfused layers round
# each bf16 product where JAX's XLA and the fused layer keep float32) may
# part where the two best logits of the port's dense reference lie within
# this of each other: one bf16 step at the miniature's logits (|l| ~ 2-4,
# std 1). The one parting measured, at token 21 of the [3, 4] * 12
# stream, read 0.0094.
NEAR_TIE = 0.02


def _dense_logits(params, cfg, seq):
    """The port's dense forward over ``seq``: logits [len(seq), V]."""
    from dynamo_tpu_torch.models import llama

    with torch.inference_mode():
        kc, vc = llama.init_kv_cache(cfg, (len(seq) + 15) // 16, 16, "cpu")
        logits, _, _ = llama.forward_paged(
            params, cfg, torch.tensor([seq]), torch.zeros(1, dtype=torch.int32),
            torch.tensor([len(seq)], dtype=torch.int32),
            torch.arange(len(kc[0]), dtype=torch.int32)[None], kc, vc, all_logits=True,
            first_chunk=True)
    return logits[0].float()


def _agree(prompts, got, want, params, cfg):
    """Streams equal token for token, except that each may part once where
    the dense reference's best two lie within NEAR_TIE (it is compared up
    to there); returns the tokens compared exactly."""
    exact = 0
    for prompt, (a, ra), (b, rb) in zip(prompts, got, want):
        assert len(a) == len(b) and ra == rb
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            exact += len(a)
            continue
        row = _dense_logits(params, cfg, [int(t) for t in prompt] + a[:i])[-1]
        gap = float(row.max() - torch.minimum(row[a[i]], row[b[i]]))
        assert gap <= NEAR_TIE, (prompt, i, a[i], b[i], gap)
        exact += i
    return exact


async def test_int8_fused_miniature_equals_jax():
    """The int8 miniature: the port's spec engine with the fused layer on
    (its verifies run the unfused layers, its declined ticks the fused
    one) against JaxEngine(spec) on JAX's unfused int8 path and the plain
    port with the fused layer, token for token up to one near tie a stream
    (NEAR_TIE)."""
    jc = jconfig.ModelConfig(**INT8_CFG, dtype=jnp.bfloat16)
    tc = tconfig.ModelConfig(**INT8_CFG)
    q, _ = quantize_params(jllama.init_params(jc, jax.random.PRNGKey(3)))
    tree = jax.tree.map(np.asarray, q)
    prompts = [*LOOPING, list(np.random.default_rng(1).integers(3, 500, 30))]

    def port(**over):
        return TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                           quantization="int8", use_megakernel=True,
                                           **INT8_ARGS, **over),
                           params=params_from_jax(tree, tc, "cpu"))

    je = JaxEngine(JaxEngineArgs(config=jc, quantization="int8", use_megakernel=False,
                                 **INT8_ARGS, **SPEC), params=q)
    te, pe = port(**SPEC), port()
    assert te.runner.use_megakernel
    want, _ = await _serve(je, jproto, jcontext, prompts, 24)
    got, stats = await _serve(te, tproto, tcontext, prompts, 24)
    plain, _ = await _serve(pe, tproto, tcontext, prompts, 24)
    params = te.runner.params
    total = sum(len(t) for t, _ in got)
    assert _agree(prompts, got, want, params, tc) >= total * 3 // 4
    assert _agree(prompts, got, plain, params, tc) >= total * 3 // 4
    assert all(len(t) == 24 and r == "length" for t, r in got)
    assert stats["spec_ticks"] > 0 and stats["mk_fused_bursts"] > 0
    assert stats["nonfinite_logit_rows"] == 0


@pytest.mark.parametrize("sampling", [dict(temperature=0.9, top_p=0.9),
                                      dict(temperature=None), dict(temperature=0.05)],
                         ids=["sampled", "default-temperature", "near-greedy"])
async def test_sampled_requests_complete_under_spec(weights, sampling):
    """A sampled request beside a greedy one that loops: the ticks the
    greedy row's proposals start verify the sampled row too (its draws
    through the rejection-sampling verify), and both complete."""
    engine = _torch_engine(weights, **SPEC)
    try:
        (toks, reason), (greedy, _) = await asyncio.gather(
            _one(engine, tproto, tcontext, [7, 8] * 8, 60, **sampling),
            _one(engine, tproto, tcontext, LOOPING[0], 60))
        assert len(toks) == 60 and reason == "length" and len(greedy) == 60
        assert engine.spec_ticks > 0
        assert all(0 <= t < 512 for t in toks)
    finally:
        await engine.stop()


@pytest.mark.parametrize("sampling", [dict(logprobs=0), dict(logprobs=2),
                                      dict(repetition_penalty=1.3), dict(min_p=0.1)],
                         ids=["logprobs", "top-logprobs", "repetition-penalty", "min-p"])
async def test_logprobs_or_processor_row_keeps_every_tick_fused(weights, sampling):
    spec, plain = _torch_engine(weights, **SPEC), _torch_engine(weights)
    outs = []
    for engine in (spec, plain):
        try:
            outs.append(await asyncio.gather(
                _one(engine, tproto, tcontext, LOOPING[1], 24, **sampling),
                _one(engine, tproto, tcontext, LOOPING[0], 24)))
        finally:
            await engine.stop()
    assert outs[0] == outs[1]
    assert spec.spec_ticks == spec.spec_proposed == 0
    assert spec.steps > 0


async def test_pipeline_depth_is_one_under_spec_and_two_when_suspended(weights):
    engine = _torch_engine(weights, **SPEC)
    plain = _torch_engine(weights)
    try:
        assert engine.stats()["pipeline_depth"] == 1
        engine.set_spec_suspended(True)
        assert engine.stats()["pipeline_depth"] == 2
        parked = await _one(engine, tproto, tcontext, LOOPING[0], 24)
        assert engine.spec_ticks == 0 and engine.steps > 0
        engine.set_spec_suspended(False)
        assert engine.stats()["pipeline_depth"] == 1
        live = await _one(engine, tproto, tcontext, LOOPING[0], 24)
        assert engine.spec_ticks > 0
        want = await _one(plain, tproto, tcontext, LOOPING[0], 24)
        assert parked == live == want
    finally:
        await engine.stop()
        await plain.stop()
    assert "spec_proposed" not in plain.stats()


def test_spec_mode_other_than_ngram_is_refused(weights):
    with pytest.raises(ValueError, match="spec_mode"):
        _torch_engine(weights, spec_mode="eagle")


async def test_a_failing_verify_takes_the_tick_retry(weights, monkeypatch):
    """The verify raising once (after its proposals, before any emission):
    the tick is retried as a decode tick's is, and the stream equals the
    unpoisoned one."""
    from dynamo_tpu_torch.engines.gpu import engine as tengine

    monkeypatch.setattr(tengine.asyncio, "sleep", _no_backoff(asyncio.sleep))
    prompt = LOOPING[0]
    clean = _torch_engine(weights, **SPEC)
    poisoned = _torch_engine(weights, **SPEC)
    run_spec, calls = poisoned.runner.run_spec, []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected verify failure")
        return run_spec(*a, **kw)

    poisoned.runner.run_spec = flaky
    try:
        want = await _one(clean, tproto, tcontext, prompt, 30)
        got = await _one(poisoned, tproto, tcontext, prompt, 30)
    finally:
        await clean.stop()
        await poisoned.stop()
    assert got == want and len(calls) > 2
    assert poisoned._failure is None and poisoned._consecutive_tick_failures == 0


def _no_backoff(sleep):
    async def quick(s, *a, **kw):
        return await sleep(0 if s >= 0.05 else s, *a, **kw)
    return quick


# -- the verify's captures (compile telemetry) ---------------------------------


class _StandInCapture:
    """A CapturedCall that records its function instead of a graph."""

    def __init__(self, fn, pool=None, stream=None):
        self.fn, self.replays = fn, 0
        fn()

    def replay(self):
        self.replays += 1
        self.fn()


@contextlib.contextmanager
def _stand_in_card(monkeypatch, runner):
    """run_spec's capture path on the CPU: no-op stream calls, a stand-in
    capture, and the runner's device read as a card only at the capture
    site (the verify itself runs on the CPU tensors)."""
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(trunner, "CapturedCall", _StandInCapture)
    cpu, card = runner.device, types.SimpleNamespace(type="cuda")
    verify, site = runner._verify, runner._replay_or_capture_spec

    def verify_on_cpu(io, nb):
        runner.device = cpu
        try:
            verify(io, nb)
        finally:
            runner.device = card

    def site_on_card(key, io):
        runner.device, runner._verify = card, verify_on_cpu
        try:
            site(key, io)
        finally:
            runner.device, runner._verify = cpu, verify

    runner._replay_or_capture_spec = site_on_card
    runner.args.cuda_graphs = True
    try:
        yield
    finally:
        runner.args.cuda_graphs = False
        del runner._replay_or_capture_spec  # the class's own again


def test_verify_captures_count_under_jaxs_program_and_budget(monkeypatch):
    """A spec runner's captures (stand-ins on the CPU): one a new (width,
    C) key under runner.spec_verify with JAX's budget, kept apart from the
    decode graphs; a replay gives the eager verify's outputs."""
    w = tdo.CompileWatcher()
    monkeypatch.setattr(tdo, "_WATCHER", w)
    args = TorchEngineArgs(config=tconfig.tiny_config(), device="cpu", cuda_graphs=False,
                           max_model_len=256, block_size=4, num_kv_blocks=80, max_num_seqs=2,
                           decode_steps=2, **SPEC)
    runner = trunner.DeviceRunner(args)
    budget = runner._decode_sig_budget
    assert w.snapshot()["programs"][trunner.SPEC_PROGRAM]["budget"] == budget == 20
    C = 4
    tokens = np.array([[5, 6, 7, 8], [9, 4, 0, 0]], np.int64)
    start = np.array([10, 3], np.int32)
    lens = np.array([4, 2], np.int32)
    tables = np.arange(64, dtype=np.int32).reshape(2, 32)
    eager = runner.run_spec(tokens, start, lens, tables[:, :4])
    with _stand_in_card(monkeypatch, runner):
        for nb in (4, 4, 8, 32, 8):
            out = runner.run_spec(tokens, start, lens, tables[:, :nb])
            if nb == 4:
                for a, b in zip(out, eager):
                    np.testing.assert_array_equal(a, b)
    assert set(runner.spec_graphs) == {("spec", 4, C), ("spec", 8, C), ("spec", 32, C)}
    assert not runner.graphs  # the decode graphs' dictionary holds none of them
    assert sum(g.replays for g in runner.spec_graphs.values()) == 2
    st = w.snapshot()["programs"][trunner.SPEC_PROGRAM]
    assert st["compiles"] == st["signatures"] == 3 and st["storms"] == 0
    assert runner.spec_eager == 1 + 3  # the eager call, then each capture's first run
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        runner.args.cuda_graphs = True
        try:
            runner.run_spec(tokens, start, lens, tables[:, :4])
        finally:
            runner.args.cuda_graphs = False


# -- the worker main ---------------------------------------------------------


async def test_occupancy_brownout_suspends_spec_and_recovery_restores_it(monkeypatch):
    """A `--speculative ngram` worker main's overload plane: the KV pool
    read as 99 % full puts the worker in brownout, which parks spec (depth
    2); the pool read as empty recovers it, which restores spec (depth 1)."""
    from dynamo_tpu_torch.engines.gpu import block_pool
    from dynamo_tpu_torch.runtime.discovery import MemoryDiscovery
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.worker import __main__ as tworker

    monkeypatch.setenv("DYN_TPU_WORKER_ID", "259")
    monkeypatch.setenv("DYN_TPU_LOAD_REPORT_INTERVAL_S", "0.05")
    occupancy = [0.0]
    monkeypatch.setattr(block_pool.BlockPool, "usage", property(lambda self: occupancy[0]))
    rt = DistributedRuntime(discovery=MemoryDiscovery(), bus="spec-brownout")
    args = tworker.build_parser().parse_args([
        "--model", "tiny", "--num-kv-blocks", "64", "--max-num-seqs", "2",
        "--max-model-len", "128", "--prefill-chunk", "32", "--decode-steps", "4",
        "--device", "cpu", "--speculative", "ngram", "--spec-k", "3", "--spec-ngram", "2"])
    worker = await tworker.serve_worker(args, rt)
    engine = worker.engine

    async def until(cond, what):
        for _ in range(400):
            if cond():
                return
            await asyncio.sleep(0.025)
        raise AssertionError(what)

    try:
        assert engine.args.spec_mode == "ngram" and engine.stats()["pipeline_depth"] == 1
        occupancy[0] = 0.99
        await until(lambda: engine._spec_suspended, "brownout did not suspend spec")
        assert engine.stats()["pipeline_depth"] == 2
        occupancy[0] = 0.0
        await until(lambda: not engine._spec_suspended, "recovery did not restore spec")
        assert engine.stats()["pipeline_depth"] == 1
    finally:
        await worker.close()
        await rt.shutdown(grace_period=1)
