"""TorchEngine (device="cpu", cuda_graphs=False) at pipeline depth 2
serving logits processors, min_p and logprobs against JaxEngine at depth 2
on the same weights: the tiny float32 config (unfused decode) and the int8
fused-layer miniature (the port's plain version of the fused layer; JAX's
megakernel gate on, its Pallas kernel in interpret mode).

One mixed batch a config: plain rows, repetition / presence / frequency
penalty rows, a row whose logit_bias bans the tokens its plain stream
takes, a row that forces one token with +100, a greedy min_p row, logprobs
0, 5 and 20, and three min_p rows at temperature 0.8. Greedy streams are
token for token JAX's; each token's logprob and its top-N are held within
LOGPROB_TOL (the float32 config: the two models' logits agree to ~1e-4;
the int8 one: bf16 logits, whose neighbouring values lie 2^-8 apart
relative, and XLA on the CPU keeps the kernel's bf16 intermediates in
float32 where the port rounds them: ~0.02 measured), the top-N ids where
their values lie further apart than that. A stream may part from JAX's
only at a near tie, once a config (``_parting``). Then: plain rows stream
what they stream alone, min_p moves no greedy stream and at temperature
0.8 every sampled token lies in the set JAX's min_p filter keeps (sampled
streams differ from JAX's: the port's noise is not threefry), and a
penalised stream preempted and recomputed stays JAX's.
"""

import asyncio
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.quantize import quantize_params
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.runtime import context as tcontext

JAX = types.SimpleNamespace(proto=jproto, Context=jcontext.Context)
TORCH = types.SimpleNamespace(proto=tproto, Context=tcontext.Context)
ARGS = dict(block_size=4, num_kv_blocks=96, max_num_seqs=4, max_model_len=96,
            prefill_chunk=32, decode_steps=4)
INT8_CFG = dict(name="int8-mini", d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
                vocab_size=512, head_dim=128, rope_theta=10000.0)
LOGPROB_TOL = {"f32": 2e-4, "int8-fused": 0.05}
MAX_TOKENS = 16
PROMPTS = [[int(t) for t in np.random.default_rng(20 + i).integers(3, 500, 12)]
           for i in range(3)]
FORCED = 300
# min_p at temperature 0.8: sampled rows (their streams are not JAX's)
SAMPLED = dict(temperature=0.8, min_p=0.2, logprobs=20)


@pytest.fixture(scope="module")
def weights():
    jc = jconfig.tiny_config()
    params = jllama.init_params(jc, jax.random.PRNGKey(7))
    jc8 = jconfig.ModelConfig(**INT8_CFG, dtype=jnp.bfloat16)
    q, _ = quantize_params(jllama.init_params(jc8, jax.random.PRNGKey(3)))
    return {"f32": (jc, tconfig.tiny_config(), params, False),
            "int8-fused": (jc8, tconfig.ModelConfig(**INT8_CFG), q, True)}


def _torch_engine(w, depth=2, **over):
    _, tc, params, int8 = w
    quant = dict(quantization="int8", use_megakernel=True) if int8 else {}
    return TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                       pipeline_depth=depth, **quant, **{**ARGS, **over}),
                       params=params_from_jax(jax.tree.map(np.asarray, params), tc, "cpu"))


def _jax_engine(w, **over):
    jc, _, params, int8 = w
    quant = dict(quantization="int8", use_megakernel=True) if int8 else {}
    return JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=2, **quant, **{**ARGS, **over}),
                     params=params)


async def _one(engine, api, prompt, sampling, max_tokens=MAX_TOKENS):
    p = api.proto
    req = p.PreprocessedRequest(token_ids=list(prompt), request_id="r",
                                sampling=p.SamplingOptions(**sampling),
                                stop=p.StopConditions(max_tokens=max_tokens))
    toks, logprobs, reason = [], [], None
    async for out in engine.generate(req, api.Context()):
        assert out.error is None, out.error
        toks += out.token_ids
        if out.logprobs is not None:
            assert len(out.logprobs) == len(out.token_ids)
            logprobs += [[(e.token_id, e.logprob) for e in entry] for entry in out.logprobs]
        reason = out.finish_reason
    return dict(tokens=toks, logprobs=logprobs, reason=reason.value)


async def _serve(engine, api, rows):
    try:
        return await asyncio.gather(*(_one(engine, api, PROMPTS[i], s) for _, i, s in rows))
    finally:
        await engine.stop()


def _rows(alone):
    """The mixed batch: (name, prompt index, sampling). The ban row bans
    the first four tokens its prompt's plain stream takes. The penalties
    favour seen tokens (repetition < 1, presence and frequency < 0): the
    models' greedy streams seldom repeat a token in 16, so penalties
    against repeats would seldom move them."""
    greedy = dict(temperature=0.0)
    return [
        ("plain", 0, greedy),
        ("repetition_penalty", 1, dict(greedy, repetition_penalty=0.5, logprobs=5)),
        ("presence_penalty", 1, dict(greedy, presence_penalty=-1.5)),
        ("frequency_penalty", 2, dict(greedy, frequency_penalty=-1.0, logprobs=20)),
        ("logit_bias", 0, dict(greedy, logit_bias={t: -100 for t in alone[0][:4]}, logprobs=3)),
        ("forced", 2, dict(greedy, logit_bias={FORCED: 100.0, 7: 2.0}, logprobs=0)),
        ("min_p", 1, dict(greedy, min_p=0.3)),
        ("logprobs", 2, dict(greedy, logprobs=5)),
        ("plain", 1, greedy),
        ("plain", 2, greedy),
    ] + [("min_p sampled", i, SAMPLED) for i in range(3)]


@pytest.fixture(scope="module")
def served(weights):
    """For each config: the plain streams of each prompt served alone by
    the port, the mixed batch through JaxEngine and through TorchEngine."""
    async def run(w):
        engine = _torch_engine(w)
        try:
            alone = [(await _one(engine, TORCH, p, dict(temperature=0.0)))["tokens"]
                     for p in PROMPTS]
        finally:
            await engine.stop()
        rows = _rows(alone)
        je = _jax_engine(w)
        want = await _serve(je, JAX, rows)
        assert je.runner.use_megakernel == w[3]  # int8: JAX's fused layer too
        got = await _serve(_torch_engine(w), TORCH, rows)
        return dict(alone=alone, rows=rows, want=want, got=got)

    return {name: asyncio.run(run(w)) for name, w in weights.items()}


def _close_logprobs(got, want, tol):
    """Each token's entries: the sampled token's logprob within tol; the top
    N's values rank by rank within tol, an id in both lists within tol of
    itself, and every id of one list whose value lies more than 2·tol above
    the other list's last value in the other list too."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) and g[0][0] == w[0][0]
        assert abs(g[0][1] - w[0][1]) <= tol, (g[0], w[0])
        if len(g) == 1:
            continue
        np.testing.assert_allclose([v for _, v in g[1:]], [v for _, v in w[1:]], rtol=0,
                                   atol=tol)
        gd, wd = dict(g[1:]), dict(w[1:])
        assert all(abs(gd[t] - wd[t]) <= tol for t in gd.keys() & wd.keys())
        for a, b in ((gd, wd), (wd, gd)):
            floor = min(b.values()) + 2 * tol
            assert all(t in b for t, v in a.items() if v > floor), (g, w)


def _parting(got, want, tol):
    """Where the port's stream first differs from JAX's (MAX_TOKENS when
    nowhere). A stream may part only at a near-tie: JAX's logprobs of the
    two tokens within ``tol`` of each other (the int8 config's fused layer
    and JAX's interpret-mode kernel round differently, and its logits are
    bf16 products); a config's batch may part so once
    (``test_processors_act_and_plain_rows_stream_as_alone``)."""
    g, w = got["tokens"], want["tokens"]
    k = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), len(w))
    if k < len(w):
        assert want["logprobs"], f"a stream without logprobs parted from JAX's at token {k}"
        top = dict(want["logprobs"][k][1:])
        assert g[k] in top and top[w[k]] - top[g[k]] <= tol, (k, g[k], w[k], top)
    return k


FIELDS = ["repetition_penalty", "presence_penalty", "frequency_penalty", "logit_bias", "min_p",
          "logprobs", "forced"]


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("config", ["f32", "int8-fused"])
def test_request_setting_a_processor_or_logprobs_is_served_as_jax(served, config, field):
    """The row that sets ``field`` streams JAX's tokens, finishes as JAX's,
    and carries JAX's logprobs (entry count: 1 + min(logprobs, 20) a
    token, the first token's included)."""
    s = served[config]
    i = next(k for k, (name, _, _) in enumerate(s["rows"]) if name == field)
    got, want, sampling = s["got"][i], s["want"][i], s["rows"][i][2]
    tol = LOGPROB_TOL[config]
    assert len(got["tokens"]) == len(want["tokens"]) == MAX_TOKENS
    assert got["reason"] == want["reason"] == "length"
    n = sampling.get("logprobs")
    part = _parting(got, want, tol)
    if n is None:
        assert part == MAX_TOKENS
        assert got["logprobs"] == want["logprobs"] == []
    else:
        assert all(len(e) == 1 + min(n, 20) for e in got["logprobs"])
        _close_logprobs(got["logprobs"][:part], want["logprobs"][:part], tol)


@pytest.mark.parametrize("config", ["f32", "int8-fused"])
def test_processors_act_and_plain_rows_stream_as_alone(served, config):
    s = served[config]
    parted = [name for (name, _, sp), g, w in zip(s["rows"], s["got"], s["want"])
              if sp["temperature"] == 0 and g["tokens"] != w["tokens"]]
    assert len(parted) <= 1, parted
    by = {}
    for (name, i, _), out in zip(s["rows"], s["got"]):
        by.setdefault(name, []).append((i, out["tokens"]))
    # each plain row streams what its prompt streams alone; so does the
    # greedy min_p row
    for i, toks in by["plain"] + by["min_p"]:
        assert toks == s["alone"][i]
    # a banned token never appears; a forced row emits only its token
    banned = set(s["alone"][0][:4])
    assert not banned & set(by["logit_bias"][0][1])
    assert set(by["forced"][0][1]) == {FORCED}
    # the penalties move the streams they are set on (else the rows above
    # would hold nothing)
    moved = [name for name in ("repetition_penalty", "presence_penalty", "frequency_penalty")
             if by[name][0][1] != s["alone"][by[name][0][0]]]
    assert len(moved) >= 2, moved
    # the forced token's logprob is ~0, and its top-1 is itself
    forced = s["got"][[r[0] for r in s["rows"]].index("forced")]
    assert all(e[0] == (FORCED, pytest.approx(0.0, abs=1e-5)) for e in forced["logprobs"])


@pytest.mark.parametrize("config", ["f32", "int8-fused"])
def test_min_p_sampled_tokens_lie_in_jax_filter_set(served, config):
    """At temperature 0.8 with min_p 0.2, JAX's filter keeps the top-64
    candidates whose probability is at least min_p x the best's
    (dynamo_tpu/ops/sampling.py:91-96), that is whose logprob lies within
    0.8·ln(1/0.2) of the best's. Every token the port samples does, by its
    own logprobs and, at the first token (the same logits), by JAX's."""
    s = served[config]
    margin = SAMPLED["temperature"] * math.log(1 / SAMPLED["min_p"])
    cut = 0
    for (name, _, _), g, j in zip(s["rows"], s["got"], s["want"]):
        if name != "min_p sampled":
            continue
        for entry in g["logprobs"]:
            (tok, lp), best = entry[0], entry[1][1]
            assert best - lp <= margin + 1e-5, (tok, lp, best)
            cut += sum(best - v > margin for _, v in entry[1:])
        jbest = j["logprobs"][0][1][1]
        jlp = dict(j["logprobs"][0][1:])
        tok = g["tokens"][0]
        assert tok in jlp and jbest - jlp[tok] <= margin + LOGPROB_TOL[config]
    assert cut > 0, "the filter dropped no candidate: the check holds nothing"


async def test_preempted_penalised_stream_stays_jax(weights):
    """A pool of 8 blocks of 4: decode growth preempts a penalised sequence,
    which is re-admitted with its generated tokens restored to the counts
    (and the prompt mask of its whole history at the re-prefill); its
    stream stays JAX's, with the same preemptions."""
    over = dict(max_num_seqs=2, num_kv_blocks=8, max_model_len=64)
    rows = [("a", 0, dict(temperature=0.0, frequency_penalty=0.7, repetition_penalty=1.3,
                          logprobs=2)),
            ("b", 1, dict(temperature=0.0, presence_penalty=0.9))]
    prompts = [list(range(10, 18)), list(range(20, 28))]

    async def run(engine, api):
        try:
            outs = await asyncio.gather(*(_one(engine, api, p, s, max_tokens=n)
                                          for p, (_, _, s), n in zip(prompts, rows, (14, 18))))
            return outs, engine.preemptions
        finally:
            await engine.stop()

    want, jpre = await run(_jax_engine(weights["f32"], **over), JAX)
    got, pre = await run(_torch_engine(weights["f32"], **over), TORCH)
    assert pre > 0 and pre == jpre, "scenario no longer preempts"
    assert [o["tokens"] for o in got] == [o["tokens"] for o in want]
    _close_logprobs(got[0]["logprobs"], want[0]["logprobs"], LOGPROB_TOL["f32"])
