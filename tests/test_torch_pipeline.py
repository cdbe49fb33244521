"""The slice as a whole: the port's local OpenAI pipeline
(``build_local_pipeline`` → OpenAIPreprocessor → Backend → TorchEngine on
the CPU) against the JAX package's (→ JaxEngine) on the same weights
(``params_from_jax``), each with its own package's ``tiny_tokenizer()``.
Greedy requests served concurrently — completion and chat, a stop string,
logprobs with top logprobs, max_tokens 1, a prompt prefilled in several
chunks, annotations — must yield item for item the same: the annotations,
and each PostprocessedOutput's text, token_ids, finish_reason,
cumulative_tokens and the token ids and decoded strings of its logprobs.
Tolerance: exact (temperature 0), except the logprob values, which are
held within LOGPROB_TOL (the f32 and int8-fused tolerances of
tests/test_torch_engine_procs.py). On the tiny f32 config and on the int8
fused-layer miniature of tests/test_torch_engine_int8.py, the port's fused
layer against JAX's int8 path with its megakernel on, as
tests/test_torch_engine_procs.py builds it: against JAX's unfused int8 XLA
path two of the six streams part at near ties (JAX's two tokens 0.0015 and
0.0077 apart in logprob), where the two sides round differently.

Then ``cli run``: its batch and stdin modes (``run_batch`` / ``run_stdin``)
against JAX's over the two pipelines above — the JSONL records without
``latency_s``, the ``batch done:`` counts, the printed lines — and the card,
engine sizes and tokenizer that each ``build_engine_and_card`` builds;
``python -m dynamo_tpu_torch.cli run --input batch:FILE --model tiny
--device cpu`` in-process, whose JSONL texts equal what the port's pipeline
gives for the same prompts on the same engine; and its refusals, each
naming the ROADMAP item that brings what it refuses (``--input http`` is
served: tests/test_torch_http_service.py)."""

import argparse
import asyncio
import io
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.cli import run as jrun
from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.llm import entrypoint as jentry
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm import tokenizer as jtok
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.quantize import quantize_params
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu_torch.cli import run as trun
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm import entrypoint as tentry
from dynamo_tpu_torch.llm import model_card as tcard
from dynamo_tpu_torch.llm import tokenizer as ttok
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.runtime import context as tcontext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = dict(block_size=4, num_kv_blocks=96, max_num_seqs=4, max_model_len=160,
            prefill_chunk=32, decode_steps=4)
INT8_CFG = dict(name="int8-mini", d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
                vocab_size=512, head_dim=128, rope_theta=10000.0)
INT8_ARGS = dict(ARGS, block_size=16)
LOGPROB_TOL = {"tiny": 2e-4, "int8-fused": 0.05}

LONG = " ".join(["the quick brown fox jumps over the lazy dog"] * 10)  # > 2 chunks


def _requests(stop):
    greedy = dict(model="tiny", temperature=0.0)
    return [
        dict(greedy, prompt="hello world this is a test", max_tokens=12),
        dict(greedy, messages=[{"role": "system", "content": "be brief"},
                               {"role": "user", "content": "paged attention on tpu"}],
             max_tokens=10, nvext={"annotations": ["formatted_prompt", "token_ids"]}),
        dict(greedy, prompt="streaming tokens one at a time", max_tokens=16, stop=[stop]),
        dict(greedy, messages=[{"role": "user", "content": "0123456789 !@#"}], max_tokens=9,
             logprobs=True, top_logprobs=3),
        dict(greedy, prompt="the quick brown fox", max_tokens=1),
        dict(greedy, prompt=LONG, max_tokens=8),
    ]


def _item(item, tok):
    """A yielded item as plain values; a logprob entry as (token id, its
    decoded string, the logprob)."""
    if isinstance(item, dict):
        return item
    lps = None
    if item.logprobs is not None:
        lps = [[(e.token_id, e.decoded, e.logprob) for e in step] for step in item.logprobs]
        assert all(d == tok.decode([t]) for step in lps for t, d, _ in step)
    return dict(text=item.text, token_ids=list(item.token_ids),
                finish_reason=None if item.finish_reason is None else item.finish_reason.value,
                cumulative_tokens=item.cumulative_tokens, logprobs=lps, error=item.error)


async def _serve(pipeline, engine, context, tok, bodies):
    async def one(body):
        return [_item(x, tok) async for x in pipeline.generate(body, context.Context())]

    try:
        return await asyncio.gather(*(one(b) for b in bodies))
    finally:
        await engine.stop()


def _stop_string(outs):
    """A stop string that the stop request's own stream reaches: two
    characters of its text past the first few."""
    text = "".join(o["text"] for o in outs if "text" in o)
    for i in range(3, len(text) - 1):
        if text[i:i + 2].strip():
            return text[i:i + 2]
    raise AssertionError(f"no stop string in {text!r}")


def _jax_params(kind):
    if kind == "tiny":
        jc = jconfig.tiny_config()
        return jc, tconfig.tiny_config(), jllama.init_params(jc, jax.random.PRNGKey(5)), {}, ARGS
    jc = jconfig.ModelConfig(**INT8_CFG, dtype=jnp.bfloat16)
    q, _ = quantize_params(jllama.init_params(jc, jax.random.PRNGKey(3)))
    return jc, tconfig.ModelConfig(**INT8_CFG), q, dict(quantization="int8"), INT8_ARGS


def _card(api, jc, args):
    return api.ModelDeploymentCard(name="tiny", context_length=args["max_model_len"],
                                   kv_block_size=args["block_size"],
                                   eos_token_ids=list(jc.eos_token_ids))


def _jax_pipeline(kind):
    jc, _, params, quant, args = _jax_params(kind)
    # int8: the port's fused layer against JAX's (its megakernel)
    je = JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=1, use_megakernel=bool(quant), **quant,
                                 **args), params=params)
    jt = jtok.tiny_tokenizer()
    return jentry.build_local_pipeline(_card(jcard, jc, args), je, tokenizer=jt), je, jcontext, jt


def _torch_pipeline(kind):
    jc, tc, params, quant, args = _jax_params(kind)
    te = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                     use_megakernel=True if quant else None, **quant, **args),
                     params=params_from_jax(jax.tree.map(np.asarray, params), tc, "cpu"))
    tt = ttok.tiny_tokenizer()
    return tentry.build_local_pipeline(_card(tcard, jc, args), te, tokenizer=tt), te, tcontext, tt


@pytest.mark.parametrize("kind", ["tiny", "int8-fused"])
async def test_pipeline_matches_jax_item_for_item(kind):
    # the stop request's stream without its stop (from the port; the
    # comparison below holds it to JAX's) gives the stop string
    plain = _requests("unused")[2]
    plain.pop("stop")
    stop = _stop_string((await _serve(*_torch_pipeline(kind), [plain]))[0])

    jp, je, jctx, jt = _jax_pipeline(kind)
    tp, te, tctx, tt = _torch_pipeline(kind)
    bodies = _requests(stop)
    want = await _serve(jp, je, jctx, jt, bodies)
    got = await _serve(tp, te, tctx, tt, bodies)
    if kind == "int8-fused":
        assert te.stats()["mk_fused_bursts"] > 0
    tol = LOGPROB_TOL[kind]
    for body, g, w in zip(bodies, got, want):
        assert len(g) == len(w), body
        for gi, wi in zip(g, w):
            if "logprobs" in gi and gi["logprobs"] is not None:
                gl, wl = gi.pop("logprobs"), wi.pop("logprobs")
                assert [[(t, d) for t, d, _ in s] for s in gl] == \
                    [[(t, d) for t, d, _ in s] for s in wl]
                assert np.allclose([v for s in gl for *_, v in s], [v for s in wl for *_, v in s],
                                   atol=tol, rtol=0)
            assert gi == wi, body
    # what the requests were for
    ann = [x for x in got[1] if "annotation" in x]
    assert [a["annotation"] for a in ann] == ["_prompt_tokens", "formatted_prompt", "token_ids"]
    assert ann[0]["value"] == len(ann[2]["value"])
    text = "".join(x["text"] for x in got[2] if "text" in x)
    ids = [t for x in got[2] if "token_ids" in x for t in x["token_ids"]]
    full = tt.decode(ids)
    assert got[2][-1]["finish_reason"] == "stop" and stop in full
    assert text == full[: full.index(stop)]
    assert got[3][-1]["finish_reason"] == "length"
    assert all(len(s) == 4 for x in got[3] if x.get("logprobs") for s in x["logprobs"])
    assert sum(len(x["token_ids"]) for x in got[4] if "token_ids" in x) == 1
    long_ids = ttok.tiny_tokenizer().encode(LONG)
    assert len(long_ids) > 2 * ARGS["prefill_chunk"]
    assert got[5][0] == {"annotation": "_prompt_tokens", "value": len(long_ids)}


def _cli_args(*argv, api=trun):
    parser = argparse.ArgumentParser()
    api.add_run_args(parser)
    return parser.parse_args(list(argv))


# batch input: `text` before `prompt`, an empty `text` falling through to
# `prompt`, blank and whitespace-only lines skipped
BATCH_IN = "\n".join([
    json.dumps({"text": "hello world"}), "",
    json.dumps({"prompt": "the quick brown fox jumps"}),
    json.dumps({"text": "0123456789", "prompt": "not this one"}), "   ",
    json.dumps({"text": "", "prompt": "paged attention"}),
    json.dumps({"prompt": LONG}),
]) + "\n"
# stdin: one prompt a line, empty lines skipped, spaces kept
STDIN_IN = "hello world\n\n  streaming tokens  \nthe quick brown fox\n"


@pytest.mark.parametrize("mode", ["batch", "stdin"])
async def test_cli_modes_match_jax(mode, tmp_path, monkeypatch, capsys):
    src = tmp_path / "in.jsonl"
    src.write_text(BATCH_IN)
    results = []
    for api, make in ((jrun, _jax_pipeline), (trun, _torch_pipeline)):
        pipeline, engine, _, _ = make("tiny")
        out = tmp_path / f"{api.__name__}.jsonl"
        args = _cli_args("--max-tokens", "12", "--out", str(out), api=api)
        capsys.readouterr()
        try:
            if mode == "batch":
                await api.run_batch(pipeline, "tiny", args, str(src))
                lines = [json.loads(x) for x in out.read_text().splitlines()]
                assert all(x.pop("latency_s") > 0 for x in lines)
                done = re.search(r"batch done: (\d+) requests, (\d+) tokens",
                                 capsys.readouterr().err)
                results.append((lines, done.groups()))
            else:
                monkeypatch.setattr(sys, "stdin", io.StringIO(STDIN_IN))
                await api.run_stdin(pipeline, "tiny", args)
                results.append(capsys.readouterr().out)
        finally:
            await engine.stop()
    want, got = results
    assert got == want
    if mode == "batch":
        lines, (n_req, n_tok) = got
        assert [x["prompt"] for x in lines] == ["hello world", "the quick brown fox jumps",
                                                "0123456789", "paged attention", LONG]
        assert (int(n_req), int(n_tok)) == (5, sum(x["tokens"] for x in lines))
        assert all(set(x) == {"prompt", "text", "tokens"} for x in lines)
    else:
        assert len(got.splitlines()) >= 3


@pytest.mark.parametrize("argv", [
    [],
    ["--served-model-name", "My Model/v1", "--block-size", "32", "--max-model-len", "1024",
     "--num-kv-blocks", "64"],
])
async def test_cli_builds_the_card_and_engine_jax_builds(argv):
    je, jc, jt = jrun.build_engine_and_card(_cli_args("--model", "tiny", *argv, api=jrun))
    te, tc, tt = trun.build_engine_and_card(_cli_args("--model", "tiny", "--device", "cpu",
                                                      *argv))
    try:
        assert tc.to_dict() == jc.to_dict()
        sizes = ("block_size", "num_kv_blocks", "max_model_len")
        assert [getattr(te.args, k) for k in sizes] == [getattr(je.args, k) for k in sizes]
        assert te.args.config.name == je.args.config.name
        assert (tt.vocab_size, tt.eos_token_ids, tt.bos_token_id) == \
            (jt.vocab_size, jt.eos_token_ids, jt.bos_token_id)
    finally:
        await je.stop()
        await te.stop()


async def test_cli_batch_texts_equal_the_pipelines(tmp_path):
    prompts = ["hello world", "the quick brown fox jumps", "0123456789", LONG]
    src = tmp_path / "in.jsonl"
    src.write_text("".join(json.dumps({"prompt" if i % 2 else "text": p}) + "\n"
                           for i, p in enumerate(prompts)) + "\n")
    out = tmp_path / "out.jsonl"
    args = _cli_args("--input", f"batch:{src}", "--model", "tiny", "--device", "cpu",
                     "--max-tokens", "12", "--out", str(out))
    await trun.main_run(args)
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["prompt"] for x in lines] == prompts
    assert all(set(x) == {"prompt", "text", "tokens", "latency_s"} for x in lines)

    # the same prompts through the port's pipeline over an engine built as
    # the command builds it (the same random weights from the same seed)
    engine, card, tok = trun.build_engine_and_card(args)
    assert card.kv_block_size == args.block_size == 16 and card.context_length == 2048
    pipeline = tentry.build_local_pipeline(card, engine, tokenizer=tok)
    try:
        want = [await trun._generate_text(pipeline, card.name, p, args) for p in prompts]
    finally:
        await engine.stop()
    assert [(x["text"], x["tokens"]) for x in lines] == [(t, n) for t, n, _ in want]
    assert all(0 < x["tokens"] <= 12 for x in lines)


@pytest.mark.parametrize("argv,item", [
    (["--input", "http", "--model", "mock"], "A4d"),
    (["--input", "text", "--model", "mock"], "A4d"),
    (["--input", "stdin", "--model", "MODEL_DIR"], "A9"),
    (["--input", "stdin", "--model", "mixtral-8x7b"], "A7"),
])
async def test_cli_refusals_name_the_roadmap_item(tmp_path, argv, item):
    argv = [str(tmp_path) if a == "MODEL_DIR" else a for a in argv]
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        await trun.main_run(_cli_args(*argv, "--device", "cpu"))


def test_cli_module_refuses_http_and_needs_the_card_by_default(tmp_path):
    """On its default device `run` needs the card: without one, `--input
    http` exits naming cuda before it binds a port, and batch mode raises
    (serving over HTTP on the CPU: tests/test_torch_http_service.py)."""
    if torch.cuda.is_available():
        return
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "--input", "http",
                           "--model", "tiny", "--http-port", "0"], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 1 and "cuda" in proc.stderr
    assert "http server on" not in proc.stdout
    src = tmp_path / "in.jsonl"
    src.write_text('{"prompt": "hi"}\n')
    with pytest.raises(RuntimeError, match="cuda"):
        asyncio.run(trun.main_run(_cli_args("--input", f"batch:{src}", "--model", "tiny")))
