"""The port's llm layer (dynamo_tpu_torch/llm/) against the JAX package's,
module by module — the counterpart of tests/test_llm_layer.py, with each
result compared with JAX's rather than restated: request parsing and the
OpenAIError of invalid bodies; ``OpenAIPreprocessor.preprocess`` →
``PreprocessedRequest.to_dict()`` (chat, completion, pre-tokenised input,
content parts with an image part, annotations, the context-overflow error
and the max_tokens clamp); ``Backend`` over one scripted token stream fed
to both (stop strings straddling deltas, errors, streams that end without a
finish, logprob strings); the model card and its name sets; the
environment knobs the port reads. Exact equality throughout."""

import dataclasses
import enum
import types

import pytest

from dynamo_tpu import config as jconfig
from dynamo_tpu.llm import backend as jbackend
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm import preprocessor as jpre
from dynamo_tpu.llm import tokenizer as jtok
from dynamo_tpu.llm.chat_template import ChatTemplate as JChatTemplate
from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.llm.protocols import openai as jopenai
from dynamo_tpu.parsers.incremental import DIALECTS
from dynamo_tpu.parsers.reasoning import KNOWN_MARKERS
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu.runtime import pipeline as jpipeline
from dynamo_tpu_torch import config as tconfig
from dynamo_tpu_torch.llm import backend as tbackend
from dynamo_tpu_torch.llm import model_card as tcard
from dynamo_tpu_torch.llm import preprocessor as tpre
from dynamo_tpu_torch.llm import tokenizer as ttok
from dynamo_tpu_torch.llm.chat_template import ChatTemplate as TChatTemplate
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.llm.protocols import openai as topenai
from dynamo_tpu_torch.parsers import incremental as tincremental
from dynamo_tpu_torch.parsers import reasoning as treasoning
from dynamo_tpu_torch.runtime import context as tcontext
from dynamo_tpu_torch.runtime import pipeline as tpipeline


def plain(obj):
    """Dataclasses as dicts and enums as their values, for comparing the two
    packages' objects."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


def _error(fn, body):
    try:
        return ("ok", plain(fn(body)))
    except Exception as exc:  # the same error, type by name, from both
        kind = type(exc).__name__
        if kind == "OpenAIError":
            return (kind, str(exc), exc.status, exc.err_type, exc.kind, exc.to_body())
        return (kind, str(exc))


MSG = [{"role": "user", "content": "x"}]
CHAT_BODIES = [
    {"model": "m", "messages": [{"role": "user", "content": "hi"}], "temperature": 0.5,
     "max_tokens": 10, "stop": ["\n"], "stream": True},
    {"model": "m", "messages": MSG, "repetition_penalty": 1.2, "min_p": 0.05,
     "logit_bias": {"42": -100, "7": 1.5}},
    {"model": "m", "messages": MSG, "nvext": {"annotations": ["formatted_prompt"],
                                              "ignore_eos": True, "lora_name": "a"}},
    {"model": "m", "messages": MSG, "logprobs": True, "top_logprobs": 3, "seed": 4,
     "stream_options": {"include_usage": True}, "max_completion_tokens": 9, "top_k": 5,
     "tools": [{"type": "function"}], "tool_choice": "auto",
     "response_format": {"type": "json_object"}, "stop": "END", "min_tokens": 2,
     "stop_token_ids": [5]},
    # the invalid cases of tests/test_llm_layer.py, then more
    {},
    {"model": "m"},
    {"model": "m", "messages": MSG, "logit_bias": {"x": 1}},
    {"model": "m", "messages": MSG, "min_p": 2},
    {"model": "m", "messages": []},
    {"model": "m", "messages": [{"role": "robot", "content": "x"}]},
    {"model": "m", "messages": MSG, "temperature": 9},
    {"model": "m", "messages": MSG, "n": 0},
    {"model": "m", "messages": MSG, "max_tokens": 0},
    {"model": "m", "messages": [{"role": "user", "content": 5}]},
    {"model": "m", "messages": MSG, "top_logprobs": 21, "logprobs": True},
    {"model": "m", "messages": MSG, "stop": ["a", "b", "c", "d", "e"]},
    {"model": "m", "messages": MSG, "stop": 3},
    {"model": "m", "messages": MSG, "nvext": []},
    {"model": "m", "messages": MSG, "top_k": -2},
    {"model": "m", "messages": MSG, "tools": {}},
    {"model": "m", "messages": MSG, "response_format": {"x": 1}},
    {"model": "m", "messages": MSG, "logit_bias": {str(i): 1 for i in range(301)}},
    [],
]
COMPLETION_BODIES = [
    {"model": "m", "prompt": "hi", "logprobs": 2, "echo": True},
    {"model": "m", "prompt": [1, 2, 3]},
    {"model": "m", "prompt": ["a", "b"]},
    {"model": "m"},
    {"model": "m", "prompt": {"x": 1}},
    {"model": "m", "prompt": "x", "logprobs": 30},
    {"model": "", "prompt": "x"},
]


@pytest.mark.parametrize("body", CHAT_BODIES, ids=range(len(CHAT_BODIES)))
def test_parse_chat_request_matches_jax(body):
    assert _error(topenai.parse_chat_request, body) == _error(jopenai.parse_chat_request, body)


@pytest.mark.parametrize("body", COMPLETION_BODIES, ids=range(len(COMPLETION_BODIES)))
def test_parse_completion_request_matches_jax(body):
    assert _error(topenai.parse_completion_request, body) == _error(
        jopenai.parse_completion_request, body)


def _preprocessors(context_length=512):
    j = jpre.OpenAIPreprocessor(jcard.ModelDeploymentCard(name="m", context_length=context_length),
                                jtok.tiny_tokenizer())
    t = tpre.OpenAIPreprocessor(tcard.ModelDeploymentCard(name="m", context_length=context_length),
                                ttok.tiny_tokenizer())
    return j, t


IMAGE_PARTS = [{"role": "system", "content": "be brief"},
               {"role": "user", "content": [
                   {"type": "text", "text": "look at"},
                   {"type": "image_url", "image_url": {"url": "http://x/a.png"}},
                   {"type": "text", "text": "and {this}"},
                   {"type": "image_url", "image_url": {}}]}]
PREPROCESS_BODIES = {
    "chat": {"model": "m", "messages": [{"role": "user", "content": "hello world"}]},
    "chat sampling": {"model": "m", "messages": [{"role": "system", "content": None},
                                                 {"role": "user", "content": "a\nb {x}"}],
                      "temperature": 0.3, "top_p": 0.9, "max_tokens": 7, "stop": ["wor"]},
    "completion": {"model": "m", "prompt": "the quick brown fox", "max_tokens": 5},
    "completion list": {"model": "m", "prompt": ["the quick"]},
    "completion batched": {"model": "m", "prompt": ["a", "b"]},
    "pretokenized": {"model": "m", "prompt": [1, 2, 3]},
    "content parts": {"model": "m", "messages": IMAGE_PARTS},
    "annotations": {"model": "m", "messages": [{"role": "user", "content": "hi"}],
                    "nvext": {"annotations": ["formatted_prompt", "token_ids"]}},
    "completion annotation": {"model": "m", "prompt": "x",
                              "nvext": {"annotations": ["formatted_prompt"]}},
    "overflow": {"model": "m", "prompt": "word " * 2000},
    "clamp": {"model": "m", "prompt": "hi", "max_tokens": 100000},
}


@pytest.mark.parametrize("case", sorted(PREPROCESS_BODIES))
def test_preprocess_matches_jax(case):
    jp, tp = _preprocessors()
    body = PREPROCESS_BODIES[case]

    def run(pre):
        out = pre.preprocess(body)
        return out.to_dict()

    want, got = _error(run, jp), _error(run, tp)
    assert got == want
    if case == "overflow":
        assert got[0] == "OpenAIError" and "context length" in got[1]
    elif case == "clamp":
        assert got[1]["stop"]["max_tokens"] == 512 - len(got[1]["token_ids"])
    elif case == "content parts":
        assert got[1]["extra"]["_mm_media"] == ["http://x/a.png", ""]


def test_content_parts_route_joins_with_a_space_and_render_with_nothing():
    """The preprocessor takes content parts through extract_image_parts
    (parts joined with " ", an image part written <image>); ChatTemplate's
    own flattening joins text parts with "". Both packages do both."""
    parts = [{"role": "user", "content": [{"type": "text", "text": "a"},
                                          {"type": "text", "text": "b"}]}]
    body = {"model": "m", "messages": parts, "nvext": {"annotations": ["formatted_prompt"]}}
    jp, tp = _preprocessors()
    via_pre = tp.preprocess(body).extra["formatted_prompt"]
    assert via_pre == jp.preprocess(body).extra["formatted_prompt"]
    via_render = TChatTemplate().render(parts, add_generation_prompt=True)
    assert via_render == JChatTemplate().render(parts, add_generation_prompt=True)
    assert "a b" in via_pre and "ab" in via_render and via_pre != via_render


async def _preprocessor_stream(pre_op, api, body):
    async def engine(request, context):
        yield api.BackendOutput(token_ids=[5], finish_reason=api.FinishReason.EOS)

    pipe = api.build_pipeline([pre_op], engine)
    ctx = api.Context("req-1")
    return [plain(x) for x in [o async for o in pipe.generate(body, ctx)]]


def _api(proto, context, pipeline):
    return types.SimpleNamespace(
        BackendOutput=proto.BackendOutput, FinishReason=proto.FinishReason,
        TokenLogprob=proto.TokenLogprob, PreprocessedRequest=proto.PreprocessedRequest,
        StopConditions=proto.StopConditions, Context=context.Context,
        build_pipeline=pipeline.build_pipeline)


JAX_API = _api(jproto, jcontext, jpipeline)
TORCH_API = _api(tproto, tcontext, tpipeline)


async def test_preprocessor_operator_annotations_match_jax():
    jp, tp = _preprocessors()
    body = PREPROCESS_BODIES["annotations"]
    want = await _preprocessor_stream(jp, JAX_API, body)
    got = await _preprocessor_stream(tp, TORCH_API, body)
    assert got == want
    assert got[0] == {"annotation": "_prompt_tokens", "value": len(got[2]["value"])}
    assert [x.get("annotation") for x in got[:3]] == ["_prompt_tokens", "formatted_prompt",
                                                      "token_ids"]


def _script(tok, text, chunk, finish, tail=()):
    """Token-id deltas of ``text`` in chunks, the last with ``finish``
    (None: the stream ends without one), then ``tail`` items as they are."""
    ids = tok.encode(text)
    out = []
    for i in range(0, len(ids), chunk):
        last = i + chunk >= len(ids)
        out.append({"token_ids": ids[i:i + chunk], "finish_reason": finish if last else None})
    return out + list(tail)


BACKEND_CASES = {
    "detokenize": (dict(text="streaming tokens one at a time", chunk=1, finish="eos"), {}),
    "multibyte": (dict(text="café 世界 😀 ok", chunk=1, finish="length"), {}),
    "stop": (dict(text="hello world STOP more text", chunk=2, finish="eos"),
             {"stop": ["STOP"]}),
    "stop across deltas": (dict(text="the quick brown fox jumps", chunk=1, finish="eos"),
                           {"stop": ["brown fox"]}),
    "stop earliest of two": (dict(text="the quick brown fox jumps", chunk=3, finish="eos"),
                             {"stop": ["jumps", "k b"]}),
    "stop never reached": (dict(text="the quick brown fox", chunk=2, finish="length"),
                           {"stop": ["zebra crossing"]}),
    "error": (dict(text="hello world", chunk=1, finish=None,
                   tail=[{"token_ids": [], "error": "engine exploded", "error_kind": "oom"}]),
              {}),
    "no finish": (dict(text="hello wor", chunk=1, finish=None), {}),
    "no finish, stop held back": (dict(text="hello wor", chunk=1, finish=None),
                                  {"stop": ["world!"]}),
    "cancelled": (dict(text="hello world", chunk=1, finish=None), {"cancel": True}),
    "logprobs": (dict(text="hello world", chunk=2, finish="eos"), {"logprobs": True}),
}


async def _backend_stream(api, backend, tok, case):
    script_kw, opts = BACKEND_CASES[case]
    items = _script(tok, **script_kw)

    async def engine(request, context):
        for item in items:
            out = api.BackendOutput.from_dict(dict(item))
            if opts.get("logprobs") and out.token_ids:
                out.logprobs = [[api.TokenLogprob(token_id=t, logprob=-0.5),
                                 api.TokenLogprob(token_id=(t * 7) % 400, logprob=-1.0)]
                                for t in out.token_ids]
            yield out

    pre = api.PreprocessedRequest(token_ids=[1], stop=api.StopConditions(
        stop=list(opts.get("stop", []))))
    ctx = api.Context("req")
    if opts.get("cancel"):
        ctx.stop_generating()
    pipe = api.build_pipeline([backend], engine)
    outs = [plain(o) async for o in pipe.generate(pre, ctx)]
    return outs, ctx.stopped


@pytest.mark.parametrize("case", sorted(BACKEND_CASES))
async def test_backend_matches_jax_on_a_scripted_stream(case):
    jt, tt = jtok.tiny_tokenizer(), ttok.tiny_tokenizer()
    want = await _backend_stream(JAX_API, jbackend.Backend(jt), jt, case)
    got = await _backend_stream(TORCH_API, tbackend.Backend(tt), tt, case)
    assert got == want
    outs, stopped = got
    text = "".join(o["text"] for o in outs)
    if case.startswith("stop") and case != "stop never reached":
        assert outs[-1]["finish_reason"] == "stop" and stopped
    if case == "stop across deltas":
        assert text == "the quick "
    if case == "logprobs":
        assert all(lp["decoded"] == tt.decode([lp["token_id"]])
                   for o in outs for step in o["logprobs"] or [] for lp in step)
    if case in ("no finish", "error"):
        assert outs[-1]["finish_reason"] == "error"
    if case == "cancelled":
        assert outs[-1]["finish_reason"] == "cancelled"


def test_model_card_name_sets_equal_jax(monkeypatch):
    """The card validates against the port's parsers (their name sets equal
    JAX's), refuses an unknown name with JAX's message, and takes a name
    the parsers gain."""
    assert tincremental.DIALECTS == DIALECTS
    assert set(treasoning.KNOWN_MARKERS) == set(KNOWN_MARKERS)
    for kw in ({"reasoning_style": "nope"}, {"tool_call_dialect": "yaml"}):
        with pytest.raises(ValueError) as got:
            tcard.ModelDeploymentCard(name="m", **kw)
        with pytest.raises(ValueError) as want:
            jcard.ModelDeploymentCard(name="m", **kw)
        assert str(got.value) == str(want.value)
    monkeypatch.setitem(treasoning.KNOWN_MARKERS, "extra", (("<x>",), ("</x>",)))
    monkeypatch.setattr(tincremental, "DIALECTS", DIALECTS + ("extra",))
    card = tcard.ModelDeploymentCard(name="m", reasoning_style="extra",
                                     tool_call_dialect="extra")
    assert (card.reasoning_style, card.tool_call_dialect) == ("extra", "extra")


@pytest.mark.parametrize("kw", [
    {}, {"reasoning_style": "granite", "tool_call_dialect": "hermes"},
    {"reasoning_style": "nope"}, {"tool_call_dialect": "yaml"},
    {"context_length": 99, "kv_block_size": 8, "eos_token_ids": [3], "model_type": "completion"},
])
def test_model_card_matches_jax(kw, monkeypatch):
    # the port's card carries JAX's default migration budget: its knob
    # comes with migration (ROADMAP A4c)
    monkeypatch.delenv("DYN_TPU_MIGRATION_LIMIT", raising=False)

    def make(mod):
        card = mod.ModelDeploymentCard(name="My Model/v1", **kw)
        return card.to_dict(), card.slug, plain(mod.ModelDeploymentCard.from_dict(card.to_dict()))

    assert _error(lambda _: make(tcard), None) == _error(lambda _: make(jcard), None)


def test_model_card_from_model_dir_matches_jax(tmp_path):
    (tmp_path / "config.json").write_text('{"max_position_embeddings": 777, "eos_token_id": 4}')
    want = jcard.ModelDeploymentCard.from_model_dir("x", str(tmp_path), kv_block_size=32)
    got = tcard.ModelDeploymentCard.from_model_dir("x", str(tmp_path), kv_block_size=32)
    assert got.to_dict() == want.to_dict()


TORCH_KNOBS = sorted(k for k, v in vars(tconfig).items() if isinstance(v, tconfig.EnvVar))


@pytest.mark.parametrize("knob", TORCH_KNOBS)
def test_config_knobs_equal_jax(knob, monkeypatch):
    """Each knob the port reads has JAX's name, default and parsing."""
    mine, theirs = getattr(tconfig, knob), getattr(jconfig, knob)
    assert (mine.name, mine.default) == (theirs.name, theirs.default)
    for raw in (None, "", "7", "-3", "abc", "true", "OFF", "2.5"):
        if raw is None:
            monkeypatch.delenv(mine.name, raising=False)
        else:
            monkeypatch.setenv(mine.name, raw)
        assert mine.get() == theirs.get(), raw

