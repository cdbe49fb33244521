"""The port's parsers (dynamo_tpu_torch/parsers) against the JAX package's
(dynamo_tpu/parsers) on the same texts: ``split_reasoning`` for every
reasoning style, ``detect_and_parse_tool_calls`` for every tool-call
dialect and auto-detection, and the streaming ``ReasoningParser`` and
``ToolCallJail`` fed the same texts in seeded random chunkings — outputs
and event sequences equal (tool-call ids masked where the parsers draw
them at random; the jails take the same deterministic id factory), and
the parser planes' snapshots, flight rings and rendered metric families
equal. Then the typed degradation ladder's buffer cap, the
``parser.jail.feed`` fault seam under the same plan on both sides, and
the model card's names (tests/test_torch_llm_layer.py holds the card)."""

import random
import re

import pytest

from dynamo_tpu import parsers as jparsers
from dynamo_tpu.parsers import observe as jobserve
from dynamo_tpu.parsers.incremental import DIALECTS
from dynamo_tpu.parsers.reasoning import KNOWN_MARKERS
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime.fault_names import PARSER_JAIL_FEED
from dynamo_tpu_torch import parsers as tparsers
from dynamo_tpu_torch.parsers import observe as tobserve
from dynamo_tpu_torch.runtime import faults as tfaults

SIDES = ((jparsers, jobserve, jfaults), (tparsers, tobserve, tfaults))


def reasoning_texts(style):
    opens, closes = KNOWN_MARKERS[style]
    out = ["no markers at all", "", "<think>not this style's</think>" if style != "think"
           else "<reasoning>not this style's</reasoning>"]
    for o in opens:
        for c in closes:
            out += [f"{o}plan A{c}answer", f"pre {o} step 1\nstep 2 {c} post",
                    f"{o}a{c}{o}b{c}c", f"{o}{c}", f"  {o}x{c}"]
        out += [f"{o}unterminated thought", f"lead {o}"]
    out += [f"only the close{c} then content" for c in closes]
    return out


DSML_TEXT = (
    'before <｜DSML｜function_calls>'
    '<｜DSML｜invoke name="search">'
    '<｜DSML｜parameter name="query" string="true">cats</｜DSML｜parameter>'
    '<｜DSML｜parameter name="limit" string="false">5</｜DSML｜parameter>'
    '</｜DSML｜invoke>'
    '<｜DSML｜invoke name="fetch">'
    '<｜DSML｜parameter name="url" string="true">http://x</｜DSML｜parameter>'
    '</｜DSML｜invoke>'
    '</｜DSML｜function_calls> after'
)

# Well-formed calls in each dialect, then malformed ones (truncations, bad
# nesting, drift, lossy arguments) that take the degradation ladder.
TOOL_TEXTS = [
    'Check: <tool_call>\n{"name": "search", "arguments": {"q": "tpu", "k": [1, 2]}}\n'
    '</tool_call> done',
    '<tool_call>{"name": "a", "arguments": {}}</tool_call> and '
    '<tool_call>{"name": "b", "arguments": {"x": {"y": "z,w"}}}</tool_call>',
    '<tool_call>{"name": "s", "arguments": "not json {"}</tool_call>',
    '[TOOL_CALLS][{"name": "add", "arguments": {"a": 1, "b": 2}}, '
    '{"name": "mul", "arguments": {"a": 3}}]',
    '<tool_call><function=lookup><parameter=key>abc</parameter>'
    '<parameter=count>3</parameter></function></tool_call> trailing',
    '<|channel|>analysis<|message|>thinking about weather<|end|>'
    '<|start|>assistant<|channel|>commentary to=functions.w '
    '<|constrain|>json<|message|>{"city":"SF"}<|call|>'
    '<|channel|>final<|message|>Here you go!<|end|>',
    '<|channel|>commentary to=functions.n <|message|>12<|call|>'
    '<|channel|>final<|message|>ok<|end|>',
    DSML_TEXT,
    '{"name": "get_weather", "arguments": {"city": "Paris"}}',
    '[{"name": "a", "arguments": {}}, {"name": "b", "parameters": {"x": 1}}]',
    '[get_time(tz="UTC"), ping()]',
    'plain content with no call in it',
    '<tool_call>{"name": "f", "arguments": {"a": [1, 2',
    '<tool_call>{"name": "f", "arguments": {"a": 1]]}',
    '<tool_call>garbage not json</tool_call>',
    '[TOOL_CALLS]{"name": "f", "argu',
    '[TOOL_CALLS] definitely prose',
    '<｜DSML｜function_calls><｜DSML｜invoke name="x"><｜DSML｜parameter name="k" '
    'string="true">v',
    '<｜DSML｜oops>not the block',
    '<|channel|>commentary to=functions.f <|message|>{"a": ',
    '<|channel|>weird<|message|>body<|end|>',
    '[f(a=1, b',
    '[f(1, 2)]',
    '{"name": "f", "arguments": {"x": ',
    '{"no_name_here": 1}',
    '<tool_call><function=f><parameter=k>v',
    '<tool_call><wrong=f>',
]


def chunkings(text, key, n=4):
    """``n`` seeded random splittings of ``text`` (the first: one char a
    delta)."""
    out = [list(text)]
    rng = random.Random(key)
    for _ in range(n - 1):
        k = rng.randint(1, max(1, min(12, len(text) - 1)))
        cuts = sorted(rng.sample(range(1, len(text)), k)) if len(text) > 1 else []
        out.append([text[a:b] for a, b in zip([0] + cuts, cuts + [len(text)])])
    return out


def masked_calls(calls):
    out = []
    for c in calls:
        d = c.to_openai()
        d["id"] = re.sub(r"[0-9a-f]{24}$", "X", d["id"])
        out.append(d)
    return out


def flight(plane):
    return [{k: v for k, v in e.items() if k not in ("seq", "t_mono")}
            for e in plane.flight.snapshot()]


def plane_state(plane):
    return plane.snapshot(), flight(plane), plane.metrics.render()


@pytest.fixture
def fresh_planes(monkeypatch):
    """A new process-global parser plane on each side for the test."""
    for _, observe, _ in SIDES:
        monkeypatch.setattr(observe, "_PLANE", None)


@pytest.mark.parametrize("style", sorted(KNOWN_MARKERS))
def test_split_reasoning_and_streaming_parser_match_jax(style):
    assert set(tparsers.reasoning.KNOWN_MARKERS) == set(KNOWN_MARKERS)
    for i, text in enumerate(reasoning_texts(style)):
        want = jparsers.split_reasoning(text, style=style)
        assert tparsers.split_reasoning(text, style=style) == want, text
        for chunks in chunkings(text, f"{style}:{i}"):
            got = []
            for api, _, _ in SIDES:
                parser = api.ReasoningParser(style=style)
                got.append([parser.feed(c) for c in chunks] + [parser.flush()])
            assert got[1] == got[0], (text, chunks)


@pytest.mark.parametrize("dialect", [None, *DIALECTS])
def test_detect_and_parse_tool_calls_matches_jax(dialect, fresh_planes):
    assert tparsers.DIALECTS == DIALECTS
    for text in TOOL_TEXTS:
        res = []
        for api, _, _ in SIDES:
            try:
                calls, rest = api.detect_and_parse_tool_calls(text, dialect=dialect)
                res.append((masked_calls(calls), rest))
            except Exception as exc:  # the same failure on both sides
                res.append((type(exc).__name__, str(exc)))
        assert res[1] == res[0], text
    # the lossy-argument counter the one-shot parser feeds
    assert plane_state(tobserve.parser_plane()) == plane_state(jobserve.parser_plane())


def jail_events(api, dialect, chunks, plane, **kw):
    ids = iter(f"call-{i}" for i in range(1000))
    jail = api.ToolCallJail(dialect, call_id_factory=lambda: next(ids), plane=plane, **kw)
    events = []
    for c in chunks:
        events += jail.feed(c)
    events += jail.finish()
    return ([repr(e) for e in events],
            (jail.calls_started, jail.calls_done, sorted(jail.open_calls), jail.degrade_reasons,
             jail.args_chars, jail.outcome()))


@pytest.mark.parametrize("dialect", [None, *DIALECTS])
def test_tool_call_jail_matches_jax_in_random_chunkings(dialect):
    planes = [obs.ParserPlane() for _, obs, _ in SIDES]
    activity = [dict(faults._ACTIVITY) for _, _, faults in SIDES]
    n = 0
    for i, text in enumerate(TOOL_TEXTS):
        for chunks in chunkings(text, f"{dialect}:{i}"):
            got = [jail_events(api, dialect, chunks, plane)
                   for (api, _, _), plane in zip(SIDES, planes)]
            assert got[1] == got[0], (text, chunks)
            n += got[0][1][0]
    assert n > 0  # some text of every dialect starts a call
    assert plane_state(planes[1]) == plane_state(planes[0])
    # the recovery-activity counters the planes bump on each degrade
    moved = [{k: v - before.get(k, 0) for k, v in faults._ACTIVITY.items()
              if v != before.get(k, 0)} for (_, _, faults), before in zip(SIDES, activity)]
    assert moved[1] == moved[0]


@pytest.mark.parametrize("dialect,opener", [
    (None, '<tool_call>{"name": "'),
    ("dsml", '<｜DSML｜function_calls><｜DSML｜invoke name="x"><｜DSML｜parameter name="k" '
             'string="true">'),
    ("harmony", "<|channel|>commentary"),
])
def test_jail_buffer_cap_matches_jax(dialect, opener):
    planes = [obs.ParserPlane() for _, obs, _ in SIDES]
    chunks = [opener] + ["x" * 64] * 50
    got = [jail_events(api, dialect, chunks, plane, buffer_cap=256)
           for (api, _, _), plane in zip(SIDES, planes)]
    assert got[1] == got[0]
    assert "buffer_cap" in got[0][1][3]
    assert plane_state(planes[1]) == plane_state(planes[0])


@pytest.mark.parametrize("at", [1, 2, 3])
def test_injected_parser_death_matches_jax(at):
    """The same fault plan on both sides: the feed it hits raises the
    typed ToolCallParseError with the same message after the same events,
    and the plane counts one exception."""
    deltas = ['hello <tool_call>{"name": "f", ', '"arguments": {"a": 1}}</tool_call>', ' bye']
    got = []
    for api, observe, faults in SIDES:
        plane = observe.ParserPlane()
        ids = iter(f"call-{i}" for i in range(10))
        jail = api.ToolCallJail(call_id_factory=lambda: next(ids), plane=plane)
        events, err = [], None
        plan = faults.FaultPlan(seed=7, rules=(faults.FaultRule(PARSER_JAIL_FEED, at=(at,),
                                                                 kind="error"),))
        with faults.armed(plan) as armed:
            try:
                for d in deltas:
                    events += jail.feed(d)
                events += jail.finish()
            except api.ToolCallParseError as exc:
                err = str(exc)
            trace = list(armed.trace)
        got.append(([repr(e) for e in events], err, trace, plane_state(plane),
                     dict(armed.hits), dict(armed.injected)))
    assert got[1] == got[0]
    assert got[0][1] is not None and got[0][3][0]["exceptions"] == 1
