"""The slice as a whole over sockets: the port's ``HttpService``
(dynamo_tpu_torch/http/service.py on the standard-library server) over its
local pipeline (TorchEngine on the CPU, ``cuda_graphs=False``) against the
JAX package's ``HttpService`` (aiohttp) over JAX's (JaxEngine), on the same
weights (``params_from_jax``), built as tests/test_torch_pipeline.py builds
them. Both bind 127.0.0.1, port 0, and get the same requests, one at a
time, from one ``http.client`` client: every route the port serves —
completions and chats unary, n 2, streamed with usage and annotations,
logprobs, a stop string, the deadline header and body key, the Responses
API unary and streamed, the errors raised before the first frame as 4xx,
/v1/models, /health, /live, /openapi.json, /busy_threshold, /clear_kv_blocks,
/debug/overload, /debug/parser, an unknown /debug/trajectory/{trace_id},
/v1/embeddings, /v1/images/generations, an
unknown route and a wrong method. Status codes, headers (``Date``,
``Server`` and ``Content-Length`` aside: the last is checked against each
side's own body) and bodies must be equal, with ``id``, ``created``,
``X-Request-Id`` and tool-call ids masked; SSE streams equal frame for
frame; texts and ids exact (temperature 0), logprob values within
LOGPROB_TOL. Then /metrics, in the text format and in OpenMetrics: the
families (the SLO families among them), label sets, counters, histogram
counts and the histograms' bucket boundaries equal, each ``+Inf`` bucket
its count; the SLO phase gauges' values are timings, so only their label
sets are held equal.

One scripted engine written here, registered in both services, holds the
reasoning and tool-call folding of unary and streamed chats equal (in-band
error frames, a stream without a finish, the parser fault seam). A stream
that the client closes after three frames frees the slot on both engines,
and both count status 499. Last, ``python -m dynamo_tpu_torch.cli run
--input http --model tiny --device cpu --http-port 0`` as a subprocess:
its printed port, one chat whose text is the pipeline's, and its end on
SIGINT."""

import asyncio
import http.client
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from dynamo_tpu.http import HttpService as JHttpService
from dynamo_tpu.http import metrics as jmetrics
from dynamo_tpu.http import ModelManager as JModelManager
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.parsers import observe as jobserve
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime.fault_names import PARSER_JAIL_FEED
from dynamo_tpu.runtime import trajectory as jtrajectory
from dynamo_tpu.runtime.metric_names import SLO_PHASE_P99_MS
from dynamo_tpu_torch.cli import run as trun
from dynamo_tpu_torch.http import HttpService as THttpService
from dynamo_tpu_torch.http import ModelManager as TModelManager
from dynamo_tpu_torch.llm import entrypoint as tentry
from dynamo_tpu_torch.llm import model_card as tcard
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.parsers import observe as tobserve
from dynamo_tpu_torch.runtime import faults as tfaults
from dynamo_tpu_torch.runtime import trajectory as ttrajectory
from dynamo_tpu_torch.runtime.context import Context as TContext
from tests.test_torch_pipeline import LOGPROB_TOL, ROOT, _jax_pipeline, _torch_pipeline

TOL = LOGPROB_TOL["tiny"]
G = dict(model="tiny", temperature=0.0)
CHAT = [{"role": "system", "content": "be brief"},
        {"role": "user", "content": "paged attention on tpu"}]
PROMPT = "hello world this is a test"


def requests(stop):
    """(name, method, path, JSON body or raw bytes or None, headers)."""
    c = dict(G, prompt=PROMPT, max_tokens=12)
    ch = dict(G, messages=CHAT, max_tokens=10)
    s = dict(stream=True, stream_options={"include_usage": True})
    resp = {"model": "tiny", "input": "hello world", "max_output_tokens": 8, "temperature": 0}
    return [
        ("completion", "POST", "/v1/completions", c, {}),
        ("completion stream", "POST", "/v1/completions", dict(c, **s), {}),
        ("chat", "POST", "/v1/chat/completions", ch, {}),
        ("chat stream annotations", "POST", "/v1/chat/completions",
         dict(ch, **s, nvext={"annotations": ["formatted_prompt", "token_ids"]}), {}),
        ("chat stream no usage", "POST", "/v1/chat/completions", dict(ch, stream=True), {}),
        ("n 2", "POST", "/v1/completions", dict(G, prompt="the quick brown fox", max_tokens=6,
                                                n=2), {}),
        ("chat n 2", "POST", "/v1/chat/completions", dict(ch, max_tokens=6, n=2), {}),
        ("completion logprobs", "POST", "/v1/completions",
         dict(G, prompt="0123456789 !@#", max_tokens=8, logprobs=3), {}),
        ("completion logprobs stream", "POST", "/v1/completions",
         dict(G, prompt="0123456789 !@#", max_tokens=8, logprobs=2, stream=True), {}),
        ("chat logprobs", "POST", "/v1/chat/completions",
         dict(ch, logprobs=True, top_logprobs=3), {}),
        ("chat logprobs stream", "POST", "/v1/chat/completions",
         dict(ch, logprobs=True, top_logprobs=2, **s), {}),
        ("stop", "POST", "/v1/completions", dict(c, stop=[stop]), {}),
        ("stop stream", "POST", "/v1/completions", dict(c, stop=[stop], stream=True), {}),
        ("deadline header", "POST", "/v1/completions", dict(c, max_tokens=4),
         {"x-dynamo-deadline-ms": "60000"}),
        ("deadline body", "POST", "/v1/chat/completions", dict(ch, max_tokens=4,
                                                              deadline_ms=60000), {}),
        ("traceparent", "POST", "/v1/completions", dict(c, max_tokens=4),
         {"traceparent": "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"}),
        ("bad deadline", "POST", "/v1/completions", dict(c, deadline_ms=-5), {}),
        ("bad deadline header", "POST", "/v1/completions", c, {"x-dynamo-deadline-ms": "abc"}),
        ("responses", "POST", "/v1/responses", resp, {}),
        ("responses stream", "POST", "/v1/responses", dict(resp, stream=True), {}),
        ("responses messages", "POST", "/v1/responses",
         dict(resp, input=[{"role": "system", "content": "be brief"},
                           {"content": "paged attention"}]), {}),
        ("responses tools", "POST", "/v1/responses", dict(resp, tools=[{"type": "x"}]), {}),
        ("responses non-text", "POST", "/v1/responses",
         dict(resp, input=[{"role": "user", "content": [{"type": "input_image"}]}]), {}),
        ("responses unknown model", "POST", "/v1/responses", dict(resp, model="nope"), {}),
        ("unknown model", "POST", "/v1/chat/completions", dict(ch, model="nope"), {}),
        ("invalid json", "POST", "/v1/completions", b"{x", {}),
        ("not an object", "POST", "/v1/completions", [1, 2], {}),
        ("stream n 2", "POST", "/v1/completions", dict(c, n=2, stream=True), {}),
        ("bad n", "POST", "/v1/completions", dict(c, n=0), {}),
        ("bad max_tokens", "POST", "/v1/completions", dict(c, max_tokens=-1), {}),
        ("bad max_tokens stream", "POST", "/v1/completions", dict(c, max_tokens=-1,
                                                                  stream=True), {}),
        ("bad temperature chat stream", "POST", "/v1/chat/completions",
         dict(ch, temperature=7, stream=True), {}),
        ("no messages", "POST", "/v1/chat/completions", dict(G, max_tokens=4), {}),
        ("models", "GET", "/v1/models", None, {}),
        ("health", "GET", "/health", None, {}),
        ("live", "GET", "/live", None, {}),
        ("openapi", "GET", "/openapi.json", None, {}),
        ("busy list empty", "GET", "/busy_threshold", None, {}),
        ("busy get", "POST", "/busy_threshold", {"model": "tiny"}, {}),
        ("busy set", "POST", "/busy_threshold",
         {"model": "tiny", "active_decode_blocks_threshold": 0.9}, {}),
        ("busy list", "GET", "/busy_threshold", None, {}),
        ("busy no model", "POST", "/busy_threshold", {}, {}),
        ("served while thresholds set", "POST", "/v1/completions", dict(c, max_tokens=3), {}),
        ("clear kv", "POST", "/clear_kv_blocks", None, {}),
        ("clear kv model", "POST", "/clear_kv_blocks", {"model": "tiny"}, {}),
        ("clear kv unknown", "POST", "/clear_kv_blocks", {"model": "nope"}, {}),
        ("debug overload", "GET", "/debug/overload", None, {}),
        ("debug trajectory unknown", "GET", "/debug/trajectory/" + "f" * 32, None, {}),
        ("debug parser", "GET", "/debug/parser?limit=2", None, {}),
        ("debug parser bad limit", "GET", "/debug/parser?limit=abc", None, {}),
        ("embeddings", "POST", "/v1/embeddings", {"model": "tiny", "input": "x"}, {}),
        ("images", "POST", "/v1/images/generations", {"model": "tiny", "prompt": "a cat"}, {}),
        ("images no prompt", "POST", "/v1/images/generations", {"model": "tiny"}, {}),
        ("unknown route", "GET", "/v2/nothing", None, {}),
        ("wrong method", "GET", "/v1/completions", None, {}),
        ("head", "HEAD", "/health", None, {}),
    ]


def call(port, method, path, body=None, headers=None):
    """One request on its own connection: (status, headers, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    data = body if isinstance(body, bytes) or body is None else json.dumps(body)
    hdrs = dict(headers or {})
    if data is not None:
        hdrs.setdefault("Content-Type", "application/json")
    conn.request(method, path, body=data, headers=hdrs)
    r = conn.getresponse()
    out = (r.status, {k.lower(): v for k, v in r.getheaders()}, r.read())
    conn.close()
    return out


def mask(obj):
    """``id`` strings, ``created`` and flight-ring event times masked."""
    if isinstance(obj, dict):
        return {k: ("<id>" if k == "id" and isinstance(v, str) else
                    "<t>" if k in ("created", "t_mono") else mask(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [mask(v) for v in obj]
    return obj


def shape(text):
    """A body's text with ids, times and floats masked: what is left must
    be equal byte for byte (separators, key order, escapes)."""
    text = re.sub(r'"id": ?"[^"]*"', '"id":"<id>"', text)
    text = re.sub(r'"(created|t_mono)": ?[0-9.]+', r'"\1":<t>', text)
    return re.sub(r"-?\d+\.\d+(e-?\d+)?", "<f>", text)


def frames(text):
    """An SSE body as a list of (kind, payload) frames."""
    out = []
    for frame in text.split("\n\n"):
        if not frame:
            continue
        if frame == "data: [DONE]":
            out.append(("done", None))
        elif frame.startswith("data: "):
            out.append(("data", mask(json.loads(frame[6:]))))
        elif frame.startswith(": "):
            out.append(("comment", json.loads(frame[2:])))
        else:
            event, data = frame.split("\n")
            out.append((event, mask(json.loads(data[len("data: "):]))))
    return out


def view(status, headers, body, path=""):
    """What is compared of a response."""
    headers = dict(headers)
    for k in ("date", "server"):
        headers.pop(k, None)
    if "content-length" in headers:  # (a HEAD response has no body)
        assert int(headers.pop("content-length")) == len(body) or not body
    if "x-request-id" in headers:
        headers["x-request-id"] = "<rid>"
    ctype = headers.get("content-type", "")
    if not body:
        content = body
    elif ctype.startswith("text/event-stream"):
        content = frames(body.decode()), shape(body.decode())
    elif ctype.startswith("application/json"):
        content = mask(json.loads(body))
        if path == "/openapi.json":
            # the trajectory routes come with the distributed runtime
            for p in ("/debug/trajectory", "/debug/trajectory/{trace_id}"):
                content["paths"].pop(p, None)
        content = content, shape(json.dumps(content) if path == "/openapi.json"
                                 else body.decode())
    else:
        content = body
    return status, headers, content


def close(a, b, where="$"):
    """Equal, floats (logprobs) within TOL."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), where
        assert abs(a - b) <= TOL, (where, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, a, b)
        for k in a:
            close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def metric_samples(text, drop=()):
    """{family: type}, {(sample, labels): value} and the histograms' bucket
    keys {(sample, labels)} (``le`` among the labels) of an exposition, text
    format or OpenMetrics (exemplars cut), without prometheus_client's
    ``_created`` families and samples and the families in ``drop``. Bucket
    and sum values are timings, so only the bucket keys are returned; each
    histogram's ``+Inf`` bucket is checked here against its ``_count``."""
    def dropped(name):
        return any(name == d or name.startswith(d + "_") for d in drop)

    types, samples, buckets, inf = {}, {}, set(), {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
        elif line and not line.startswith("#"):
            m = re.match(r"([a-zA-Z_:][\w:]*)(\{[^}]*\})? (\S+)$", line.split(" # ")[0])
            name, labels, value = m.groups()
            labels = tuple(sorted(re.findall(r'(\w+)="([^"]*)"', labels or "")))
            if name.endswith(("_created", "_sum")) or dropped(name):
                continue
            if name.endswith("_bucket"):
                buckets.add((name, labels))
                if ("le", "+Inf") in labels:
                    inf[(name[:-len("_bucket")] + "_count",
                         tuple(kv for kv in labels if kv[0] != "le"))] = float(value)
                continue
            samples[(name, labels)] = float(value)
    for key, value in inf.items():
        assert samples[key] == value, (key, value)
    family = {n: t for n, t in types.items()
              if not n.endswith("_created") and n not in drop and n + "_total" not in drop}
    return family, samples, buckets


def phase_keys(text):
    """The label sets of the SLO phase gauge's samples in an exposition."""
    return set(re.findall(rf'^{SLO_PHASE_P99_MS}(\{{[^}}]*\}}) ', text, re.M))


class Pair:
    """The JAX service and the port's, each over its own entries."""

    def __init__(self, jax_entries, torch_entries):
        jm, tm = JModelManager(), TModelManager()
        for name, engine, card in jax_entries:
            jm.register(name, engine, card)
        for name, engine, card in torch_entries:
            tm.register(name, engine, card)
        self.services = (JHttpService(jm, host="127.0.0.1", port=0),
                         THttpService(tm, host="127.0.0.1", port=0))

    async def __aenter__(self):
        self.ports = [await s.start() for s in self.services]
        return self

    async def __aexit__(self, *exc):
        for s in self.services:
            await s.stop(grace_period=5)

    async def both(self, method, path, body=None, headers=None):
        return [await asyncio.to_thread(call, port, method, path, body, headers)
                for port in self.ports]


@pytest.fixture
def fresh_planes(monkeypatch):
    """A new process-global parser plane and trajectory store on each
    side, and the audit off."""
    for observe in (jobserve, tobserve):
        monkeypatch.setattr(observe, "_PLANE", None)
    for trajectory in (jtrajectory, ttrajectory):
        monkeypatch.setattr(trajectory, "_STORE", None)
    monkeypatch.delenv("DYN_TPU_AUDIT", raising=False)


async def test_every_route_matches_jax(fresh_planes):
    jp, je, _, _ = _jax_pipeline("tiny")
    tp, te, _, _ = _torch_pipeline("tiny")
    jc, tc = (api.ModelDeploymentCard(name="tiny", context_length=160, kv_block_size=4,
                                      eos_token_ids=[2]) for api in (jcard, tcard))
    try:
        async with Pair([("tiny", jp, jc)], [("tiny", tp, tc)]) as pair:
            # a stop string the stop requests' stream reaches (from the port;
            # the comparison holds it to JAX's)
            _, (_, _, raw) = await pair.both("POST", "/v1/completions",
                                             dict(G, prompt=PROMPT, max_tokens=12))
            text = json.loads(raw)["choices"][0]["text"]
            stop = next(text[i:i + 2] for i in range(3, len(text) - 1) if text[i:i + 2].strip())
            for name, method, path, body, headers in requests(stop):
                want, got = await pair.both(method, path, body, headers)
                close(view(*got, path), view(*want, path), name)
                if name == "stop":
                    assert json.loads(got[2])["choices"][0]["finish_reason"] == "stop"
                if name.startswith("bad max_tokens stream"):
                    assert got[0] == 400
            # Every request runs in a trace (its http root span), and a
            # bucket's exemplar is its last observation's: the client-traced
            # request goes once more, last, for the exemplar checked below.
            # Its trajectory: the root a child of the client's span, on both.
            traced = next(r for r in requests(stop) if r[0] == "traceparent")
            want, got = await pair.both(*traced[1:])
            close(view(*got, traced[2]), view(*want, traced[2]), "traceparent, last")
            views = [json.loads(b) for _, _, b in await pair.both(
                "GET", "/debug/trajectory/0af7651916cd43dd8448eb211c80319c")]
            for v in views:
                root = next(x for x in v["spans"] if x["name"] == "http.completions")
                assert root["parent_span_id"] == "b7ad6b7169203331" and v["complete"]
            assert {x["name"] for x in views[1]["spans"]} == {x["name"] for x in views[0]["spans"]}
            # the scrape: text format, then OpenMetrics
            (js, jh, jb), (ts, th, tb) = await pair.both("GET", "/metrics")
            assert ts == js == 200 and th["content-type"] == jh["content-type"]
            jfam, jsamp, jbuck = metric_samples(jb.decode(), drop=(SLO_PHASE_P99_MS,))
            tfam, tsamp, tbuck = metric_samples(tb.decode(), drop=(SLO_PHASE_P99_MS,))
            assert tfam == jfam
            assert phase_keys(tb.decode()) == phase_keys(jb.decode()) != set()
            assert tsamp == jsamp
            # the three histograms' boundaries, each series' full set
            assert tbuck == jbuck
            assert {dict(k[1])["le"] for k in tbuck} == {
                *(repr(float(b)) for b in jmetrics._SECONDS_BUCKETS), "+Inf"}
            assert {k[0] for k in tbuck} == {f"dynamo_tpu_frontend_{h}_bucket" for h in (
                "request_duration_seconds", "time_to_first_token_seconds",
                "inter_token_latency_seconds")}
            statuses = {dict(k[1])["status"] for k in tsamp if "status" in dict(k[1])}
            # (errors found before a request is timed, as a 404 for a
            # model that is not served, are not counted, on either side)
            assert statuses == {"200", "400"}
            hdr = {"Accept": "application/openmetrics-text; version=1.0.0"}
            (js, jh, jb), (ts, th, tb) = await pair.both("GET", "/metrics", None, hdr)
            assert th["content-type"] == jh["content-type"] == "application/openmetrics-text"
            assert tb.endswith(b"\n# EOF\n") and tb.count(b"# EOF") == 1
            assert b'# {trace_id="0af7651916cd43dd8448eb211c80319c"}' in tb
            jom = {line.split(" ")[2] for line in jb.decode().splitlines()
                   if line.startswith("# TYPE ")}
            tom = {line.split(" ")[2] for line in tb.decode().splitlines()
                   if line.startswith("# TYPE ")}
            assert tom == jom
            assert metric_samples(tb.decode(), drop=(SLO_PHASE_P99_MS,)) == metric_samples(
                jb.decode(), drop=(SLO_PHASE_P99_MS,))
            assert phase_keys(tb.decode()) == phase_keys(jb.decode())
    finally:
        await je.stop()
        await te.stop()


class Scripted:
    """An AsyncEngine that streams a fixed script a request, chosen by the
    last message's text, as PostprocessedOutput items of one protocol
    module (``common``)."""

    def __init__(self, common):
        self.common = common

    async def generate(self, request, context):
        script = SCRIPTS[request["messages"][-1]["content"]]
        yield {"annotation": "_prompt_tokens", "value": 7}
        for i, part in enumerate(script):
            if part is ERROR:
                yield self.common.PostprocessedOutput(error="worker link lost",
                                                      error_kind="connection")
                return
            last = i == len(script) - 1
            finish = None
            if last and request["messages"][-1]["content"] != "no finish":
                finish = self.common.FinishReason.STOP
            yield self.common.PostprocessedOutput(text=part, token_ids=[100 + i],
                                                  cumulative_tokens=i + 1,
                                                  finish_reason=finish)
            await asyncio.sleep(0)


ERROR = object()
SCRIPTS = {
    "call": ["<think>let me ", "check</think>Sure. <tool_", 'call>{"name": "get_weather", ',
             '"arguments": {"city": "Paris", "days": [1, 2]}}</tool_call>', " done"],
    "two calls": ['<tool_call>{"name": "a", "arguments": {}}</tool_call> and ',
                  '<tool_call>{"name": "b", "arguments": {"x": {"y": "z,w"}}}</tool_call>'],
    "mistral": ['[TOOL_CALLS][{"name": "add", "arguments": {"a": 1, ', '"b": 2}}]'],
    "malformed": ['<tool_call>{"name": "f", "arguments": {"a": [1, 2'],
    "lossy": ['<tool_call>{"name": "s", "arguments": "not json {"}</tool_call>'],
    "reasoning": ["<think>a", "b</think>", "answer ", "here"],
    "unterminated": ["<think>still ", "thinking"],
    "no finish": ["<think>x</think>partial ", "<tool_call>{\"name\": \"f\", "],
    "error": ["partial", ERROR],
}


def scripted_body(name, stream, tools=True):
    body = {"model": "scripted", "messages": [{"role": "user", "content": name}],
            "stream": stream}
    if tools:
        body["tools"] = [{"type": "function", "function": {"name": "get_weather"}}]
    return body


@pytest.mark.parametrize("stream", [False, True])
async def test_reasoning_and_tool_call_folding_match_jax(stream, fresh_planes):
    entries = [[("scripted", Scripted(common), api.ModelDeploymentCard(name="scripted"))]
               for common, api in ((jcommon, jcard), (tcommon, tcard))]
    async with Pair(*entries) as pair:
        for name in SCRIPTS:
            for tools in (True, False):
                want, got = await pair.both("POST", "/v1/chat/completions",
                                            scripted_body(name, stream, tools))
                close(view(*got), view(*want), (name, tools))
        if stream:
            # a parser bug mid-stream: the same typed error frame on both
            plans = [api.FaultPlan(rules=(api.FaultRule(PARSER_JAIL_FEED, at=(2,),
                                                        kind="error"),))
                     for api in (jfaults, tfaults)]
            with jfaults.armed(plans[0]), tfaults.armed(plans[1]):
                want, got = await pair.both("POST", "/v1/chat/completions",
                                            scripted_body("call", True))
            close(view(*got), view(*want), "fault")
            assert b'"error_kind":"tool_call_parse"' in got[2]
        want, got = await pair.both("GET", "/debug/parser")
        close(view(*got), view(*want), "debug parser")
        # the jail streams calls; a unary chat parses the whole text once
        assert (json.loads(got[2])["calls"] > 0) == stream
        (_, _, jb), (_, _, tb) = await pair.both("GET", "/metrics")
        assert metric_samples(tb.decode(), drop=(SLO_PHASE_P99_MS,)) == metric_samples(
            jb.decode(), drop=(SLO_PHASE_P99_MS,))


async def test_audit_records_match_jax(fresh_planes, tmp_path, monkeypatch):
    """With DYN_TPU_AUDIT=file:PATH each service writes one JSONL record a
    chat, unary and streamed (``ts`` and ``request_id`` masked)."""
    entries = [[("scripted", Scripted(common), api.ModelDeploymentCard(name="scripted"))]
               for common, api in ((jcommon, jcard), (tcommon, tcard))]
    paths = [tmp_path / "jax.jsonl", tmp_path / "port.jsonl"]
    pair = Pair(*entries)
    for service, path in zip(pair.services, paths):
        monkeypatch.setenv("DYN_TPU_AUDIT", f"file:{path}")
        service.audit = type(service.audit).from_env()
    async with pair:
        for name, stream in (("call", False), ("call", True), ("reasoning", True),
                             ("error", True)):
            await pair.both("POST", "/v1/chat/completions", scripted_body(name, stream))
    want, got = ([{**json.loads(line), "ts": 0, "request_id": "<rid>"}
                  for line in path.read_text().splitlines()] for path in paths)
    assert got == want
    assert [(r["requested_streaming"], r["status"]) for r in got] == [
        (False, 200), (True, 200), (True, 200), (True, 502)]


async def test_closed_stream_frees_the_slot_on_both(fresh_planes):
    jp, je, _, _ = _jax_pipeline("tiny")
    tp, te, _, _ = _torch_pipeline("tiny")
    cards = [api.ModelDeploymentCard(name="tiny", context_length=160, kv_block_size=4)
             for api in (jcard, tcard)]
    body = json.dumps(dict(G, prompt="the quick brown fox", max_tokens=140, stream=True,
                           ignore_eos=True)).encode()
    try:
        async with Pair([("tiny", jp, cards[0])], [("tiny", tp, cards[1])]) as pair:
            for port, engine in zip(pair.ports, (je, te)):
                reader, writer = await asyncio.open_connection("127.0.0.1", port)
                writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                             b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n%b"
                             % (len(body), body))
                got = b""
                while got.count(b"data: ") < 3:
                    got += await asyncio.wait_for(reader.read(4096), 30)
                writer.close()
                for _ in range(1000):
                    st = engine.stats()
                    if not st["active_seqs"] and not st["waiting"]:
                        break
                    await asyncio.sleep(0.01)
                st = engine.stats()
                assert (st["active_seqs"], st["waiting"]) == (0, 0)
                assert st["generated_tokens"] < 140  # cut short, not run to max_tokens
            for _ in range(200):
                (_, _, jb), (_, _, tb) = await pair.both("GET", "/metrics")
                if b'status="499"' in jb and b'status="499"' in tb:
                    break
                await asyncio.sleep(0.01)
            key = ("dynamo_tpu_frontend_requests_total",
                   (("endpoint", "completions"), ("model", "tiny"), ("status", "499")))
            assert metric_samples(jb.decode())[1][key] == metric_samples(tb.decode())[1][key] == 1
    finally:
        await je.stop()
        await te.stop()


async def test_sse_client_tool_reads_what_http_client_reads(fresh_planes):
    """tools/sse_client.py (chip_smoke's load side, run by path in a process
    of its own) against the port's service: the same status and frames as
    http.client for a stream, the same body for a unary chat and a GET,
    and a connection closed after ``close_after`` frames."""
    entries = [("scripted", Scripted(tcommon), tcard.ModelDeploymentCard(name="scripted"))]
    manager = TModelManager()
    manager.register(*entries[0])
    service = THttpService(manager, host="127.0.0.1", port=0)
    port = await service.start()
    try:
        reqs = [{"path": "/v1/chat/completions", "body": scripted_body("call", True)},
                {"path": "/v1/chat/completions", "body": scripted_body("call", False)},
                {"method": "GET", "path": "/health"},
                {"path": "/v1/chat/completions", "body": scripted_body("reasoning", True),
                 "close_after": 2},
                {"path": "/v1/completions", "raw": "{not json"}]
        proc = await asyncio.create_subprocess_exec(
            sys.executable, os.path.join(ROOT, "dynamo_tpu_torch", "tools", "sse_client.py"),
            str(port), stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE)
        out, _ = await asyncio.wait_for(proc.communicate(json.dumps(reqs).encode()), 60)
        got = json.loads(out)
        want = [await asyncio.to_thread(call, port, r.get("method", "POST"), r["path"],
                                        r.get("body", r.get("raw", "").encode() or None))
                for r in reqs[:3]]
    finally:
        await service.stop(grace_period=5)
    assert [r["status"] for r in got] == [200, 200, 200, 200, 400]
    stream, unary, health, left, bad = got
    assert frames("".join(f + "\n\n" for _, f in stream["frames"])) == \
        frames(want[0][2].decode())
    assert stream["t0"] <= stream["frames"][0][0] <= stream["frames"][-1][0] <= stream["t_end"]
    assert mask(json.loads(unary["body"])) == mask(json.loads(want[1][2]))
    assert health["body"] == want[2][2].decode()
    assert len(left["frames"]) == 2 and left["frames"][-1][1] != "data: [DONE]"
    assert json.loads(bad["body"])["error"]["message"] == "invalid JSON body"


def test_cli_run_serves_http_until_sigint():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "--input", "http", "--model", "tiny",
         "--device", "cpu", "--http-port", "0", "--max-model-len", "256"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    try:
        line = proc.stdout.readline()
        m = re.fullmatch(r"http server on :(\d+) serving tiny\n", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None else "")
        body = dict(G, messages=CHAT, max_tokens=12)
        status, _, raw = call(int(m.group(1)), "POST", "/v1/chat/completions", body)
        assert status == 200
        served = json.loads(raw)["choices"][0]["message"]["content"]
        proc.send_signal(signal.SIGINT)
        t0 = time.monotonic()
        proc.wait(timeout=30)
        assert time.monotonic() - t0 < 15
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    # the same chat through the pipeline over the engine the command builds
    # (the same random weights from the same seed)
    parser = __import__("argparse").ArgumentParser()
    trun.add_run_args(parser)
    args = parser.parse_args(["--model", "tiny", "--device", "cpu", "--max-model-len", "256"])

    async def pipeline_text():
        engine, card, tok = trun.build_engine_and_card(args)
        pipeline = tentry.build_local_pipeline(card, engine, tokenizer=tok)
        try:
            return "".join([x.text async for x in pipeline.generate(body, TContext())
                            if not isinstance(x, dict)])
        finally:
            await engine.stop()

    assert served == asyncio.run(pipeline_text())
    assert served
