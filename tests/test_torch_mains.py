"""The port's worker and frontend mains.

``worker.__main__.build_parser()`` gives JAX's defaults for every flag the
two share, and the frontend's parser JAX's frontend's; each flag whose
machinery the port lacks exits naming its ROADMAP item; the frontend
serves TLS; the worker left on its default device exits naming cuda. Then processes on the CPU: the
port's discd, two ``python -m dynamo_tpu_torch.worker --model tiny
--device cpu`` and ``python -m dynamo_tpu_torch.frontend``. The model
appears on ``/v1/models``; a stream completes; a stream whose worker is
SIGKILLed after 100 tokens migrates to the other worker and ends equal to
the same request run unbroken there; the frontend's ``/metrics`` counts
the migration; SIGTERM ends the survivor and the frontend with exit 0.
Then disaggregated serving on the CPU: discd, a ``--is-prefill-worker``,
a decode worker and the frontend; a chat above the PrefillRouter's
threshold is served disaggregated (the decode worker pulls the prompt's
blocks and prefills less than the prompt), and with the prefill worker
ended the same chat is served aggregated with the same text.
Each process test keeps its own deadline, under 90 s."""

import argparse
import asyncio
import http.client
import json
import os
import queue
import re
import shutil
import signal
import ssl
import subprocess
import sys
import threading
import time

import pytest

from dynamo_tpu.frontend import __main__ as jfrontend
from dynamo_tpu.worker import __main__ as jworker
from dynamo_tpu_torch.frontend import __main__ as tfrontend
from dynamo_tpu_torch.worker import __main__ as tworker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 80.0  # each process test's own bound


def test_worker_parser_defaults_equal_jax():
    jargs = vars(jworker.build_parser().parse_args([]))
    targs = vars(tworker.build_parser().parse_args([]))
    shared = set(jargs) & set(targs)
    assert set(jargs) - shared == set() and set(targs) - shared == {"device"}
    assert {k: targs[k] for k in shared} == {k: jargs[k] for k in shared}
    assert targs["device"] == "cuda"


def test_frontend_parser_defaults_equal_jax(monkeypatch):
    """JAX's frontend builds its parser inside main(): catch it there."""
    caught = []

    class Caught(Exception):
        pass

    def parse_args(self, args=None, namespace=None):
        caught.append(self)
        raise Caught

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(Caught):
        asyncio.run(jfrontend.main())
    monkeypatch.undo()
    jdefaults = vars(caught[0].parse_args([]))
    assert vars(tfrontend.build_parser().parse_args([])) == jdefaults


REFUSED = [
    (["--kv-offload-blocks", "64"], "ROADMAP A10, KVBM"),
    (["--kv-offload-dir", "/tmp/x"], "ROADMAP A10, KVBM"),
    (["--kv-remote", "a/b/c"], "ROADMAP A10, KVBM"),
    (["--kv-host-arena-mb", "8"], "ROADMAP A10, KVBM"),
    (["--lora-dir", "/tmp/x"], "ROADMAP A7"),
    (["--tick-budget"], "ROADMAP A9, the tick budget"),
    (["--tick-budget-floor", "32"], "ROADMAP A9, the tick budget"),
    (["--tick-budget-policy", "0.0"], "ROADMAP A9, the tick budget"),
    (["--kv-checkpoint-dir", "/tmp/x"], "ROADMAP A6-2"),
    (["--coordinator", "h:1"], "ROADMAP A9, parallelism"),
    (["--num-processes", "2"], "ROADMAP A9, parallelism"),
    (["--process-id", "0"], "ROADMAP A9, parallelism"),
    (["--tp", "2"], "ROADMAP A9, parallelism"),
    (["--no-prefix-caching"], "ROADMAP A9, prefix caching off"),
    (["--model-type", "multimodal"], "ROADMAP A9, multimodal"),
    (["--model", "mixtral-8x7b"], "ROADMAP A7"),
    (["--model", "/tmp"], "ROADMAP A9, weight loading"),
    (["--weight-cache-dir", "/tmp/x"], "ROADMAP A9, weight loading"),
]


@pytest.mark.parametrize("argv,item", REFUSED, ids=[" ".join(a) for a, _ in REFUSED])
def test_worker_refuses_unported_flags_naming_the_item(argv, item, capsys):
    parser = tworker.build_parser()
    with pytest.raises(SystemExit) as exc:
        tworker.refuse_unported(parser, parser.parse_args(argv))
    assert exc.value.code == 2
    assert item in capsys.readouterr().err


def test_worker_serves_the_port_presets_and_accepts_their_flags():
    parser = tworker.build_parser()
    for model in tworker.BUILTIN_CONFIGS:
        tworker.refuse_unported(parser, parser.parse_args(
            ["--model", model, "--quantization", "int8", "--kv-cache-dtype", "auto",
             "--decode-steps", "4", "--pipeline-depth", "1", "--device", "cpu",
             "--system-port", "0"]))
    assert set(tworker.BUILTIN_CONFIGS) | set(tworker.MOE_PRESETS) == set(jworker.BUILTIN_CONFIGS)


async def test_worker_passes_the_speculative_flags_to_the_engine(monkeypatch):
    """``--speculative ngram --spec-k 3 --spec-ngram 2`` is accepted and
    reaches the engine a worker main serves (in process, on the CPU): its
    args carry them, and a looping greedy request runs verify ticks."""
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.discovery import MemoryDiscovery
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    monkeypatch.setenv("DYN_TPU_WORKER_ID", "261")
    parser = tworker.build_parser()
    args = parser.parse_args([
        "--model", "tiny", "--device", "cpu", "--num-kv-blocks", "64", "--max-num-seqs", "2",
        "--max-model-len", "128", "--prefill-chunk", "32", "--decode-steps", "4",
        "--speculative", "ngram", "--spec-k", "3", "--spec-ngram", "2"])
    tworker.refuse_unported(parser, args)  # no longer refused
    rt = DistributedRuntime(discovery=MemoryDiscovery(), bus="mains-spec-flags")
    worker = await tworker.serve_worker(args, rt)
    engine = worker.engine
    try:
        a = engine.args
        assert (a.spec_mode, a.spec_k, a.spec_ngram) == ("ngram", 3, 2)
        req = PreprocessedRequest(token_ids=[9] * 16, sampling=SamplingOptions(temperature=0.0),
                                  stop=StopConditions(max_tokens=24))
        toks = [t async for out in engine.generate(req, Context()) for t in out.token_ids]
        stats = engine.stats()
        assert len(toks) == 24 and stats["spec_ticks"] > 0 and stats["spec_proposed"] > 0
        assert stats["pipeline_depth"] == 1
    finally:
        await worker.close()
        await rt.shutdown(grace_period=1)


def _run(args, env=None, timeout=60):
    env = {**os.environ, **(env or {}), "PYTHONUNBUFFERED": "1"}
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=ROOT)


def test_frontend_serves_tls_and_worker_needs_the_card_by_default(tmp_path):
    """``--tls-cert``/``--tls-key`` (a certificate from ``openssl req
    -x509``, as tests/test_http_e2e.py makes it): the frontend answers over
    HTTPS and not over plain HTTP, and ends on SIGTERM with exit 0. Given
    only one of the two, it refuses to start."""
    env = {"DYN_TPU_DISCOVERY": "memory", "DYN_TPU_EVENT_PLANE": "memory"}
    for flag in ("--tls-cert", "--tls-key"):
        proc = _run(["dynamo_tpu_torch.frontend", "--http-port", "0", flag,
                     str(tmp_path / "x.pem")], env=env)
        assert proc.returncode == 2 and "--tls-cert and --tls-key" in proc.stderr
        assert "frontend listening" not in proc.stdout
    if shutil.which("openssl") is None:
        pytest.skip("openssl unavailable")
    cert, key = str(tmp_path / "c.pem"), str(tmp_path / "k.pem")
    gen = subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                          "-keyout", key, "-out", cert, "-days", "1", "-subj", "/CN=localhost"],
                         capture_output=True)
    if gen.returncode != 0:
        pytest.skip("openssl unavailable")
    deadline = time.monotonic() + DEADLINE_S
    env = {**os.environ, "PYTHONUNBUFFERED": "1", "DYN_TPU_DISCOVERY": "memory",
           "DYN_TPU_EVENT_PLANE": "memory", "DYN_TPU_GRACE_PERIOD": "5"}
    frontend = Proc(["dynamo_tpu_torch.frontend", "--host", "127.0.0.1", "--http-port", "0",
                     "--tls-cert", cert, "--tls-key", key], env)
    try:
        port = int(frontend.wait_for(r"frontend listening on \S+:(\d+)", deadline).group(1))
        ctx = ssl.create_default_context(cafile=cert)
        ctx.check_hostname = False
        for path, want in (("/health", {"status": "no_models", "models": []}),
                           ("/v1/models", {"object": "list", "data": []})):
            conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=30, context=ctx)
            conn.request("GET", path)
            r = conn.getresponse()
            assert (r.status, json.loads(r.read())) == (200, want)
            conn.close()
        with pytest.raises((http.client.HTTPException, ConnectionError)):
            _get(port, "/health")  # plain HTTP gets no HTTP answer
        frontend.proc.send_signal(signal.SIGTERM)
        assert frontend.proc.wait(timeout=10) == 0
    finally:
        frontend.end()
    # no card here: the worker on its default device stops before serving
    proc = _run(["dynamo_tpu_torch.worker", "--model", "tiny"],
                env={"DYN_TPU_DISCOVERY": "memory", "DYN_TPU_EVENT_PLANE": "memory"})
    assert proc.returncode != 0 and "cuda" in proc.stderr
    assert "worker serving" not in proc.stdout


class Proc:
    """A child process whose output a thread reads into a queue."""

    def __init__(self, args, env):
        self.proc = subprocess.Popen([sys.executable, "-m", *args], env=env, cwd=ROOT,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)
        self.lines, self.log = queue.Queue(), []
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            self.log.append(line)
            self.lines.put(line)
        self.lines.put(None)

    def wait_for(self, pattern, deadline):
        while time.monotonic() < deadline:
            try:
                line = self.lines.get(timeout=0.2)
            except queue.Empty:
                continue
            if line is None:
                raise AssertionError("exited: " + "".join(self.log)[-3000:])
            m = re.search(pattern, line)
            if m:
                return m
        raise AssertionError(f"{pattern!r} not seen: " + "".join(self.log)[-3000:])

    def end(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=10)


def _post(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    return conn.getresponse()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, r.read()


def _stream(port, body, headers=None, on_tokens=None):
    """A streamed completion: its text, finish reason, tokens counted from
    the logprobs and error frames; ``on_tokens(n)`` after each frame."""
    r = _post(port, "/v1/completions", dict(body, stream=True, logprobs=1), headers)
    assert r.status == 200, r.read()
    text, finish, n, errors = "", None, 0, []
    for raw in r:
        line = raw.decode().strip()
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        chunk = json.loads(line[6:])
        if "error" in chunk:
            errors.append(chunk)
            continue
        choice = chunk["choices"][0]
        text += choice["text"]
        finish = choice["finish_reason"] or finish
        n += len((choice.get("logprobs") or {}).get("tokens") or [])
        if on_tokens is not None:
            on_tokens(n)
    return text, finish, n, errors


def test_processes_serve_migrate_a_killed_workers_stream_and_end_on_sigterm():
    deadline = time.monotonic() + DEADLINE_S
    env = {**os.environ, "PYTHONUNBUFFERED": "1", "DYN_TPU_LOAD_REPORT_INTERVAL_S": "0.2",
           "DYN_TPU_LIVENESS_INTERVAL_S": "0.2", "DYN_TPU_LIVENESS_DEAD_AFTER": "4",
           "DYN_TPU_GRACE_PERIOD": "5"}
    procs = []
    try:
        discd = Proc(["dynamo_tpu_torch.discd", "--port", "0", "--xsub", "0", "--xpub", "0"],
                     env)
        procs.append(discd)
        m = discd.wait_for(r"discd ready: discovery (\S+), events (\S+)", deadline)
        env.update({"DYN_TPU_DISCOVERY": "discd", "DYN_TPU_DISCOVERY_ADDR": m.group(1),
                    "DYN_TPU_EVENT_PLANE": "zmq", "DYN_TPU_EVENT_PLANE_ADDR": m.group(2),
                    "DYN_TPU_REQUEST_PLANE": "tcp"})
        workers = {}
        for wid in (0x101, 0x202):
            workers[wid] = Proc(["dynamo_tpu_torch.worker", "--model", "tiny", "--device",
                                 "cpu", "--num-kv-blocks", "256", "--max-model-len", "512"],
                                {**env, "DYN_TPU_WORKER_ID": str(wid)})
            procs.append(workers[wid])
        frontend = Proc(["dynamo_tpu_torch.frontend", "--host", "127.0.0.1",
                         "--http-port", "0"], env)
        procs.append(frontend)
        port = int(frontend.wait_for(r"frontend listening on \S+:(\d+)", deadline).group(1))
        for wid, w in workers.items():
            w.wait_for(rf"worker serving tiny-llama as dynamo/backend/generate instance "
                       rf"{wid:#x} incarnation 0x[0-9a-f]+", deadline)
        while True:
            models = json.loads(_get(port, "/v1/models")[1])["data"]
            if [m["id"] for m in models] == ["tiny-llama"]:
                break
            assert time.monotonic() < deadline, models
            time.sleep(0.05)
        body = {"model": "tiny-llama", "prompt": "hello world this is a test",
                "max_tokens": 300, "temperature": 0.0}
        # unbroken on the worker that survives, then on the one killed
        want = _stream(port, body, {"x-dynamo-worker": str(0x202)})
        assert want[1:] == ("length", 300, []) and want[0]
        assert _stream(port, body, {"x-dynamo-worker": str(0x101)}) == want

        def kill_at_100(n):
            if n >= 100 and workers[0x101].proc.poll() is None:
                workers[0x101].proc.kill()

        got = _stream(port, body, {"x-dynamo-worker": str(0x101)}, on_tokens=kill_at_100)
        assert workers[0x101].proc.wait(timeout=10) == -signal.SIGKILL
        assert got == want
        metrics = _get(port, "/metrics")[1].decode()
        migrated = re.search(r'dynamo_tpu_migration_migrations_total\{reason="connection"\} '
                             r'(\S+)', metrics)
        assert migrated and 1 <= float(migrated.group(1)) <= 3, metrics[-2000:]
        # SIGTERM: the survivor and the frontend end with exit 0
        workers[0x202].proc.send_signal(signal.SIGTERM)
        assert workers[0x202].proc.wait(timeout=10) == 0
        frontend.proc.send_signal(signal.SIGTERM)
        assert frontend.proc.wait(timeout=10) == 0
        assert time.monotonic() < deadline
    finally:
        for p in reversed(procs):
            p.end()


def _get_json(port, path):
    status, body = _get(port, path)
    assert status == 200, (path, status, body[:300])
    return json.loads(body)


def _metric(text, name):
    """The sum of a family's samples (0 without any)."""
    return sum(float(v) for v in re.findall(rf"^{name}(?:{{[^}}]*}})? (\S+)$", text, re.M))


def test_processes_serve_a_chat_disaggregated():
    """A prefill worker main (``--is-prefill-worker``), a decode worker main
    and the frontend main over discd, TCP and ZMQ, tiny preset on the CPU:
    a chat of more than 32 prompt tokens goes to the prefill worker, whose
    blocks the decode worker pulls (its ``/metrics`` counts one transfer of
    the prompt's full blocks) and whose tail alone it prefills; with the
    prefill worker ended by SIGTERM (exit 0), the same chat from an empty
    cache is served aggregated and gives the same text."""
    deadline = time.monotonic() + DEADLINE_S
    env = {**os.environ, "PYTHONUNBUFFERED": "1", "DYN_TPU_LOAD_REPORT_INTERVAL_S": "0.2",
           "DYN_TPU_GRACE_PERIOD": "5"}
    procs = []
    try:
        discd = Proc(["dynamo_tpu_torch.discd", "--port", "0", "--xsub", "0", "--xpub", "0"],
                     env)
        procs.append(discd)
        m = discd.wait_for(r"discd ready: discovery (\S+), events (\S+)", deadline)
        env.update({"DYN_TPU_DISCOVERY": "discd", "DYN_TPU_DISCOVERY_ADDR": m.group(1),
                    "DYN_TPU_EVENT_PLANE": "zmq", "DYN_TPU_EVENT_PLANE_ADDR": m.group(2),
                    "DYN_TPU_REQUEST_PLANE": "tcp"})
        common = ["--model", "tiny", "--device", "cpu", "--num-kv-blocks", "256",
                  "--max-model-len", "512", "--system-port", "0"]
        prefill = Proc(["dynamo_tpu_torch.worker", *common, "--is-prefill-worker"],
                       {**env, "DYN_TPU_WORKER_ID": str(0x301)})
        decode = Proc(["dynamo_tpu_torch.worker", *common], {**env, "DYN_TPU_WORKER_ID": str(0x302)})
        procs += [prefill, decode]
        frontend = Proc(["dynamo_tpu_torch.frontend", "--host", "127.0.0.1",
                         "--http-port", "0"], env)
        procs.append(frontend)
        port = int(frontend.wait_for(r"frontend listening on \S+:(\d+)", deadline).group(1))
        sys_ports = {}
        for name, proc, component, wid in (("prefill", prefill, "prefill", 0x301),
                                           ("decode", decode, "backend", 0x302)):
            sys_ports[name] = int(proc.wait_for(r"system server on :(\d+)", deadline).group(1))
            proc.wait_for(rf"worker serving tiny-llama as dynamo/{component}/generate instance "
                          rf"{wid:#x} incarnation 0x[0-9a-f]+", deadline)
        while [m["id"] for m in _get_json(port, "/v1/models")["data"]] != ["tiny-llama"]:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        chat = {"model": "tiny-llama", "max_tokens": 24, "temperature": 0.0,
                "messages": [{"role": "user", "content": " ".join(
                    ["the quick brown fox jumps over the lazy dog"] * 6)}]}

        def serve():
            r = _post(port, "/v1/chat/completions", chat)
            assert r.status == 200
            doc = json.loads(r.read())
            return doc["choices"][0]["message"]["content"], doc["usage"]

        def stats(name):
            return _get_json(sys_ports[name], "/engine/stats")

        # The frontend's PrefillRouter makes its prefill client at its first
        # request and learns the prefill instance from discd's watch a
        # moment later (JAX's does the same): a short chat first.
        r = _post(port, "/v1/chat/completions", dict(chat, max_tokens=2, messages=[
            {"role": "user", "content": "hi"}]))
        assert r.status == 200, r.read()
        r.read()
        time.sleep(1.0)
        before = {name: stats(name)["prefill_tokens"] for name in sys_ports}
        text, usage = serve()
        prompt = usage["prompt_tokens"]
        assert prompt > 32 and usage["completion_tokens"] == 24 and text
        grew = {name: stats(name)["prefill_tokens"] - before[name] for name in sys_ports}
        assert 0 < grew["decode"] <= 16 + 1 and grew["prefill"] == prompt
        metrics = _get(sys_ports["decode"], "/metrics")[1].decode()
        assert _metric(metrics, "dynamo_tpu_disagg_transfers_total") == 1
        assert _metric(metrics, "dynamo_tpu_disagg_blocks_pulled_total") == prompt // 16
        assert _metric(metrics, "dynamo_tpu_disagg_transfer_failures_total") == 0
        # the prefill worker ends: the same chat, aggregated, from an empty cache
        prefill.proc.send_signal(signal.SIGTERM)
        assert prefill.proc.wait(timeout=15) == 0
        r = _post(port, "/clear_kv_blocks", {})
        assert r.status == 200, r.read()
        before = stats("decode")["prefill_tokens"]
        assert serve() == (text, usage)
        assert stats("decode")["prefill_tokens"] - before == prompt
        assert _metric(_get(sys_ports["decode"], "/metrics")[1].decode(),
                       "dynamo_tpu_disagg_transfers_total") == 1
        for p in (decode, frontend):
            p.proc.send_signal(signal.SIGTERM)
            assert p.proc.wait(timeout=15) == 0
        assert time.monotonic() < deadline
    finally:
        for p in reversed(procs):
            p.end()
