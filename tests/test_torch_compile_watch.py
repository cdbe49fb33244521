"""Compile telemetry over CUDA graph captures (runtime/device_observe.py
``CompileWatcher`` / ``WatchedCapture``, engines/gpu/runner.py's capture
site) on the CPU, against JAX's watcher:

  - the same sequence of keys into a ``WatchedCapture`` and into JAX's
    ``WatchedJit`` (its signature-set path) gives the same snapshot (the
    seconds aside): compiles, signatures, storms past the budget, the
    per-name default budget, totals; a repeated key counts nothing;
  - the runner's capture site, with a stand-in capture (the CPU has no
    graphs): each new graph key counts one compile of
    ``runner.decode_state`` with the capture's wall time, a replay counts
    nothing, each burst variant (logprobs, processors) has its own
    signature count and JAX's budget ``2 × (bit_length(max_blocks_per_seq)
    + 1) + 4``, widths that stop bucketing count recompile storms, and
    /debug/compiles' totals equal the runner's graphs;
  - the families render with JAX's names and bucket bounds, and
    ``render_runtime_metrics`` carries them."""

import contextlib
import types

import numpy as np
import pytest
import torch

from dynamo_tpu.runtime import device_observe as jdo
from dynamo_tpu_torch.engines.gpu import runner as trunner
from dynamo_tpu_torch.engines.gpu.engine import TorchEngineArgs
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.runtime import device_observe as tdo


def _no_seconds(snap):
    for st in snap["programs"].values():
        st.pop("compile_seconds")
        st.pop("last_compile_seconds")
    snap["totals"].pop("compile_seconds")
    return snap


KEYS = [(1, False, False), (2, False, False), (1, False, False), (4, False, False),
        (8, False, False), (8, False, False), (16, False, False), (32, False, False)]


@pytest.mark.parametrize("budget", [None, 2, 5, 100])
def test_captures_count_as_jaxs_compiles_of_the_same_signatures(budget):
    jw, tw = jdo.CompileWatcher(), tdo.CompileWatcher()
    for w in (jw, tw):
        w.set_budget("runner.decode_state", 3)  # the per-name default
    jit = jdo.watched_jit("runner.decode_state", lambda x: x, budget=budget, watcher=jw)
    cap = tdo.watched_capture("runner.decode_state", budget=budget, watcher=tw)
    other = tdo.watched_capture("runner.decode_state", budget=budget, watcher=tw)
    jother = jdo.watched_jit("runner.decode_state", lambda x: x, budget=budget, watcher=jw)
    for nb, lp, procs in KEYS:
        jit(np.zeros((nb, int(lp) + 1, int(procs) + 1), np.float32))
        cap.captured((nb, lp, procs), 0.25)
    jother(np.zeros((1, 1, 1), np.float32))  # another object: its own count
    other.captured((1, False, False), 0.5)
    assert _no_seconds(tw.snapshot()) == _no_seconds(jw.snapshot())
    assert cap.signatures == jit.signatures == 6
    st = tw.snapshot()["programs"]["runner.decode_state"]
    assert st["compiles"] == 7 and st["compile_seconds"] == 6 * 0.25 + 0.5
    assert st["storms"] == max(0, 6 - (budget if budget is not None else 3))
    assert st["last_compile_seconds"] == 0.5


class _StandInCapture:
    """A CapturedCall that records its function instead of a graph."""

    def __init__(self, fn, pool=None, stream=None):
        self.fn, self.replays = fn, 0
        fn()  # a capture runs the burst once

    def replay(self):
        self.replays += 1
        self.fn()


@contextlib.contextmanager
def _stand_in_card(monkeypatch, runner):
    """The runner's capture site on the CPU: the stream calls are no-ops,
    the capture a stand-in, and the runner's device reads as a card inside
    _replay_or_capture, outside the burst itself."""
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(trunner, "CapturedCall", _StandInCapture)
    capture, burst, cpu = runner._replay_or_capture, runner._burst, runner.device
    card = types.SimpleNamespace(type="cuda")

    def burst_on_cpu(key):
        runner.device = cpu
        try:
            burst(key)
        finally:
            runner.device = card

    def on_card(key):
        runner.device, runner._burst = card, burst_on_cpu
        try:
            capture(key)
        finally:
            runner.device, runner._burst = cpu, burst

    yield on_card


@pytest.fixture
def watcher(monkeypatch):
    w = tdo.CompileWatcher()
    monkeypatch.setattr(tdo, "_WATCHER", w)
    return w


def _runner(max_model_len=256, block_size=4):
    args = TorchEngineArgs(config=tconfig.tiny_config(), device="cpu", cuda_graphs=False,
                           max_model_len=max_model_len, block_size=block_size,
                           num_kv_blocks=80, max_num_seqs=2, decode_steps=2)
    return trunner.DeviceRunner(args)


def test_the_runners_captures_count_under_jaxs_program_and_budget(monkeypatch, watcher):
    runner = _runner()
    P = runner.args.max_blocks_per_seq  # 64
    budget = 2 * (P.bit_length() + 1) + 4
    assert runner._decode_sig_budget == budget == 20
    keys = [(1, False, False), (2, False, False), (2, True, False), (4, False, True),
            (2, False, False), (4, True, True), (64, False, False), (1, False, False)]
    with _stand_in_card(monkeypatch, runner) as on_card:
        for key in keys:
            on_card(key)
    snap = watcher.snapshot()
    st = snap["programs"][trunner.DECODE_PROGRAM]
    assert set(runner.graphs) == set(keys) and len(runner.graphs) == 6
    assert st["compiles"] == st["signatures"] == snap["totals"]["compiles"] == 6
    assert st["storms"] == 0 and st["budget"] == budget
    assert sum(g.replays for g in runner.graphs.values()) == 2  # the repeated keys
    assert st["compile_seconds"] == pytest.approx(runner.capture_ms / 1e3, abs=1e-3)
    # one signature count a variant, as JAX has one jit object a variant
    assert {v: w.signatures for v, w in runner._captures.items()} == {
        (False, False): 3, (True, False): 1, (False, True): 1, (True, True): 1}
    text = tdo.render_runtime_metrics()
    assert f'dynamo_tpu_runtime_compiles_total{{program="{trunner.DECODE_PROGRAM}"}} 6' in text
    assert f'dynamo_tpu_runtime_compile_signatures{{program="{trunner.DECODE_PROGRAM}"}} 6' \
        in text
    assert 'le="0.01"' in text and 'le="300"' in text  # JAX's bounds, as JAX writes them


def test_widths_that_stop_bucketing_count_recompile_storms(monkeypatch, watcher):
    runner = _runner()  # 64 pages: a budget of 20 keys a variant
    with _stand_in_card(monkeypatch, runner) as on_card:
        for nb in range(1, 21):  # every width, not the pow2 buckets: at the budget
            on_card((nb, False, False))
        assert watcher.snapshot()["programs"][trunner.DECODE_PROGRAM]["storms"] == 0
        on_card((1, True, False))  # another variant: its own count
        for nb in (21, 22, 23, 21):  # past the budget: each new key a storm
            on_card((nb, False, False))
        st = watcher.snapshot()["programs"][trunner.DECODE_PROGRAM]
        assert st["compiles"] == 24 and st["storms"] == 3
        # a second engine's runner capturing its own graphs is warmup
        second = _runner()
    with _stand_in_card(monkeypatch, second) as on_card:
        for nb in (1, 2, 4, 8):
            on_card((nb, False, False))
    st = watcher.snapshot()["programs"][trunner.DECODE_PROGRAM]
    assert st["compiles"] == 28 and st["storms"] == 3
    assert f'dynamo_tpu_runtime_recompile_storms_total{{program="{trunner.DECODE_PROGRAM}"}} 3' \
        in watcher.registry.render()
