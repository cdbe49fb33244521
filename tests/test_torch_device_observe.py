"""The port's device plane (runtime/device_observe.py) against the JAX
package's: the metric names letter for letter; ``tree_device_bytes`` over
the storage tensors hold (a sink pool counts its spare block, a view its
whole allocation, a storage once); ``device_memory_stats()`` on the CPU in
JAX's shape; ``HbmLedger`` snapshots, peak and rendered families equal to
JAX's for the same samplers; ``ProfilerControl`` on the CPU: a capture
writes a Chrome trace, a second start is refused while one runs, the
generation and the capture count, the family equal to JAX's, a stop that
lets other threads run and runs inside its hold (an engine's
``device_held``, which parks the device thread); on a host
with two cards, the memory of the engine's card alone; and the engine's
HBM ledger over the runner's live tensors, read from the runner's
device."""

import asyncio
import contextlib
import json
import os
import tempfile
import threading
import time
import types

import pytest
import torch

from dynamo_tpu.runtime import device_observe as jdo
from dynamo_tpu.runtime import metric_names as jmn
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.ops.attention import sink_pool_tensor
from dynamo_tpu_torch.runtime import device_observe as tdo
from dynamo_tpu_torch.runtime import metric_names as tmn


def test_metric_names_are_jax_letter_for_letter():
    names = {k: v for k, v in vars(tmn).items() if k.isupper()}
    assert {"RUNTIME_HBM_BYTES", "RUNTIME_HBM_DEVICE_BYTES",
            "RUNTIME_PROFILER_CAPTURES_TOTAL", "ENGINE_PREFIX"} <= set(names)
    for k, v in names.items():
        assert getattr(jmn, k) == v, k
    assert tmn.engine_gauge("kv_usage") == jmn.engine_gauge("kv_usage")


def test_tree_device_bytes_counts_each_storage_once_and_whole():
    pool = sink_pool_tensor((6, 4, 2, 8), torch.bfloat16, torch.device("cpu"))
    assert pool.shape[0] == 6 and pool.nbytes == 6 * 4 * 2 * 8 * 2
    assert tdo.tree_device_bytes(pool) == 7 * 4 * 2 * 8 * 2  # the sink block too
    assert tdo.tree_device_bytes([pool, pool.sink_full, pool[1:3]]) == 7 * 4 * 2 * 8 * 2
    int8_pool = {"q8": sink_pool_tensor((6, 4, 2, 8), torch.int8, torch.device("cpu")),
                 "s": sink_pool_tensor((6, 2, 4), torch.float32, torch.device("cpu"))}
    assert tdo.tree_device_bytes(int8_pool) == 7 * 64 + 7 * 8 * 4
    a, b = torch.zeros(3, dtype=torch.int64), torch.ones(5, dtype=torch.float32)
    assert tdo.tree_device_bytes({"x": (a, [b, None]), "y": 3, "z": "s"}) == 24 + 20
    assert tdo.tree_device_bytes(None) == 0 == tdo.tree_device_bytes([])


def test_device_memory_stats_on_the_cpu_have_jaxs_shape():
    mine, theirs = tdo.device_memory_stats(), jdo.device_memory_stats()
    assert mine == [{"id": 0, "platform": "cpu", "memory_stats": None}]
    assert theirs and all(d.keys() == mine[0].keys() for d in theirs)
    assert {(d["platform"], d["memory_stats"]) for d in theirs} == {("cpu", None)}


def test_hbm_ledger_equals_jaxs_for_the_same_samplers():
    size = {"v": 100}
    ledgers = (jdo.HbmLedger(), tdo.HbmLedger())
    for ledger in ledgers:
        ledger.register("kv_cache", lambda: size["v"])
        ledger.register("params", lambda: 7)
        ledger.register("broken", lambda: 1 // 0)
    for v in (100, 300, 50):
        size["v"] = v
        snaps = [ledger.snapshot() for ledger in ledgers]
        assert snaps[0] == snaps[1] == {"kv_cache": v, "params": 7, "broken": -1}
    assert ledgers[0].peak_bytes == ledgers[1].peak_bytes == 307
    assert ledgers[0].total_bytes() == ledgers[1].total_bytes() == 57
    for om in (False, True):
        assert (ledgers[1].registry.render(openmetrics=om)
                == ledgers[0].registry.render(openmetrics=om))


def test_profiler_control_captures_a_chrome_trace_on_the_cpu(tmp_path, monkeypatch):
    prof = tdo.ProfilerControl()
    assert prof.status() == {"active": False, "dir": None, "captures": 0, "generation": 0}
    assert prof.stop().result() == {"ok": False, "error": "no active capture"}
    for n, device in ((1, None), (2, torch.device("cpu"))):
        d = str(tmp_path / f"cap{n}")
        started = prof.start(d, device).result()
        assert started == {"ok": True, "dir": d, "generation": n, "activities": ["CPU"]}
        again = prof.start(str(tmp_path / "other")).result()
        assert again == {"ok": False, "error": "capture already active", "dir": d}
        assert prof.status() == {"active": True, "dir": d, "captures": n - 1, "generation": n}
        # a CPU capture records the CPU ops of the profiler's own thread
        prof._thread.submit(torch.mm, torch.ones(64, 64), torch.ones(64, 64)).result()
        stopped = prof.stop().result()
        assert stopped["ok"] and stopped["dir"] == d and stopped["duration_s"] >= 0
        assert stopped["trace"] == os.path.join(d, tdo.TRACE_FILE)
        with open(stopped["trace"]) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert "aten::mm" in names
    assert prof.status() == {"active": False, "dir": None, "captures": 2, "generation": 2}
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    fresh = prof.start().result()  # a directory of its own
    assert fresh["ok"] and os.path.isdir(fresh["dir"]) and fresh["dir"].startswith(str(tmp_path))
    assert prof.stop().result()["ok"]
    assert not torch.autograd.profiler._is_profiler_enabled
    jprof = jdo.ProfilerControl()
    jprof.captures = 3
    assert prof.registry.render() == jprof.registry.render()
    # the process-global runtime families: the compile watcher's, then this one
    parts = (tdo.global_compile_watcher().registry.render(), tdo.global_profiler().registry.render())
    assert tdo.render_runtime_metrics() == "\n".join(p for p in parts if p)


def test_a_profiler_that_fails_to_start_raises_and_stays_idle(monkeypatch, tmp_path):
    def broken(config, activities):
        raise RuntimeError("CUPTI is busy")

    monkeypatch.setattr(torch.autograd.profiler, "_enable_profiler", broken)
    prof = tdo.ProfilerControl()
    with pytest.raises(RuntimeError, match="CUPTI"):
        prof.start(str(tmp_path)).result()
    assert prof.status() == {"active": False, "dir": None, "captures": 0, "generation": 0}
    assert not torch.autograd.profiler._is_profiler_enabled


def test_a_stop_leaves_the_gil_to_the_other_threads(tmp_path):
    """A stop turns every record into a trace event, without the GIL: a
    thread that wakes each millisecond keeps waking while it runs."""
    gaps, done = [], threading.Event()

    def tick():
        last = time.perf_counter()
        while not done.is_set():
            time.sleep(0.001)
            now = time.perf_counter()
            gaps.append(now - last)
            last = now

    prof = tdo.ProfilerControl()
    prof.start(str(tmp_path)).result()
    x = torch.ones(4)

    def work():
        for _ in range(30_000):
            x.add_(1)

    prof._thread.submit(work).result()
    ticker = threading.Thread(target=tick)
    ticker.start()
    try:
        time.sleep(0.05)
        gaps.clear()
        t0 = time.perf_counter()
        stopped = prof.stop().result()
        stop_s = time.perf_counter() - t0
    finally:
        done.set()
        ticker.join()
    with open(stopped["trace"]) as f:
        adds = sum(1 for e in json.load(f)["traceEvents"] if e.get("name") == "aten::add_")
    assert adds == 30_000
    assert max(gaps) < stop_s / 2, (max(gaps), stop_s)


def test_a_stop_runs_inside_its_hold(tmp_path):
    seen = []

    @contextlib.contextmanager
    def hold():
        seen.append(("enter", torch.autograd.profiler._is_profiler_enabled))
        yield
        seen.append(("exit", os.path.exists(tmp_path / tdo.TRACE_FILE)))

    prof = tdo.ProfilerControl()
    prof.start(str(tmp_path)).result()
    assert prof.stop(hold).result()["ok"]
    assert seen == [("enter", True), ("exit", True)]


async def test_device_held_parks_the_engines_device_thread():
    engine = TorchEngine(TorchEngineArgs(config=tconfig.tiny_config(), device="cpu",
                                         cuda_graphs=False, num_kv_blocks=8))
    with engine.device_held():
        queued = asyncio.ensure_future(engine._device(lambda: "ran"))
        await asyncio.sleep(0.1)
        assert not queued.done()
    assert await asyncio.wait_for(queued, 5) == "ran"
    await engine.stop()
    with engine.device_held():  # a stopped engine has nothing to park
        pass


@pytest.fixture
def two_cards(monkeypatch):
    """torch.cuda as a host with two cards shows it, card i with
    (i + 1) KB allocated: no card is touched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 1000 * (i + 1), "allocated_bytes.all.peak": 3000 * (i + 1)})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(total_memory=80 * 10**9))


def test_memory_stats_read_the_engines_card_only(two_cards):
    def entry(i):
        return [{"id": i, "platform": "gpu", "memory_stats": {
            "bytes_in_use": 1000 * (i + 1), "peak_bytes_in_use": 3000 * (i + 1),
            "bytes_limit": 80 * 10**9}}]

    assert tdo.device_memory_stats(torch.device("cuda", 1)) == entry(1)
    assert tdo.device_memory_stats("cuda") == entry(0)  # the current card
    cpu = [{"id": 0, "platform": "cpu", "memory_stats": None}]
    assert tdo.device_memory_stats() == cpu == tdo.device_memory_stats(torch.device("cpu"))
    ledger = tdo.HbmLedger(torch.device("cuda", 1))
    ledger.register("params", lambda: 500)
    text = ledger.registry.render()
    assert 'device="1",kind="bytes_in_use"} 2000' in text and 'device="0"' not in text
    assert "hbm_device_bytes{" not in tdo.HbmLedger(torch.device("cpu")).registry.render()


def test_engine_ledger_samples_the_runners_live_tensors():
    cfg = tconfig.tiny_config()
    engine = TorchEngine(TorchEngineArgs(config=cfg, device="cpu", cuda_graphs=False,
                                         block_size=4, num_kv_blocks=32, max_num_seqs=4,
                                         max_model_len=64, prefill_chunk=16, decode_steps=4))
    runner = engine.runner
    block = 4 * cfg.n_kv_heads * cfg.head_dim_ * cfg.dtype.itemsize
    snap = engine.hbm.snapshot()
    assert engine.hbm.device == runner.device == torch.device("cpu")
    assert list(snap) == ["kv_cache", "params", "slot_state", "slot_tables", "lora",
                          "proc_state"]
    assert snap["kv_cache"] == 2 * cfg.n_layers * 33 * block
    assert snap["params"] == sum(t.nbytes for t in _tensors(runner.params))
    assert snap["slot_tables"] == runner.slot_state["tables"].nbytes
    assert snap["slot_state"] == sum(t.nbytes for k, t in runner.slot_state.items()
                                     if k != "tables")
    assert snap["lora"] == 0 and snap["proc_state"] == 0
    runner.ensure_proc_state()
    assert engine.hbm.snapshot()["proc_state"] == 4 * cfg.vocab_size * (4 + 1)
    detail = engine.kv_pool_bytes_breakdown()
    per_pool_block = 2 * cfg.n_layers * block
    assert detail == {"active_bytes": 0, "cached_bytes": 0, "free_bytes": 32 * per_pool_block,
                      "sink_bytes": per_pool_block, "total_bytes": snap["kv_cache"]}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
