"""The engine's step metrics (engines/metrics.py) and the perf ledger's
feed from ``TorchEngine``, against the JAX package's:

  - ``EngineStepMetrics`` fed the same observations renders JAX's
    exposition byte for byte (text and OpenMetrics), with JAX's host-gap
    totals;
  - ``TorchEngine(device="cpu", cuda_graphs=False, pipeline_depth=2)`` and
    ``JaxEngine(pipeline_depth=2)`` serving the same greedy requests on the
    same weights (prefix hits; a pool small enough to preempt; logprobs)
    observe the same decode bursts and prefill rounds: equal counts, equal
    summed tokens, equal occupancy, token and in-flight-depth histograms
    (byte for byte: they hold counts, not times) and equal host-gap
    observation counts; each package's perf ledger holds the same shapes
    (width, variant, path) with the same sample counts and the same prefill
    chunk buckets, under the engine's identity (backend ``cpu`` for the
    port), with a roofline fraction on every row;
  - ``stop()`` stores the fingerprints the run earned, and a failed engine
    stores none."""

import asyncio

import numpy as np
import pytest

from dynamo_tpu.engines import metrics as jmetrics
from dynamo_tpu.runtime import perf_ledger as jperf
from dynamo_tpu_torch.engines import metrics as tmetrics
from dynamo_tpu_torch.runtime import perf_ledger as tperf
from tests.test_torch_kv_events import JAX, TORCH, _jax_engine, _one, _settle, _torch_engine, _traffic
from tests.test_torch_kv_events import weights  # noqa: F401  (the fixture)

DEADLINE_S = 120.0


def _observe(m, seed):
    rng = np.random.default_rng(seed)
    for _ in range(int(rng.integers(1, 60))):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            m.observe_prefill(float(rng.exponential(0.05)), int(rng.integers(1, 9)),
                              int(rng.integers(1, 5000)))
        elif kind == 1:
            m.observe_decode(float(rng.exponential(0.02)), int(rng.integers(1, 65)),
                             int(rng.integers(0, 600)))
        elif kind == 2:
            m.observe_host_gap(0.0 if rng.random() < 0.5 else float(rng.exponential(0.001)))
        else:
            m.observe_inflight(int(rng.integers(1, 3)))


@pytest.mark.parametrize("seed", range(5))
def test_step_metrics_render_jaxs_exposition_byte_for_byte(seed):
    mine, theirs = tmetrics.EngineStepMetrics(), jmetrics.EngineStepMetrics()
    assert mine.render() == theirs.render()  # nothing observed yet
    for m in (mine, theirs):
        _observe(m, seed)
    assert mine.render() == theirs.render()
    assert mine.render(openmetrics=True) == theirs.render(openmetrics=True)
    assert mine.host_gap_stats() == theirs.host_gap_stats()


async def _logprobs_traffic(engine, api):
    p = api.proto
    reqs = [p.PreprocessedRequest(
        token_ids=list(range(30 + i, 40 + 2 * i)), request_id=f"lp{i}",
        sampling=p.SamplingOptions(temperature=0.0, logprobs=2 if i else None),
        stop=p.StopConditions(max_tokens=6 + i)) for i in range(3)]

    async def run(req):
        async for _ in engine.generate(req, api.Context()):
            pass

    await asyncio.gather(*(run(r) for r in reqs))
    await _settle(engine)


async def _all_reaped(engine):
    """Every dispatched burst reaped and observed: the in-flight depth is
    observed once a dispatch, the decode step once a reap. (A stream ends
    at the reap that finishes it, with the next burst already dispatched;
    the engines pop that burst before its readback, so an empty in-flight
    queue alone does not say it was observed.)"""
    sm = engine.step_metrics
    for _ in range(2000):
        if sm.inflight_depth.count() == sm.step_duration.count(phase="decode"):
            return
        await asyncio.sleep(0.005)
    raise AssertionError("a dispatched burst was never reaped")


def _counts(engine):
    """The step families' deterministic content: observation counts and
    token sums, and the histograms that hold counts rendered whole."""
    sm = engine.step_metrics
    text = sm.render()
    counted = [line for line in text.splitlines() if any(
        line.startswith(f"dynamo_tpu_engine_{n}") for n in (
            "batch_occupancy", "prefill_tokens_per_step", "decode_tokens_per_step",
            "inflight_depth"))]
    return {
        "decode_steps": sm.step_duration.count(phase="decode"),
        "decode_tokens": sm.decode_tokens.snapshot_total(),
        "prefill_rounds": sm.step_duration.count(phase="prefill"),
        "prefill_tokens": sm.prefill_tokens.snapshot_total(),
        "host_gaps": sm.host_gap_stats()[0],
        "counted_families": counted,
    }


def _ledger_rows(led):
    snap = led.snapshot()
    return ({(r["width"], r["variant"], r["path"]): r["samples_total"] for r in snap["decode"]},
            {b: v["samples"] for b, v in snap["prefill"].items()})


@pytest.mark.parametrize("scenario", ["prefixes", "preemption", "logprobs"])
async def test_engines_observe_the_same_bursts_and_rounds(weights, scenario, monkeypatch):  # noqa: F811
    over = dict(max_num_seqs=2, num_kv_blocks=8, max_model_len=64) if scenario == "preemption" \
        else {}
    got = {}
    for name, make, api, perf in (("jax", _jax_engine, JAX, jperf),
                                  ("torch", _torch_engine, TORCH, tperf)):
        monkeypatch.setattr(perf, "_LEDGER", None)  # a ledger of its own
        engine = make(weights, **over)
        try:
            async with asyncio.timeout(DEADLINE_S):
                if scenario == "logprobs":
                    await _logprobs_traffic(engine, api)
                else:
                    await _traffic(engine, api, scenario)
                await _all_reaped(engine)
            got[name] = (_counts(engine), _ledger_rows(engine._perf), engine._perf.snapshot(),
                         engine.stats()["preemptions"])
        finally:
            await engine.stop()
    (jc, jrows, jsnap, jpre), (tc, trows, tsnap, tpre) = got["jax"], got["torch"]
    assert tc == jc
    assert trows == jrows
    assert tpre == jpre and (tpre > 0) == (scenario == "preemption")
    assert tc["decode_steps"] > 0 and tc["prefill_rounds"] > 0
    assert tc["decode_tokens"][1] > 0 and tc["prefill_tokens"][1] > 0
    assert tsnap["identity"]["preset"] == jsnap["identity"]["preset"] == "tiny-llama"
    assert tsnap["identity"]["backend"] == "cpu"
    assert {p for _, _, p in trows[0]} == {"fallback"}
    if scenario == "logprobs":
        assert any(v.endswith("_logprobs") for _, v, _ in trows[0])
    for row in tsnap["decode"]:
        assert row["samples"] > 0 and row["step_p50_s"] > 0
        assert 0 < row["roofline_fraction"] and row["toks_per_sec"] > 0


async def test_stop_stores_the_fingerprints_of_a_clean_run_only(weights, tmp_path,  # noqa: F811
                                                                  monkeypatch):
    path = tmp_path / "fp.json"
    monkeypatch.setenv("DYN_TPU_PERF_FINGERPRINT_PATH", str(path))
    monkeypatch.setenv("DYN_TPU_PERF_MIN_SAMPLES", "1")
    for failed in (True, False):
        monkeypatch.setattr(tperf, "_LEDGER", None)
        engine = _torch_engine(weights)
        try:
            async with asyncio.timeout(DEADLINE_S):
                await _one(engine, TORCH, list(range(5, 20)), max_tokens=12)
                await _settle(engine)
        finally:
            if failed:
                engine._failure = "RuntimeError: a failed tick"
            await engine.stop()
        assert path.exists() != failed
    import json

    doc = json.loads(path.read_text())
    assert doc["schema_version"] == tperf.FINGERPRINT_SCHEMA_VERSION
    assert doc["identity"]["backend"] == "cpu" and doc["identity"]["preset"] == "tiny-llama"
    assert doc["fingerprints"] and all(k.startswith("tiny-llama|w") for k in doc["fingerprints"])
    # the next engine's ledger loads them
    monkeypatch.setattr(tperf, "_LEDGER", None)
    engine = _torch_engine(weights)
    try:
        assert engine._perf._fingerprints_loaded == len(doc["fingerprints"])
    finally:
        await engine.stop()
