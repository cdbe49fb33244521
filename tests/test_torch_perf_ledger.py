"""The port's perf ledger (runtime/perf_ledger.py) and decode roofline
(runtime/roofline.py) against the JAX package's:

  - the same observations under one injected clock into JAX's
    ``PerfLedger`` and the port's give equal ``snapshot()`` bodies (the
    identity aside; the fingerprints' ``saved_at`` and the file path
    masked), equal verdicts, anomaly counts, perf-ring events and rendered
    families (byte for byte), through a cold start (``insufficient``, then
    ``no_baseline``), a store, a start on the fingerprints the OTHER
    package wrote (``ok``, ``improved``, a breach held pending one
    evaluation, then a matured ``regression`` counted once);
  - a fingerprint file written by each package loads in the other, and the
    two files are the same document;
  - a corrupt file, a file of another schema, and each fingerprint fault
    seam give a counted, flight-recorded cold start in both packages;
  - ``RollingWindow``'s quantiles equal JAX's;
  - the roofline functions equal JAX's for every preset, with and without
    int8 weights, when both are given the same ``hbm_bw``; the port's
    default is the card's 3.35 TB/s."""

import json
import math

import numpy as np
import pytest

from dynamo_tpu.models import config as jconfig
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime import perf_ledger as jperf
from dynamo_tpu.runtime import roofline as jroof
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.runtime import faults as tfaults
from dynamo_tpu_torch.runtime import fault_names as tfn
from dynamo_tpu_torch.runtime import perf_ledger as tperf
from dynamo_tpu_torch.runtime import roofline as troof

PACKAGES = {"jax": (jperf, jroof, jconfig, jfaults), "port": (tperf, troof, tconfig, tfaults)}
IDENTITY = dict(preset="tiny-llama", backend="cuda", host="host-a")
KNOBS = dict(window=64, sample_ttl_s=5.0, eval_interval_s=1.0, noise_band=0.1, min_samples=8)
BW = 2.0e12  # the same HBM rate into both packages' roofline
SHAPES = ((4, "w4", "fallback"), (8, "w8_logprobs", "fallback"), (8, "w8", "fused"))


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _ledger(pkg, path, clock):
    perf, roof, config, _ = PACKAGES[pkg]
    led = perf.PerfLedger(perf.PerfLedgerConfig(fingerprint_path=str(path), **KNOBS), clock=clock)
    led.configure(**IDENTITY, roofline_fn=roof.make_roofline_fn(config.tiny_config(), None,
                                                                hbm_bw=BW))
    return led


def _feed(led, clock, n, step_s, shapes=SHAPES, tokens=16):
    """n bursts of each shape, 10 ms apart, around ``step_s``; and a
    prefill round of each chunk bucket a burst."""
    rng = np.random.default_rng(int(step_s * 1e6) + n)
    for i in range(n):
        clock.t += 0.01
        for width, variant, path in shapes:
            jitter = float(rng.uniform(0.98, 1.02))
            led.observe_decode(width, variant, path, step_s * jitter, tokens - i % 3,
                               occupancy=4 + i % 2, avg_ctx=100.0 + 7 * i,
                               host_gap_s=0.0 if i % 2 else 0.001 * jitter,
                               dispatch_s=0.0004 * jitter, reap_s=0.0002 * jitter)
        for bucket in (16, 32):
            led.observe_prefill(bucket, 0.002 * bucket / 16 * jitter, bucket - i % 4)
    led.observe_prefill(16, 0.0, 5)  # no time: not a sample
    led.observe_prefill(16, 0.001, 0)  # no tokens: not a sample


def _masked(obj, paths=("fingerprint_path",)):
    """``saved_at`` (a wall clock) and the fingerprint file's path masked."""
    if isinstance(obj, dict):
        return {k: "<t>" if k == "saved_at" else "<path>" if k in paths
                else _masked(v, paths) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v, paths) for v in obj]
    return obj


def _state(led):
    """What must be equal between the packages after each step."""
    snap = led.snapshot()
    snap.pop("identity")
    events = [{k: v for k, v in e.items() if k != "t_mono"} for e in led.flight.snapshot()]
    return (_masked(snap), _masked(dict(led._verdicts)), led._anomalies_total,
            _masked(events, ("path",)), led.render() + led.flight.registry.render())


class _Run:
    """One package's run: a cold start that stores its fingerprints, then
    (``warm``) a start on the fingerprints in another file. ``states`` and
    ``verdicts`` hold what each step left."""

    def __init__(self, pkg, tmp_path):
        self.pkg, self.clock = pkg, Clock()
        self.states, self.verdicts = [], []
        self.led = _ledger(pkg, tmp_path / f"{pkg}.json", self.clock)
        _feed(self.led, self.clock, 4, 0.010)
        self.evaluate()  # too few samples
        _feed(self.led, self.clock, 8, 0.010)
        self.evaluate()  # no baseline
        assert self.led.store_fingerprints() == 2
        self.states.append(_state(self.led))

    def evaluate(self):
        assert self.led.evaluate()
        assert not self.led.evaluate()  # time-gated: nothing until the interval passes
        self.states.append(_state(self.led))
        self.verdicts.append({k: v["verdict"] for k, v in sorted(self.led._verdicts.items())})
        self.clock.t += 1.1

    def warm(self, load_from):
        clock = self.clock
        clock.t += 100.0
        self.led = led = _ledger(self.pkg, load_from, clock)
        assert led._fingerprints_loaded == 2
        self.states.append(_state(led))
        _feed(led, clock, 10, 0.010)
        self.evaluate()  # the same speed: ok
        clock.t += 10.0  # past the TTL: a new regime
        _feed(led, clock, 10, 0.007)
        self.evaluate()  # faster
        clock.t += 10.0
        _feed(led, clock, 10, 0.016)
        self.evaluate()  # slower, once: held pending
        _feed(led, clock, 10, 0.016)
        self.evaluate()  # twice: a regression, counted
        _feed(led, clock, 10, 0.016)
        self.evaluate()  # still: counted once a regime
        return self.states, self.verdicts


def test_the_same_feed_gives_jaxs_snapshots_verdicts_anomalies_and_ring(tmp_path):
    # each package writes its own file first; then each starts on the other's
    jax_run, port_run = _Run("jax", tmp_path), _Run("port", tmp_path)
    jax_states, jax_verdicts = jax_run.warm(tmp_path / "port.json")
    port_states, port_verdicts = port_run.warm(tmp_path / "jax.json")
    assert port_verdicts == jax_verdicts
    assert len(port_states) == len(jax_states)
    for i, (got, want) in enumerate(zip(port_states, jax_states)):
        assert got == want, i
    seen = [v for row in port_verdicts for v in row.values()]
    for verdict in ("insufficient", "no_baseline", "ok", "improved", "regression"):
        assert verdict in seen, verdict
    snap, verdicts, anomalies, events, text = port_states[-1]
    # two kinds a width (step and tok/s), each counted once for the regime
    assert anomalies == 4
    assert [e["kind"] for e in events].count("anomaly") == 4
    assert all(v["verdict"] == "regression" for v in verdicts.values())
    assert 'dynamo_tpu_perf_anomalies_total{kind="step_regression"} 2' in text
    assert all("pending" in v for v in port_states[-3][1].values())  # the first breach
    assert {row["path"] for row in snap["decode"]} == {"fused", "fallback"}
    assert all(0 < row["roofline_fraction"] for row in snap["decode"])


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_a_fingerprint_file_written_by_one_package_loads_in_the_other(tmp_path, writer, reader):
    files = {}
    for pkg in ("jax", "port"):
        clock = Clock()
        led = _ledger(pkg, tmp_path / f"{pkg}.json", clock)
        _feed(led, clock, 12, 0.010)
        assert led.store_fingerprints() == 2
        files[pkg] = json.loads((tmp_path / f"{pkg}.json").read_text())
    assert _masked(files["port"]) == _masked(files["jax"])
    assert files["port"]["schema_version"] == jperf.FINGERPRINT_SCHEMA_VERSION
    led = _ledger(reader, tmp_path / f"{writer}.json", Clock())
    assert led._fingerprints_loaded == 2
    assert led._fingerprints == files[writer]["fingerprints"]
    # another identity's records are not this engine's baseline
    other = _ledger(reader, tmp_path / f"{writer}.json", Clock())
    other.configure(**{**IDENTITY, "host": "host-b"})
    assert other._fingerprints_loaded == 0 and other._fingerprints == {}


def _cold_start(pkg, tmp_path, case):
    """The ledger's state after a start (and for ``store``, a store) under
    ``case``; then whether the next start finds a baseline."""
    perf, roof, config, faults = PACKAGES[pkg]
    path = tmp_path / f"{pkg}-{case}.json"
    clock = Clock()
    if case in ("corrupt", "schema", "load_fault"):
        seed = _ledger(pkg, path, clock)
        _feed(seed, clock, 12, 0.010)
        assert seed.store_fingerprints() == 2
        if case == "corrupt":
            path.write_text(path.read_text()[:-40])
        elif case == "schema":
            doc = json.loads(path.read_text())
            path.write_text(json.dumps(dict(doc, schema_version=99)))
    point = {"load_fault": tfn.PERF_FINGERPRINT_LOAD,
             "store_fault": tfn.PERF_FINGERPRINT_STORE}.get(case)
    plan = faults.FaultPlan(rules=[faults.FaultRule(point=point, at=(1,), kind="error")]) \
        if point else faults.FaultPlan()
    with faults.armed(plan):
        led = _ledger(pkg, path, clock)
        _feed(led, clock, 12, 0.010)
        led.evaluate()
        stored = led.store_fingerprints()
    again = _ledger(pkg, path, clock)
    text = led.render() + led.flight.registry.render()
    return (stored, led._fingerprints_loaded, sorted(v["verdict"] for v in led._verdicts.values()),
            [e["kind"] for e in led.flight.snapshot()], text, again._fingerprints_loaded)


@pytest.mark.parametrize("case", ["corrupt", "schema", "load_fault", "store_fault"])
def test_a_bad_file_or_a_fault_seam_is_a_counted_cold_start(tmp_path, case):
    got = _cold_start("port", tmp_path, case)
    assert got == _cold_start("jax", tmp_path, case)
    stored, loaded, verdicts, kinds, text, next_loaded = got
    assert loaded == 0 and verdicts == ["no_baseline", "no_baseline"]
    op = "store" if case == "store_fault" else "load"
    assert f'dynamo_tpu_perf_fingerprint_failures_total{{op="{op}"}} 1' in text
    assert f"fingerprint_{op}_failed" in kinds
    if case == "store_fault":
        assert stored == 0 and next_loaded == 0  # the next start is cold too
    else:
        assert stored == 2 and next_loaded == 2  # a clean store repairs the file


@pytest.mark.parametrize("seed", range(4))
def test_rolling_window_quantiles_equal_jaxs(seed):
    rng = np.random.default_rng(seed)
    windows = [jperf.RollingWindow(32, 2.0), tperf.RollingWindow(32, 2.0)]
    t = 0.0
    for _ in range(int(rng.integers(0, 80))):
        t += float(rng.exponential(0.05))
        v = float(rng.normal(1.0, 0.3))
        for w in windows:
            w.add(t, v)
    for q in (0.0, 0.37, 0.5, 0.99, 1.0):
        for now in (None, t, t + 1.0, t + 3.0):
            assert windows[1].quantile(q, now) == windows[0].quantile(q, now)
            assert windows[1].values(now) == windows[0].values(now)
    assert len(windows[1]) == len(windows[0])


@pytest.mark.parametrize("preset", sorted(tconfig.all_presets()))
def test_the_roofline_equals_jaxs_for_every_preset(preset):
    tc, jc = tconfig.all_presets()[preset], jconfig.all_presets()[preset]
    assert troof.param_count(tc) == jroof.param_count(jc)
    assert troof.active_param_count(tc) == jroof.active_param_count(jc)
    for quant in (None, "int8"):
        for batch, ctx in ((1, 1.0), (16, 700.5), (64, 4096.0)):
            assert troof.decode_step_bytes(tc, batch, ctx, quant) == \
                jroof.decode_step_bytes(jc, batch, ctx, quant)
            want = jroof.decode_roofline_toks_per_sec(jc, batch, ctx, quant, hbm_bw=BW)
            assert troof.decode_roofline_toks_per_sec(tc, batch, ctx, quant, hbm_bw=BW) == want
            assert troof.make_roofline_fn(tc, quant, hbm_bw=BW)(batch, ctx) == want
            # the port's default is the card's rate
            assert math.isclose(troof.make_roofline_fn(tc, quant)(batch, ctx),
                                want * troof.H100_BW / BW, rel_tol=1e-12)
    assert troof.H100_BW == 3.35e12 and troof.H100_PEAK_BF16 == 989e12
