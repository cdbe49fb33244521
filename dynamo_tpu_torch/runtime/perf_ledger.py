"""Perf ledger — the port's copy of dynamo_tpu/runtime/perf_ledger.py:
always-on tick-level performance attribution and the live half of the
regression sentinel, with the same windows, verdicts, fingerprint file
(schema and keys: a file either package writes loads in the other for the
same identity) and "perf" flight ring.

* **Attribution** — rolling, TTL-pruned windows per decode shape
  ``(width bucket, program variant, path fused/fallback)`` built from
  stamps the pipelined engine already takes: step wall, host gap,
  dispatch/reap host split, tokens/s, plus prefill tokens/s per pow2
  chunk bucket from the admission loop. Quantiles are computed at READ
  time (render / ``/debug/perf``); the feed itself is deque appends and
  arithmetic only.
* **Roofline gauge** — measured tok/s divided by the pure-arithmetic
  bandwidth roofline (runtime/roofline.py, the card's constants) at the
  window's own median occupancy and context: "how far from the HBM wall
  is this shape, right now".
* **Fingerprints** — a persisted per-(model preset, width bucket,
  backend, host) steady-state record (median step time + tok/s with a
  noise band) written at clean shutdown and loaded at start. Live
  windows drifting past the band for ``anomaly_streak`` consecutive
  evaluations raise a typed anomaly: a counter
  (``PERF_ANOMALIES_TOTAL``), a "perf" flight-ring event, and a verdict
  on ``GET /debug/perf``. A corrupt or vanished fingerprint file degrades
  to cold start (counted, flight-recorded), never crashes. The port's
  backend is the engine's device type (``cuda`` on the card).

Hot-path budget: ``observe_decode`` / ``observe_prefill`` are dict
lookups + deque appends + arithmetic — no locks, no logging, no metric
updates (Counter takes a lock; gauges refresh in the registry's on_render
hook), no device read. ``PerfLedger.evaluate`` is the time-gated
boundary: it self-gates on ``eval_interval_s`` and only past the gate
touches counters and the flight ring.

Threading contract mirrors FlightRecorder: ONE writer (the engine's
scheduler loop feeds decode and prefill); readers (render,
``/debug/perf``) tolerate a concurrently advancing window — a torn read
can at worst miss the newest sample, never corrupt a deque.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from dynamo_tpu_torch import config
from dynamo_tpu_torch.runtime import fault_names as fp
from dynamo_tpu_torch.runtime import metric_names as mn
from dynamo_tpu_torch.runtime.device_observe import FlightRecorder
from dynamo_tpu_torch.runtime.faults import fault_point
from dynamo_tpu_torch.runtime.metrics_core import MetricsRegistry

logger = logging.getLogger(__name__)

FINGERPRINT_SCHEMA_VERSION = 1

# The knobs (config.py), aliased here so the ledger's call sites keep their
# local names.
PERF_WINDOW = config.PERF_WINDOW
PERF_SAMPLE_TTL_S = config.PERF_SAMPLE_TTL_S
PERF_EVAL_INTERVAL_S = config.PERF_EVAL_INTERVAL_S
PERF_NOISE_BAND = config.PERF_NOISE_BAND
PERF_MIN_SAMPLES = config.PERF_MIN_SAMPLES
PERF_FINGERPRINT_PATH = config.PERF_FINGERPRINT_PATH


class PerfLedgerConfig:
    """Knobs, env-seeded with per-test overrides."""

    def __init__(
        self,
        *,
        window: Optional[int] = None,
        sample_ttl_s: Optional[float] = None,
        eval_interval_s: Optional[float] = None,
        noise_band: Optional[float] = None,
        min_samples: Optional[int] = None,
        anomaly_streak: int = 2,
        fingerprint_path: Optional[str] = None,
    ) -> None:
        self.window = int(window if window is not None else PERF_WINDOW.get())
        self.sample_ttl_s = float(
            sample_ttl_s if sample_ttl_s is not None
            else PERF_SAMPLE_TTL_S.get()
        )
        self.eval_interval_s = float(
            eval_interval_s if eval_interval_s is not None
            else PERF_EVAL_INTERVAL_S.get()
        )
        self.noise_band = float(
            noise_band if noise_band is not None else PERF_NOISE_BAND.get()
        )
        self.min_samples = int(
            min_samples if min_samples is not None else PERF_MIN_SAMPLES.get()
        )
        self.anomaly_streak = int(anomaly_streak)
        self.fingerprint_path = (
            fingerprint_path if fingerprint_path is not None
            else PERF_FINGERPRINT_PATH.get()
        )


class RollingWindow:
    """Bounded deque of ``(t, value)`` with TTL aging. Appends are O(1)
    amortized (the TTL prune pops from the left only as far as needed);
    quantiles sort a snapshot copy at READ time, never on the feed."""

    __slots__ = ("_maxlen", "_ttl_s", "_q")

    def __init__(self, maxlen: int, ttl_s: float) -> None:
        self._maxlen = maxlen
        self._ttl_s = ttl_s
        self._q: Deque[Tuple[float, float]] = deque(maxlen=maxlen)

    def add(self, t: float, value: float) -> None:
        q = self._q
        horizon = t - self._ttl_s
        while q and q[0][0] < horizon:
            q.popleft()
        q.append((t, value))

    def prune(self, now: float) -> None:
        q = self._q
        horizon = now - self._ttl_s
        while q and q[0][0] < horizon:
            q.popleft()

    def __len__(self) -> int:
        return len(self._q)

    def values(self, now: Optional[float] = None) -> List[float]:
        """Snapshot of live values (TTL-filtered at read when ``now`` is
        given — reads must not mutate, other threads may be appending)."""
        if now is None:
            return [v for _, v in list(self._q)]
        horizon = now - self._ttl_s
        return [v for t, v in list(self._q) if t >= horizon]

    def quantile(self, q: float, now: Optional[float] = None) -> float:
        """Nearest-rank-interpolated quantile of the live samples; 0.0
        when empty (gauges render 0, verdicts gate on sample count)."""
        vals = sorted(self.values(now))
        if not vals:
            return 0.0
        if len(vals) == 1:
            return vals[0]
        pos = q * (len(vals) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac


class _ShapeWindows:
    """Per-(width, variant, path) decode attribution windows."""

    __slots__ = (
        "step", "gap", "dispatch", "reap", "toks_rate", "occupancy",
        "avg_ctx", "samples_total",
    )

    def __init__(self, window: int, ttl_s: float) -> None:
        self.step = RollingWindow(window, ttl_s)
        self.gap = RollingWindow(window, ttl_s)
        self.dispatch = RollingWindow(window, ttl_s)
        self.reap = RollingWindow(window, ttl_s)
        self.toks_rate = RollingWindow(window, ttl_s)
        self.occupancy = RollingWindow(window, ttl_s)
        self.avg_ctx = RollingWindow(window, ttl_s)
        self.samples_total = 0


class PerfMetrics:
    """The ``PERF_*`` families on a private registry.
    Gauges only refresh inside the registry's pre-scrape hook — the feed
    path never touches a metric (Counter.inc takes a lock)."""

    def __init__(self, ledger: "PerfLedger") -> None:
        self._ledger = ledger
        self.registry = MetricsRegistry()
        shape = ["width", "variant", "path"]
        self.step_p50 = self.registry.gauge(
            mn.PERF_STEP_P50_SECONDS,
            "Rolling median decode step wall time per shape",
            shape,
        )
        self.step_p99 = self.registry.gauge(
            mn.PERF_STEP_P99_SECONDS,
            "Rolling p99 decode step wall time per shape",
            shape,
        )
        self.gap_p50 = self.registry.gauge(
            mn.PERF_HOST_GAP_P50_SECONDS,
            "Rolling median host gap (device idle between bursts)",
            shape,
        )
        self.dispatch_p50 = self.registry.gauge(
            mn.PERF_DISPATCH_P50_SECONDS,
            "Rolling median dispatch-side host cost per shape",
            shape,
        )
        self.reap_p50 = self.registry.gauge(
            mn.PERF_REAP_P50_SECONDS,
            "Rolling median reap-side host cost per shape",
            shape,
        )
        self.toks = self.registry.gauge(
            mn.PERF_TOKENS_PER_SEC,
            "Rolling median decode throughput per shape",
            shape,
        )
        self.roofline = self.registry.gauge(
            mn.PERF_ROOFLINE_FRACTION,
            "Measured tok/s over the bandwidth roofline at the window's "
            "median occupancy and context (1.0 = HBM wall)",
            shape,
        )
        self.prefill_toks = self.registry.gauge(
            mn.PERF_PREFILL_TOKENS_PER_SEC,
            "Rolling median prefill throughput per pow2 chunk bucket",
            ["chunk_bucket"],
        )
        self.window_samples = self.registry.gauge(
            mn.PERF_WINDOW_SAMPLES,
            "Live samples in each shape's rolling window",
            shape,
        )
        self.anomalies = self.registry.counter(
            mn.PERF_ANOMALIES_TOTAL,
            "Typed perf anomalies raised by the sentinel "
            "(step_regression | toks_regression)",
            ["kind"],
        )
        self.fp_loaded = self.registry.gauge(
            mn.PERF_FINGERPRINT_LOADED,
            "Steady-state fingerprints loaded at startup (0 = cold start)",
        )
        self.fp_failures = self.registry.counter(
            mn.PERF_FINGERPRINT_FAILURES_TOTAL,
            "Fingerprint persistence failures by op (load | store) — "
            "each degrades to cold start, never crashes",
            ["op"],
        )
        self.registry.on_render(self._refresh)

    def _refresh(self) -> None:
        led = self._ledger
        now = led.clock()
        for (width, variant, path), sw in list(led._decode.items()):
            lab = {"width": str(width), "variant": variant, "path": path}
            self.step_p50.set(sw.step.quantile(0.50, now), **lab)
            self.step_p99.set(sw.step.quantile(0.99, now), **lab)
            self.gap_p50.set(sw.gap.quantile(0.50, now), **lab)
            self.dispatch_p50.set(sw.dispatch.quantile(0.50, now), **lab)
            self.reap_p50.set(sw.reap.quantile(0.50, now), **lab)
            toks = sw.toks_rate.quantile(0.50, now)
            self.toks.set(toks, **lab)
            self.window_samples.set(len(sw.step.values(now)), **lab)
            frac = led._roofline_fraction(sw, toks, now)
            if frac is not None:
                self.roofline.set(frac, **lab)
        for bucket, win in list(led._prefill.items()):
            self.prefill_toks.set(
                win.quantile(0.50, now), chunk_bucket=str(bucket)
            )
        self.fp_loaded.set(led._fingerprints_loaded)

    def render(self, openmetrics: bool = False) -> str:
        return self.registry.render(openmetrics=openmetrics)


class PerfLedger:
    """Process-global perf attribution + live regression sentinel.

    Owns the "perf" flight ring: every sentinel anomaly and
    fingerprint-persistence outcome is a typed ring event."""

    def __init__(
        self,
        cfg: Optional[PerfLedgerConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.cfg = cfg or PerfLedgerConfig()
        self.clock = clock
        self.flight = FlightRecorder("perf", capacity=512)
        # Decode attribution: (width, variant, path) -> windows. Plain
        # dict, single writer (the scheduler loop) — see module docstring.
        self._decode: Dict[Tuple[int, str, str], _ShapeWindows] = {}
        # Prefill attribution: pow2 chunk bucket -> tok/s window.
        self._prefill: Dict[int, RollingWindow] = {}
        # Identity (configure()): the fingerprint key's non-shape half.
        self._preset = ""
        self._backend = ""
        self._host = ""
        self._roofline_fn: Optional[Callable[[int, float], float]] = None
        # Fingerprints: key -> record (see _fingerprint_key). Loaded
        # records are the baseline; live records replace them at store.
        self._fingerprints: Dict[str, Dict[str, Any]] = {}
        self._fingerprints_loaded = 0
        # Sentinel state (evaluate() only — the time-gated boundary).
        self._t_last_eval = 0.0
        self._streaks: Dict[Tuple[str, str], int] = {}  # (key, kind) -> n
        self._verdicts: Dict[str, Dict[str, Any]] = {}
        self._anomalies_total = 0
        self.metrics = PerfMetrics(self)

    # -- identity / fingerprint I/O (startup + shutdown paths) --------------

    def configure(
        self,
        *,
        preset: str,
        backend: str,
        host: str,
        roofline_fn: Optional[Callable[[int, float], float]] = None,
    ) -> None:
        """Install the engine's identity and (optionally) a roofline
        closure (runtime/roofline.make_roofline_fn), then load any
        persisted fingerprints for it. Called once at engine start."""
        self._preset = str(preset)
        self._backend = str(backend)
        self._host = str(host)
        self._roofline_fn = roofline_fn
        self.load_fingerprints()

    def _identity(self) -> Dict[str, str]:
        return {
            "preset": self._preset,
            "backend": self._backend,
            "host": self._host,
        }

    def _fingerprint_key(self, width: int) -> str:
        # The fingerprint identity: (preset, width bucket, backend, host).
        # Variants/paths fold into the width bucket — the shape the decode
        # graph is keyed on.
        return f"{self._preset}|w{width}|{self._backend}|{self._host}"

    def load_fingerprints(self) -> int:
        """Load persisted fingerprints for the configured identity.
        Corrupt / vanished / fault-injected file -> cold start: counted,
        flight-recorded, NEVER raised."""
        path = self.cfg.fingerprint_path
        if not path:
            return 0
        try:
            fault_point(fp.PERF_FINGERPRINT_LOAD, path=path)
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            if doc.get("schema_version") != FINGERPRINT_SCHEMA_VERSION:
                raise ValueError(
                    f"fingerprint schema {doc.get('schema_version')!r} "
                    f"!= {FINGERPRINT_SCHEMA_VERSION}"
                )
            records = doc["fingerprints"]
            if not isinstance(records, dict):
                raise ValueError("fingerprints is not a mapping")
            prefix = f"{self._preset}|"
            mine = {
                k: v for k, v in records.items()
                if k.startswith(prefix)
                and k.endswith(f"|{self._backend}|{self._host}")
                and isinstance(v, dict)
            }
            self._fingerprints = mine
            self._fingerprints_loaded = len(mine)
            self.flight.record(
                "fingerprint_load", path=path, loaded=len(mine)
            )
            return len(mine)
        except FileNotFoundError:
            # First run on this box: a cold start is the expected state,
            # not a failure.
            self._fingerprints_loaded = 0
            return 0
        except Exception as e:
            self.metrics.fp_failures.inc(op="load")
            self.flight.record(
                "fingerprint_load_failed", path=path, error=repr(e)
            )
            logger.warning(
                "perf fingerprint load failed (%s); cold start", e
            )
            self._fingerprints = {}
            self._fingerprints_loaded = 0
            return 0

    def store_fingerprints(self, now: Optional[float] = None) -> int:
        """Persist steady-state fingerprints (clean shutdown only — the
        engine skips this after a failed tick so a degraded run never
        becomes the baseline). Atomic tmp+rename; failures counted and
        flight-recorded, never raised."""
        path = self.cfg.fingerprint_path
        if not path:
            return 0
        t = self.clock() if now is None else now
        fresh = dict(self._fingerprints)
        wrote = 0
        for width, sw in self._per_width(t).items():
            vals = sw.step.values(t)
            if len(vals) < self.cfg.min_samples:
                continue
            fresh[self._fingerprint_key(width)] = {
                "step_p50_s": sw.step.quantile(0.50, t),
                "toks_per_sec": sw.toks_rate.quantile(0.50, t),
                "band": self.cfg.noise_band,
                "samples": len(vals),
                "saved_at": time.time(),
            }
            wrote += 1
        if not wrote:
            return 0
        try:
            fault_point(fp.PERF_FINGERPRINT_STORE, path=path)
            doc = {
                "schema_version": FINGERPRINT_SCHEMA_VERSION,
                "identity": self._identity(),
                "fingerprints": fresh,
            }
            tmp = f"{path}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            self._fingerprints = fresh
            self.flight.record("fingerprint_store", path=path, wrote=wrote)
            return wrote
        except Exception as e:
            self.metrics.fp_failures.inc(op="store")
            self.flight.record(
                "fingerprint_store_failed", path=path, error=repr(e)
            )
            logger.warning("perf fingerprint store failed: %s", e)
            return 0

    # -- feeds (hot path: deque + arithmetic ONLY) --------------------------

    def observe_decode(
        self,
        width: int,
        variant: str,
        path: str,
        step_s: float,
        tokens: int,
        occupancy: int,
        avg_ctx: float,
        host_gap_s: float,
        dispatch_s: float,
        reap_s: float,
        now: Optional[float] = None,
    ) -> None:
        """One reaped decode burst. Called from the engine's scheduler loop."""
        t = self.clock() if now is None else now
        key = (width, variant, path)
        sw = self._decode.get(key)
        if sw is None:
            sw = _ShapeWindows(self.cfg.window, self.cfg.sample_ttl_s)
            self._decode[key] = sw
        sw.samples_total += 1
        sw.step.add(t, step_s)
        sw.gap.add(t, host_gap_s)
        sw.dispatch.add(t, dispatch_s)
        sw.reap.add(t, reap_s)
        sw.occupancy.add(t, occupancy)
        sw.avg_ctx.add(t, avg_ctx)
        if step_s > 0.0 and tokens > 0:
            sw.toks_rate.add(t, tokens / step_s)

    def observe_prefill(
        self,
        chunk_bucket: int,
        duration_s: float,
        tokens: int,
        now: Optional[float] = None,
    ) -> None:
        """One prefill chunk round (admission, the same scheduler loop)."""
        if duration_s <= 0.0 or tokens <= 0:
            return
        t = self.clock() if now is None else now
        win = self._prefill.get(chunk_bucket)
        if win is None:
            win = RollingWindow(self.cfg.window, self.cfg.sample_ttl_s)
            self._prefill[chunk_bucket] = win
        win.add(t, tokens / duration_s)

    # -- sentinel (time-gated boundary: may count and record) ----------------

    def evaluate(self, now: Optional[float] = None) -> bool:
        """Compare live per-width medians against the loaded fingerprints
        (time-gated to ``eval_interval_s``). A breach past the noise band
        must persist ``anomaly_streak`` consecutive evaluations before it
        raises — one cold tick is noise, a regime is a regression.
        Returns True when an evaluation actually ran."""
        t = self.clock() if now is None else now
        if t - self._t_last_eval < self.cfg.eval_interval_s:
            return False
        self._t_last_eval = t
        verdicts: Dict[str, Dict[str, Any]] = {}
        for width, sw in self._per_width(t).items():
            key = self._fingerprint_key(width)
            verdicts[key] = self._judge(key, width, sw, t)
        self._verdicts = verdicts
        return True

    def _judge(
        self, key: str, width: int, sw: _ShapeWindows, t: float
    ) -> Dict[str, Any]:
        n = len(sw.step.values(t))
        base = self._fingerprints.get(key)
        step_p50 = sw.step.quantile(0.50, t)
        toks = sw.toks_rate.quantile(0.50, t)
        out: Dict[str, Any] = {
            "width": width,
            "samples": n,
            "step_p50_s": step_p50,
            "toks_per_sec": toks,
            "fingerprint": base,
        }
        if n < self.cfg.min_samples:
            out["verdict"] = "insufficient"
            self._clear_streaks(key)
            return out
        if base is None:
            out["verdict"] = "no_baseline"
            self._clear_streaks(key)
            return out
        band = float(base.get("band", self.cfg.noise_band))
        breaches: List[Tuple[str, float, float, float]] = []
        improved = False
        base_step = float(base.get("step_p50_s") or 0.0)
        if base_step > 0.0 and step_p50 > 0.0:
            ratio = step_p50 / base_step
            if ratio > 1.0 + band:
                breaches.append(
                    ("step_regression", ratio, step_p50, base_step)
                )
            elif ratio < 1.0 - band:
                improved = True
        base_toks = float(base.get("toks_per_sec") or 0.0)
        if base_toks > 0.0 and toks > 0.0:
            ratio = toks / base_toks
            if ratio < 1.0 - band:
                breaches.append(("toks_regression", ratio, toks, base_toks))
            elif ratio > 1.0 + band:
                improved = True
        if not breaches:
            self._clear_streaks(key)
            out["verdict"] = "improved" if improved else "ok"
            return out
        anomalies: List[Dict[str, Any]] = []
        active_kinds = set()
        for kind, ratio, live, baseline in breaches:
            active_kinds.add(kind)
            streak = self._streaks.get((key, kind), 0) + 1
            self._streaks[(key, kind)] = streak
            if streak == self.cfg.anomaly_streak:
                # Edge-triggered page: count + ring ONCE per regime, not
                # every 5s while the regression persists.
                self._anomalies_total += 1
                self.metrics.anomalies.inc(kind=kind)
                self.flight.record(
                    "anomaly", key=key, anomaly=kind,
                    ratio=round(ratio, 4), live=live, baseline=baseline,
                )
            if streak >= self.cfg.anomaly_streak:
                anomalies.append(
                    {
                        "kind": kind,
                        "ratio": ratio,
                        "live": live,
                        "baseline": baseline,
                        "streak": streak,
                    }
                )
        for (k, kind) in list(self._streaks):
            if k == key and kind not in active_kinds:
                del self._streaks[(k, kind)]
        if anomalies:
            out["verdict"] = "regression"
            out["anomalies"] = anomalies
        else:
            # Breach seen but the streak hasn't matured: hold the page.
            out["verdict"] = "ok"
            out["pending"] = [b[0] for b in breaches]
        return out

    def _clear_streaks(self, key: str) -> None:
        for pair in [p for p in self._streaks if p[0] == key]:
            del self._streaks[pair]

    # -- aggregation helpers -------------------------------------------------

    def _per_width(self, now: float) -> Dict[int, _ShapeWindows]:
        """Merge shape windows down to the fingerprint granularity (width
        bucket): samples from every (variant, path) on that width share
        one judged window. Read-time only — bounded by window size."""
        merged: Dict[int, _ShapeWindows] = {}
        for (width, _variant, _path), sw in list(self._decode.items()):
            agg = merged.get(width)
            if agg is None:
                agg = _ShapeWindows(
                    self.cfg.window * max(1, len(self._decode)),
                    self.cfg.sample_ttl_s,
                )
                merged[width] = agg
            for attr in ("step", "gap", "dispatch", "reap", "toks_rate",
                         "occupancy", "avg_ctx"):
                src: RollingWindow = getattr(sw, attr)
                dst: RollingWindow = getattr(agg, attr)
                for t, v in list(src._q):
                    dst._q.append((t, v))
            agg.samples_total += sw.samples_total
        # Time-order the merged deques so TTL reads stay correct.
        for agg in merged.values():
            for attr in ("step", "gap", "dispatch", "reap", "toks_rate",
                         "occupancy", "avg_ctx"):
                win: RollingWindow = getattr(agg, attr)
                win._q = deque(sorted(win._q), maxlen=win._q.maxlen)
        return merged

    def _roofline_fraction(
        self, sw: _ShapeWindows, toks: float, now: float
    ) -> Optional[float]:
        fn = self._roofline_fn
        if fn is None or toks <= 0.0:
            return None
        occ = sw.occupancy.quantile(0.50, now)
        ctx = sw.avg_ctx.quantile(0.50, now)
        if occ <= 0.0:
            return None
        try:
            ceiling = fn(int(round(occ)), ctx)
        except Exception:
            return None
        if ceiling <= 0.0:
            return None
        return toks / ceiling

    # -- reads ---------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The GET /debug/perf body (also the CLI's source)."""
        now = self.clock()
        decode: List[Dict[str, Any]] = []
        for (width, variant, path), sw in sorted(self._decode.items()):
            toks = sw.toks_rate.quantile(0.50, now)
            row: Dict[str, Any] = {
                "width": width,
                "variant": variant,
                "path": path,
                "samples": len(sw.step.values(now)),
                "samples_total": sw.samples_total,
                "step_p50_s": sw.step.quantile(0.50, now),
                "step_p99_s": sw.step.quantile(0.99, now),
                "host_gap_p50_s": sw.gap.quantile(0.50, now),
                "dispatch_p50_s": sw.dispatch.quantile(0.50, now),
                "reap_p50_s": sw.reap.quantile(0.50, now),
                "toks_per_sec": toks,
                "occupancy_p50": sw.occupancy.quantile(0.50, now),
                "avg_ctx_p50": sw.avg_ctx.quantile(0.50, now),
            }
            frac = self._roofline_fraction(sw, toks, now)
            if frac is not None:
                row["roofline_fraction"] = frac
            decode.append(row)
        prefill = {
            str(bucket): {
                "samples": len(win.values(now)),
                "toks_per_sec_p50": win.quantile(0.50, now),
            }
            for bucket, win in sorted(self._prefill.items())
        }
        return {
            "identity": self._identity(),
            "decode": decode,
            "prefill": prefill,
            "fingerprints": dict(self._fingerprints),
            "fingerprints_loaded": self._fingerprints_loaded,
            "verdicts": dict(self._verdicts),
            "anomalies_total": self._anomalies_total,
            "config": {
                "window": self.cfg.window,
                "sample_ttl_s": self.cfg.sample_ttl_s,
                "eval_interval_s": self.cfg.eval_interval_s,
                "noise_band": self.cfg.noise_band,
                "min_samples": self.cfg.min_samples,
                "anomaly_streak": self.cfg.anomaly_streak,
                "fingerprint_path": self.cfg.fingerprint_path,
            },
        }

    def render(self, openmetrics: bool = False) -> str:
        return self.metrics.render(openmetrics=openmetrics)


_LEDGER: Optional[PerfLedger] = None
_LEDGER_LOCK = threading.Lock()


def global_perf_ledger() -> PerfLedger:
    """The process-global ledger (the engine feeds it; the system server
    and the CLI read it — a double-checked singleton)."""
    global _LEDGER
    if _LEDGER is None:
        with _LEDGER_LOCK:
            if _LEDGER is None:
                _LEDGER = PerfLedger()
    return _LEDGER


def render_perf_metrics(openmetrics: bool = False) -> str:
    """The PERF_* families (+ the perf flight ring's RUNTIME_FLIGHT_*
    series) for every SystemStatusServer."""
    led = global_perf_ledger()
    text = led.render(openmetrics=openmetrics)
    return text + led.flight.registry.render(openmetrics=openmetrics)


def perf_index(ledger: Optional[PerfLedger] = None) -> Dict[str, Any]:
    """The GET /debug/perf response body — ONE shape shared by the
    system server and the CLI."""
    led = ledger if ledger is not None else global_perf_ledger()
    return led.snapshot()
