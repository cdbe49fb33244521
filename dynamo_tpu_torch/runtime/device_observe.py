"""Device plane — the port's copy of the parts of
dynamo_tpu/runtime/device_observe.py that the system server serves:

  0. compile telemetry (``CompileWatcher``, ``/debug/compiles`` and the
     ``RUNTIME_COMPILE*`` families): the port compiles nothing with a JIT,
     so a compile is a CUDA graph capture of a decode burst, at the
     runner's one capture site (engines/gpu/runner.py). A program name
     holds the stats of its captures (JAX's ``runner.decode_state``); each
     capturing object (``WatchedCapture``, one a runner and burst variant,
     as JAX has one jit object a variant) counts its distinct graph keys
     against a signature budget, and crossing it counts a recompile storm
     as JAX's watcher does. Prefill runs eagerly, so no prefill program
     appears;
  1. the flight recorder (``FlightRecorder``), the typed event ring that
     the overload, trajectory, crash and parser planes keep;
  2. the HBM ledger (``HbmLedger``): structural byte accounting a category
     (KV pools, params, slot state and tables, processor state), sampled
     from the engine's live tensors at scrape time and set beside the CUDA
     caching allocator's own count (``device_memory_stats``). A tensor
     counts the storage it holds (``tree_device_bytes``), so a KV pool made
     by ops/attention.sink_pool_tensor counts its sink block;
  3. profiler control (``ProfilerControl``): ``POST /debug/profile`` starts
     and stops a ``torch.profiler`` capture that writes a Chrome trace. It
     records CUDA activity when the engine's device is a card, CPU activity
     (its own thread's) else. A start or stop that fails is an error, where
     JAX's degrades to a no-op: a profile that silently leaves out the
     device would hide it.

Both read the engine's one device, never every card the process can see.

Nothing here synchronises the device or copies a tensor to the host: the
samplers read shapes, storages and the allocator's counters.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import tempfile
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, ContextManager, Dict, List, Optional, Tuple

from dynamo_tpu_torch.runtime import metric_names as mn
from dynamo_tpu_torch.runtime.metrics_core import Histogram, MetricsRegistry
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Capture wall-times span ~10 ms (a small burst) to tens of seconds (a
# graph of many thousand kernels on a loaded card): JAX's compile buckets.
COMPILE_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    120.0, 300.0,
)

# Default per-object distinct-signature budget for capture sites without an
# explicit one (JAX's).
DEFAULT_SIGNATURE_BUDGET = 256


class _ProgramStats:
    """Aggregated per-NAME compile stats. Several capturing objects may
    share a name (the runner keeps one a burst variant, and a process may
    build several engines); totals aggregate, while the storm budget is
    judged per WatchedCapture — a fresh engine capturing its own graphs is
    warmup, not a storm."""

    __slots__ = (
        "name", "compiles", "signatures", "storms", "compile_seconds",
        "last_compile_seconds", "budget", "_hist",
    )

    def __init__(self, name: str, hist: Histogram) -> None:
        self.name = name
        self.compiles = 0
        self.signatures = 0
        self.storms = 0
        self.compile_seconds = 0.0
        self.last_compile_seconds = 0.0
        self.budget: Optional[int] = None
        self._hist = hist

    def on_compile(self, n: int, dt: float) -> None:
        self.compiles += n
        self.signatures += n
        self.compile_seconds += dt
        self.last_compile_seconds = dt
        # Histogram takes its lock — fine: captures are rare by definition
        # (a site that captures on the hot path is the storm we detect).
        self._hist.observe(dt, program=self.name)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "compiles": self.compiles,
            "signatures": self.signatures,
            "storms": self.storms,
            "compile_seconds": round(self.compile_seconds, 4),
            "last_compile_seconds": round(self.last_compile_seconds, 4),
            "budget": self.budget,
        }


class WatchedCapture:
    """The counterpart of JAX's ``WatchedJit`` for one capturing object:
    ``captured(key, seconds)`` after each CUDA graph capture, with the
    graph's key and the capture's wall time. A key this object already
    captured counts nothing (JAX's fallback signature set); a new one is a
    compile of the program, and past the budget a recompile storm."""

    __slots__ = ("_stats", "_seen", "_budget")

    def __init__(self, stats: _ProgramStats, budget: Optional[int] = None) -> None:
        self._stats = stats
        self._seen: set = set()  # distinct keys THIS object captured
        self._budget = budget

    @property
    def signatures(self) -> int:
        return len(self._seen)

    def captured(self, key: Any, seconds: float) -> None:
        if key in self._seen:
            return
        self._seen.add(key)
        st = self._stats
        st.on_compile(1, seconds)
        budget = self._budget if self._budget is not None else st.budget
        if budget is None:
            budget = DEFAULT_SIGNATURE_BUDGET
        if len(self._seen) > budget:
            st.storms += 1
            logger.warning(
                "recompile storm: program %r has captured %d distinct "
                "graphs (budget %d) — dispatched shapes are not bucketing; "
                "every new key pays a capture on the serving path",
                st.name, len(self._seen), budget,
            )


class CompileWatcher:
    """Per-process compile-telemetry registry (program name → stats).

    Metrics mirror the plain counters at render time (``on_render``), so
    capture-path increments are lock-free attribute bumps under the GIL.
    The histogram writes its bucket bounds as JAX's kit does.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry or MetricsRegistry(kit_le=True)
        self._lock = threading.Lock()  # program-creation only, never hot
        self._programs: Dict[str, _ProgramStats] = {}
        self._hist = self.registry.histogram(
            mn.RUNTIME_COMPILE_SECONDS,
            "Wall time of each CUDA graph capture of a new program "
            "signature (a decode burst's graph key)",
            ["program"],
            buckets=COMPILE_BUCKETS,
        )
        self._compiles = self.registry.counter(
            mn.RUNTIME_COMPILES_TOTAL,
            "CUDA graph captures observed per watched program site",
            ["program"],
        )
        self._signatures = self.registry.gauge(
            mn.RUNTIME_COMPILE_SIGNATURES,
            "Distinct captured signatures (graph keys) per watched program site",
            ["program"],
        )
        self._storms = self.registry.counter(
            mn.RUNTIME_RECOMPILE_STORMS_TOTAL,
            "Signature-budget violations (a capturing object capturing more "
            "distinct graph keys than its width-bucketing budget allows)",
            ["program"],
        )
        self.registry.on_render(self._refresh)

    def _refresh(self) -> None:
        for name, st in list(self._programs.items()):
            self._compiles.set_total(st.compiles, program=name)
            self._signatures.set(st.signatures, program=name)
            self._storms.set_total(st.storms, program=name)

    def program(self, name: str) -> _ProgramStats:
        st = self._programs.get(name)
        if st is None:
            with self._lock:
                st = self._programs.get(name)
                if st is None:
                    st = _ProgramStats(name, self._hist)
                    self._programs[name] = st
        return st

    def set_budget(self, name: str, budget: Optional[int]) -> None:
        """Default per-object signature budget for every WatchedCapture
        that shares ``name`` and didn't set its own."""
        self.program(name).budget = budget

    def snapshot(self) -> Dict[str, Any]:
        # Materialize the shared dict in one C-level call before touching
        # Python code: writer threads may insert new programs mid-scrape.
        programs = {
            name: st.to_dict()
            for name, st in sorted(list(self._programs.items()))
        }
        return {"programs": programs, "totals": self.totals()}

    def totals(self) -> Dict[str, Any]:
        stats = list(self._programs.values())
        return {
            "programs": len(stats),
            "compiles": sum(s.compiles for s in stats),
            "signatures": sum(s.signatures for s in stats),
            "storms": sum(s.storms for s in stats),
            "compile_seconds": round(sum(s.compile_seconds for s in stats), 4),
        }


def watched_capture(
    name: str,
    *,
    budget: Optional[int] = None,
    watcher: Optional[CompileWatcher] = None,
) -> WatchedCapture:
    """A capturing object whose captures count under ``name``. ``budget``:
    its distinct-key budget (None = the watcher's per-name default, which
    itself defaults to DEFAULT_SIGNATURE_BUDGET)."""
    w = watcher if watcher is not None else global_compile_watcher()
    return WatchedCapture(w.program(name), budget)


class FlightRecorder:
    """Preallocated single-writer ring of typed events.

    Contract: ``record`` is called from EXACTLY ONE thread per recorder;
    readers (``snapshot``) may run on any thread and tolerate a
    concurrently advancing write index — a torn read can at worst miss or
    double-see the newest event, never corrupt the ring. Append is an
    index store + tuple build: O(1), no locks, no list growth."""

    def __init__(self, name: str, capacity: int = 2048) -> None:
        self.name = name
        self.capacity = int(capacity)
        self._ring: List[Optional[Tuple[float, str, Optional[dict]]]] = (
            [None] * self.capacity
        )
        self._n = 0  # total events ever recorded (monotonic)
        self.counts: Dict[str, int] = {}
        self.registry = MetricsRegistry()
        self._events = self.registry.counter(
            mn.RUNTIME_FLIGHT_EVENTS_TOTAL,
            "Flight-recorder events per ring and kind",
            ["ring", "kind"],
        )
        self._overwritten = self.registry.counter(
            mn.RUNTIME_FLIGHT_OVERWRITTEN_TOTAL,
            "Flight-recorder events overwritten by ring wrap (history "
            "older than the ring capacity is gone)",
            ["ring"],
        )
        self.registry.on_render(self._refresh)

    def record(self, kind: str, **fields: Any) -> None:
        i = self._n
        self._ring[i % self.capacity] = (
            time.monotonic(), kind, fields or None
        )
        self._n = i + 1
        self.counts[kind] = self.counts.get(kind, 0) + 1

    @property
    def overwritten(self) -> int:
        return max(0, self._n - self.capacity)

    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Events oldest→newest as dicts (``seq`` is the global event
        index, ``t_mono`` the monotonic timestamp)."""
        n = self._n
        start = max(0, n - self.capacity)
        if limit is not None:
            start = max(start, n - int(limit))
        out: List[Dict[str, Any]] = []
        for i in range(start, n):
            ev = self._ring[i % self.capacity]
            if ev is None:
                continue
            ts, kind, fields = ev
            d: Dict[str, Any] = {
                "seq": i, "t_mono": round(ts, 6), "ring": self.name,
                "kind": kind,
            }
            if fields:
                d.update(fields)
            out.append(d)
        return out

    def _refresh(self) -> None:
        for kind, count in list(self.counts.items()):
            self._events.set_total(count, ring=self.name, kind=kind)
        self._overwritten.set_total(self.overwritten, ring=self.name)


# ---------------------------------------------------------------------------
# HBM ledger
# ---------------------------------------------------------------------------


def tree_device_bytes(tree: Any) -> int:
    """Bytes of the storages that the tensors in ``tree`` (nested dicts,
    lists and tuples) hold, each storage counted once and whole: a view
    counts the allocation it lives in. None and other leaves count 0."""
    import torch

    seen = set()
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            storage = x.untyped_storage()
            key = (str(storage.device), storage.data_ptr())
            if key not in seen:
                seen.add(key)
                total += storage.nbytes()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return total


def device_memory_stats(device: Any = None) -> List[Dict[str, Any]]:
    """The entry of ``device`` (a worker's engine's; None, a process that
    serves none, is the CPU), with JAX's ``memory_stats`` keys from the
    CUDA caching allocator: ``bytes_in_use`` (allocated now),
    ``peak_bytes_in_use`` and ``bytes_limit`` (the device's memory). The CPU
    gets one ``cpu`` entry whose ``memory_stats`` is None, as JAX's CPU
    client reports. Only that device is read: the process's other cards
    are not its engine's, and the CPU's process never starts CUDA here."""
    import torch

    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return [{"id": 0, "platform": "cpu", "memory_stats": None}]
    i = torch.cuda.current_device() if device.index is None else device.index
    stats = torch.cuda.memory_stats(i)
    return [{"id": i, "platform": "gpu", "memory_stats": {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
    }}]


class HbmLedger:
    """Structural device-memory accounting: category → byte-count sampler.

    Samplers run at snapshot/scrape time only and read live object
    references — a category whose sampler throws reports -1 (visible as
    "unknown" rather than silently zero). The ledger also tracks the peak
    total it has ever observed. ``device`` is the engine's, whose allocator
    the device gauge reads (None: the CPU, which has no such count)."""

    def __init__(self, device: Any = None) -> None:
        self.device = device
        self._sources: Dict[str, Callable[[], int]] = {}
        self.peak_bytes = 0
        self.registry = MetricsRegistry()
        self._gauge = self.registry.gauge(
            mn.RUNTIME_HBM_BYTES,
            "Structural device-memory bytes per ledger category "
            "(sampled from live engine state at scrape time)",
            ["category"],
        )
        self._device_gauge = self.registry.gauge(
            mn.RUNTIME_HBM_DEVICE_BYTES,
            "Backend-reported device memory (device.memory_stats(), "
            "absent on backends that do not provide it)",
            ["device", "kind"],
        )
        self.registry.on_render(self._refresh)

    def register(self, category: str, fn: Callable[[], int]) -> None:
        self._sources[category] = fn

    def snapshot(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for category, fn in list(self._sources.items()):
            try:
                out[category] = int(fn())
            except Exception:
                out[category] = -1
        total = sum(v for v in out.values() if v > 0)
        if total > self.peak_bytes:
            self.peak_bytes = total
        return out

    def total_bytes(self) -> int:
        return sum(v for v in self.snapshot().values() if v > 0)

    def _refresh(self) -> None:
        for category, nbytes in self.snapshot().items():
            self._gauge.set(nbytes, category=category)
        for dev in device_memory_stats(self.device):
            stats = dev.get("memory_stats")
            if not stats:
                continue
            for kind in ("bytes_in_use", "bytes_limit", "peak_bytes_in_use"):
                if kind in stats:
                    self._device_gauge.set(
                        stats[kind], device=str(dev.get("id")), kind=kind
                    )


# ---------------------------------------------------------------------------
# On-demand profiler capture
# ---------------------------------------------------------------------------

TRACE_FILE = "trace.json"  # the Chrome trace a capture writes into its directory


class ProfilerControl:
    """Start/stop ``torch.profiler`` captures on demand (POST
    /debug/profile), with JAX's state machine: one capture at a time, a
    generation bumped at each start (so a bounded capture's auto-stop can
    tell its own capture from a newer one), and the count of completed
    captures. A stop writes the capture's Chrome trace to ``TRACE_FILE`` in
    its directory. A profiler that fails to start or stop raises.

    Each start and stop runs whole on this object's one thread, in the
    order asked, so the state needs no lock: ``start`` and ``stop`` return
    that thread's future (a server awaits it off its event loop, a script
    takes ``.result()``). The session belongs to that thread: a process's
    first start on the card (CUPTI's set-up) takes seconds. A capture
    records CUDA activity, the whole process's, when ``device`` is a CUDA
    device, and else the CPU activity of that thread.

    The stop runs in C++ without the GIL (``csrc/profiler_stop.cpp``, built
    at the first start): it turns every record into a trace event, some
    30 µs a record on the card, so seconds for a capture of a loaded
    worker, and ``torch.profiler``'s stop holds the GIL for all of it,
    which stalls the worker's event loop and its load reports. Without the
    GIL the stop can deadlock with a CUDA graph launch on another thread
    (on an H100: the engine's replay and the stop, both stuck for
    minutes), so a server stops inside the engine's ``device_held``: its
    streams pause for the stop, its event loop does not."""

    def __init__(self) -> None:
        self._thread = ThreadPoolExecutor(1, thread_name_prefix="profiler")
        self._active_dir: Optional[str] = None
        self._t_start = 0.0
        self.captures = 0
        self.generation = 0
        self.registry = MetricsRegistry()
        self._captures_metric = self.registry.counter(
            mn.RUNTIME_PROFILER_CAPTURES_TOTAL,
            # JAX's help text, letter for letter: scrapers compare families
            "Completed on-demand jax.profiler captures",
        )
        self.registry.on_render(
            lambda: self._captures_metric.set_total(self.captures)
        )

    def status(self) -> Dict[str, Any]:
        return {
            "active": self._active_dir is not None,
            "dir": self._active_dir,
            "captures": self.captures,
            "generation": self.generation,
        }

    def start(self, log_dir: Optional[str] = None, device: Any = None) -> "Future[Dict[str, Any]]":
        return self._thread.submit(self._start, log_dir, device)

    def stop(self, hold: Optional[Callable[[], ContextManager[Any]]] = None
             ) -> "Future[Dict[str, Any]]":
        """``hold()`` is entered around the stop: an engine's
        ``device_held``, so that no launch of its meets the stop."""
        return self._thread.submit(self._stop, hold)

    def _start(self, log_dir: Optional[str], device: Any) -> Dict[str, Any]:
        if self._active_dir is not None:
            return {"ok": False, "error": "capture already active", "dir": self._active_dir}
        import torch
        from torch.autograd import profiler as autograd_profiler
        from torch.profiler import ProfilerActivity

        _stop_library()  # built first: a capture must be stoppable
        cuda = device is not None and torch.device(device).type == "cuda"
        activities = {ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU}
        # Hyphenated prefix: the metric-name lint greps for
        # dynamo_tpu_* snake literals.
        log_dir = log_dir or tempfile.mkdtemp(prefix="dynamo-tpu-profile-")
        os.makedirs(log_dir, exist_ok=True)
        config = autograd_profiler.ProfilerConfig(
            autograd_profiler.ProfilerState.KINETO, False, False, False, False, False,
            torch._C._profiler._ExperimentalConfig())
        autograd_profiler._prepare_profiler(config, activities)
        autograd_profiler._run_on_profiler_start()
        try:
            autograd_profiler._enable_profiler(config, activities)
        except BaseException:
            autograd_profiler._run_on_profiler_stop()
            raise
        self._active_dir = log_dir
        self._t_start = time.monotonic()
        self.generation += 1
        return {"ok": True, "dir": log_dir, "generation": self.generation,
                "activities": [a.name for a in activities]}

    def _stop(self, hold: Optional[Callable[[], ContextManager[Any]]]) -> Dict[str, Any]:
        if self._active_dir is None:
            return {"ok": False, "error": "no active capture"}
        from torch.autograd import profiler as autograd_profiler

        log_dir = self._active_dir
        duration = time.monotonic() - self._t_start
        trace = os.path.join(log_dir, TRACE_FILE)
        # Active until the trace is written (a reader of status() then
        # finds it); over whatever happens, so that a failed stop or
        # export does not wedge start().
        try:
            error = ctypes.create_string_buffer(1024)
            try:
                with hold() if hold is not None else contextlib.nullcontext():
                    failed = _stop_library().profiler_stop_and_save(
                        trace.encode(), error, len(error))
            finally:
                autograd_profiler._run_on_profiler_stop()
            if failed:
                raise RuntimeError(f"profiler stop failed: {error.value.decode(errors='replace')}")
            self.captures += 1
        finally:
            self._active_dir = None
        return {"ok": True, "dir": log_dir, "duration_s": round(duration, 3), "trace": trace}


def _stop_library() -> Any:
    from dynamo_tpu_torch.ops.cuda import build

    lib = build.build_host(Path(__file__).parent / "csrc" / "profiler_stop.cpp")
    lib.profiler_stop_and_save.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.profiler_stop_and_save.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Process globals (mirrors lifecycle.global_lifecycle / tracing.global_tracer)
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_WATCHER: Optional[CompileWatcher] = None
_PROFILER: Optional[ProfilerControl] = None


def global_compile_watcher() -> CompileWatcher:
    """Process-global compile telemetry (one watcher sees every runner's
    captures)."""
    global _WATCHER
    with _LOCK:
        if _WATCHER is None:
            _WATCHER = CompileWatcher()
        return _WATCHER


def global_profiler() -> ProfilerControl:
    global _PROFILER
    with _LOCK:
        if _PROFILER is None:
            _PROFILER = ProfilerControl()
        return _PROFILER


def render_runtime_metrics(openmetrics: bool = False) -> str:
    """Prometheus text for the process-global runtime families (compile
    watcher + profiler). Registered on every SystemStatusServer."""
    parts = [
        global_compile_watcher().registry.render(openmetrics=openmetrics),
        global_profiler().registry.render(openmetrics=openmetrics),
    ]
    return "\n".join(p for p in parts if p)
