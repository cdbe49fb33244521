"""faultline: a process-global, seeded, deterministic fault-injection plane —
the port's copy of the parts of dynamo_tpu/runtime/faults.py that the
port's seams use (the raising kinds; the payload-corrupting seam comes with
the transports that carry payloads).

Subsystems call ``fault_point(<declared name>)`` where a real deployment
fails, and an armed :class:`FaultPlane` decides — deterministically —
whether that hit raises.

  * **Disabled is free.** ``fault_point`` is a module-global ``None`` check
    when no plane is armed — no locks, no logging, no allocation.
  * **Schedules are (seed, operation-count), never wall-clock.** A rule
    fires at the Nth hit of a point, every Nth hit, or with probability p
    drawn from a per-point ``random.Random(f"{seed}:{point}")`` stream —
    so the same plan over the same workload produces the identical
    injection trace regardless of host speed.
  * **Closed name set.** Every point name comes from
    runtime/fault_names.py; arming a plan that names an undeclared point
    fails fast.

The module also aggregates process-wide *recovery activity* counters
(``note_activity``), counted whether or not a plane is armed. The plane's
metric families come with the system server that renders them;
``activity_snapshot`` / ``plane_snapshot`` are what the overload plane's
zero-spurious-activation checks read.
"""

from __future__ import annotations

import random
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

from dynamo_tpu_torch.runtime.fault_names import ALL_FAULT_POINTS


class InjectedFault(Exception):
    """Marker mixin: every exception the plane raises derives from this,
    so tests (and post-mortems) can tell injected chaos from organic
    failures while production code still sees the native type."""


class InjectedConnectionError(InjectedFault, ConnectionError):
    pass


class InjectedTimeoutError(InjectedFault, TimeoutError):
    pass


class InjectedError(InjectedFault, RuntimeError):
    pass


_KINDS = {
    "connection": InjectedConnectionError,
    "timeout": InjectedTimeoutError,
    "error": InjectedError,
}


@dataclass(frozen=True)
class FaultRule:
    """One trigger on one point. ``at`` are 1-based hit indices; ``every``
    fires on every Nth hit; ``p`` draws per hit from the point's seeded
    stream (the draw happens on EVERY hit, fire or not, so replay stays
    aligned). ``times`` bounds total fires (None = unbounded)."""

    point: str
    at: Tuple[int, ...] = ()
    every: int = 0
    p: float = 0.0
    kind: str = "connection"
    times: Optional[int] = None

    def __post_init__(self) -> None:
        if self.point not in ALL_FAULT_POINTS:
            raise ValueError(
                f"undeclared fault point {self.point!r} — add it to "
                "runtime/fault_names.py"
            )
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (one of {sorted(_KINDS)})"
            )
        # Tolerate list specs from JSON plans.
        if not isinstance(self.at, tuple):
            object.__setattr__(self, "at", tuple(self.at))


@dataclass(frozen=True)
class FaultPlan:
    """A seed plus an ordered rule list — the full chaos schedule."""

    seed: int = 0
    rules: Tuple[FaultRule, ...] = ()

    def __post_init__(self) -> None:
        if not isinstance(self.rules, tuple):
            object.__setattr__(self, "rules", tuple(self.rules))


class FaultPlane:
    """Armed chaos: per-point hit counters + rule evaluation + the
    injection trace. ``hit`` bumps a dict counter, evaluates the (usually
    absent) rules for the point, and either returns or raises."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.hits: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}
        # (point, hit index, rule index, kind) per injection — the replay
        # identity two runs of the same plan must agree on.
        self.trace: List[Tuple[str, int, int, str]] = []
        self._rules: Dict[str, List[Tuple[int, FaultRule, List[int]]]] = {}
        self._rng: Dict[str, random.Random] = {}
        for i, rule in enumerate(plan.rules):
            self._rules.setdefault(rule.point, []).append((i, rule, [0]))
            if rule.p:
                # Seeded per POINT (not per rule), so the trace is a pure
                # function of (plan, per-point hit counts).
                self._rng.setdefault(
                    rule.point, random.Random(f"{plan.seed}:{rule.point}")
                )

    def hit(self, name: str, info: Dict[str, Any]) -> None:
        n = self.hits.get(name, 0) + 1
        self.hits[name] = n
        rules = self._rules.get(name)
        if not rules:
            return
        rng = self._rng.get(name)
        for idx, rule, fired in rules:
            fire = n in rule.at
            if rule.every and n % rule.every == 0:
                fire = True
            if rule.p and rng is not None:
                # One draw per hit per p-rule keeps replays aligned even
                # when another rule already decided to fire.
                draw = rng.random() < rule.p
                fire = fire or draw
            if not fire or (rule.times is not None and fired[0] >= rule.times):
                continue
            fired[0] += 1
            self.injected[name] = self.injected.get(name, 0) + 1
            self.trace.append((name, n, idx, rule.kind))
            raise _KINDS[rule.kind](
                f"injected {rule.kind} fault at {name} "
                f"(hit {n}, rule {idx}{', ' + repr(info) if info else ''})"
            )


_PLANE: Optional[FaultPlane] = None

# Process-wide recovery-activity counters, counted whether or not a plane
# is armed.
_ACTIVITY: Dict[str, int] = {}


def fault_point(name: str, **info: Any) -> None:
    """Declare-and-maybe-fail one named operation. Disabled cost: one
    module-global load and a None check."""
    plane = _PLANE
    if plane is not None:
        plane.hit(name, info)


def arm(plan: FaultPlan) -> FaultPlane:
    """Install ``plan`` as the process's fault plane (replacing any)."""
    global _PLANE
    _PLANE = FaultPlane(plan)
    return _PLANE


def disarm() -> None:
    global _PLANE
    _PLANE = None


@contextmanager
def armed(plan: FaultPlan) -> Iterator[FaultPlane]:
    plane = arm(plan)
    try:
        yield plane
    finally:
        if _PLANE is plane:
            disarm()


def note_activity(kind: str, n: int = 1) -> None:
    """Record one recovery-path activation (e.g. ``parser_degraded``).
    GIL-atomic dict bump — callable from any thread."""
    _ACTIVITY[kind] = _ACTIVITY.get(kind, 0) + n


def activity_snapshot() -> Dict[str, int]:
    return dict(_ACTIVITY)


def reset_activity() -> None:
    _ACTIVITY.clear()


def plane_snapshot() -> Dict[str, Any]:
    """Fault-plane state for bench legs / debug surfaces: armed flag,
    per-point injections, and the recovery-activity counters."""
    plane = _PLANE
    return {
        "armed": plane is not None,
        "injections": dict(plane.injected) if plane is not None else {},
        "activity": activity_snapshot(),
    }
