"""Canonical fault-point names — the port's copy of the entries of
dynamo_tpu/runtime/fault_names.py for the seams the port has.

``fault_point(...)`` call sites import these constants, and arming a plan
(runtime/faults.py) that names an undeclared point fails fast.
Naming scheme: ``<subsystem>.<operation>[.<phase>]``.
"""

from __future__ import annotations

# -- request/event planes (runtime/network/tcp.py, runtime/events/zmq_plane.py)
NET_TCP_SEND = "net.tcp.send"
NET_TCP_RECV = "net.tcp.recv"
NET_ZMQ_SEND = "net.zmq.send"
NET_ZMQ_RECV = "net.zmq.recv"

# -- discovery / health (runtime/distributed.py, runtime/health.py) -----------
DISCOVERY_LEASE_RENEW = "discovery.lease.renew"
HEALTH_CANARY = "health.canary"

# -- crash plane (runtime/liveness.py) ----------------------------------------
# One hit per load report admitted by the liveness tracker: an injected
# failure models report loss between the wire and the tracker — N
# consecutive injections must trip the same suspect/dead machinery a
# crashed worker does.
LIVENESS_REPORT = "liveness.report"

# -- disaggregated KV transfer (disagg/handlers.py) ---------------------------
# One pull-side hit per received chunk, BEFORE the chunk is imported: an
# injection here models the wire dying mid-transfer with N chunks landed.
DISAGG_PULL_CHUNK = "disagg.pull.chunk"
# Export side: one hit per chunk gathered by the KvTransferHandler.
DISAGG_KV_EXPORT = "disagg.kv.export"
# Import side: one hit per chunk handed to the engine's scatter path.
DISAGG_KV_IMPORT = "disagg.kv.import"

# -- engine decode tick (engines/gpu/engine.py) -------------------------------
# Dispatch: after the sync payloads are built, before the device call — the
# adversarial spot, because the dirty-slot sets were already cleared and
# recovery must resync them from the mirrors (_abort_inflight).
ENGINE_TICK_DISPATCH = "engine.tick.dispatch"
# Reap: before the oldest in-flight burst's readback.
ENGINE_TICK_REAP = "engine.tick.reap"

# -- parser plane (parsers/jail.py) -------------------------------------------
# One hit per jail operation (each content delta fed, plus the finish at
# stream end): an injection models the tool-call parser dying mid-stream
# — which MUST surface as a terminal typed SSE error frame
# (error_kind=tool_call_parse), never a dropped stream.
PARSER_JAIL_FEED = "parser.jail.feed"

# -- trajectory plane (runtime/trajectory.py) ---------------------------------
# One hit per shipped span/event batch, BEFORE the event-plane publish: an
# injection models the telemetry path dying — the batch is counted dropped
# and serving continues untouched (observability must never take down the
# data plane; the shipper tests replay this).
TRAJECTORY_SHIP = "trajectory.ship"

# -- overload plane (runtime/overload.py) -------------------------------------
# One hit per QUEUED admission attempt, before the EDF wait: an injected
# timeout here expires exactly that request's queue budget — the
# deterministic mid-queue-expiry schedule the saturation tests replay
# (wall-clock deadline races can't).
OVERLOAD_ADMIT = "overload.admit"

# -- perf ledger (runtime/perf_ledger.py) -------------------------------------
# One hit at the top of the startup fingerprint load, before the file is
# opened: an injection models a corrupt / vanished / unreadable
# fingerprint file — which MUST degrade to a counted, flight-recorded
# cold start (no baseline, sentinel verdicts go "no_baseline"), never a
# crash.
PERF_FINGERPRINT_LOAD = "perf.fingerprint.load"
# One hit per clean-shutdown fingerprint store, before the tmp write: an
# injection models the persistence path dying — the shutdown proceeds,
# the failure is counted, and the NEXT start is a cold start (a degraded
# baseline is worse than none).
PERF_FINGERPRINT_STORE = "perf.fingerprint.store"

ALL_FAULT_POINTS = (
    NET_TCP_SEND,
    NET_TCP_RECV,
    NET_ZMQ_SEND,
    NET_ZMQ_RECV,
    DISAGG_PULL_CHUNK,
    DISAGG_KV_EXPORT,
    DISAGG_KV_IMPORT,
    DISCOVERY_LEASE_RENEW,
    HEALTH_CANARY,
    LIVENESS_REPORT,
    ENGINE_TICK_DISPATCH,
    ENGINE_TICK_REAP,
    PARSER_JAIL_FEED,
    TRAJECTORY_SHIP,
    OVERLOAD_ADMIT,
    PERF_FINGERPRINT_LOAD,
    PERF_FINGERPRINT_STORE,
)
