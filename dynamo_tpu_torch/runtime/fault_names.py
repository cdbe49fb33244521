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

# -- parser plane (parsers/jail.py) -------------------------------------------
# One hit per jail operation (each content delta fed, plus the finish at
# stream end): an injection models the tool-call parser dying mid-stream
# — which MUST surface as a terminal typed SSE error frame
# (error_kind=tool_call_parse), never a dropped stream.
PARSER_JAIL_FEED = "parser.jail.feed"

ALL_FAULT_POINTS = (
    NET_TCP_SEND,
    NET_TCP_RECV,
    NET_ZMQ_SEND,
    NET_ZMQ_RECV,
    DISCOVERY_LEASE_RENEW,
    HEALTH_CANARY,
    LIVENESS_REPORT,
    PARSER_JAIL_FEED,
)
