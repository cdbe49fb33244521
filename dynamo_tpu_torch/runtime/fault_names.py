"""Canonical fault-point names — the port's copy of the entries of
dynamo_tpu/runtime/fault_names.py for the seams the port has.

``fault_point(...)`` call sites import these constants, and arming a plan
(runtime/faults.py) that names an undeclared point fails fast.
Naming scheme: ``<subsystem>.<operation>[.<phase>]``.
"""

from __future__ import annotations

# -- parser plane (parsers/jail.py) -------------------------------------------
# One hit per jail operation (each content delta fed, plus the finish at
# stream end): an injection models the tool-call parser dying mid-stream
# — which MUST surface as a terminal typed SSE error frame
# (error_kind=tool_call_parse), never a dropped stream.
PARSER_JAIL_FEED = "parser.jail.feed"

ALL_FAULT_POINTS = (PARSER_JAIL_FEED,)
