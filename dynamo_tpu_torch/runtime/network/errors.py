"""Transport-agnostic typed-error classification for request planes — the
port's copy of dynamo_tpu/runtime/network/errors.py.

Every request plane ships stream failures as ``err`` frames carrying a
``kind`` so TYPED remote failures re-raise as the matching exception class
on the client instead of a flat RuntimeError: connection/timeout errors and
drain refusals (WorkerDrainingError, "endpoint draining") must stay
MIGRATABLE across the wire. Old peers that omit ``kind`` keep the
RuntimeError behavior. The kinds are the JAX package's, so a JAX client
reading a port server (and the reverse) raises the same types.
"""

from __future__ import annotations

import asyncio


def err_kind(exc: BaseException) -> str:
    """Classify a server-side handler failure for the err frame's ``kind``
    (the client re-raises the matching type — migratability must survive
    the wire). Name-based where importing the class would cycle."""
    if type(exc).__name__ == "WorkerDrainingError":
        return "draining"
    if type(exc).__name__ == "NoInstancesError":
        return "no_instances"
    if type(exc).__name__ == "ToolCallParseError":
        # Tool-call parser BUG (parsers/jail.py): typed so a client can
        # tell a parse failure from a transport death.
        return "tool_call_parse"
    if isinstance(exc, (TimeoutError, asyncio.TimeoutError)):
        return "timeout"
    if isinstance(exc, ConnectionError):
        return "connection"
    return "other"


def err_exception(kind: str, message: str) -> BaseException:
    """Client-side inverse of err_kind."""
    if kind == "draining":
        from dynamo_tpu_torch.runtime.drain import WorkerDrainingError

        return WorkerDrainingError(message)
    if kind == "no_instances":
        from dynamo_tpu_torch.runtime.component import NoInstancesError

        return NoInstancesError(message)
    if kind == "tool_call_parse":
        from dynamo_tpu_torch.parsers.incremental import ToolCallParseError

        return ToolCallParseError(message)
    if kind == "timeout":
        return TimeoutError(message)
    if kind == "connection":
        return ConnectionError(message)
    return RuntimeError(message)
