"""Failure taxonomy — the port's copy of dynamo_tpu/disagg/errors.py.

``classify_failure`` buckets an exception into an ``error_kind`` label:
the difference between "the link is down" (connection), "the link is
slow" (timeout) and "the payload is garbage" (decode) is the difference
between opening a circuit breaker, lengthening a deadline, and paging a
human.

``DisaggTransferError`` is the terminal failure of a pull on a handler
configured WITHOUT local-prefill fallback (strict disagg: the decode
worker cannot afford a full prefill). It subclasses ConnectionError so the
frontend's Migration operator re-dispatches the stream to another worker.
Migration names the class to label its ``disagg`` reason.
"""

from __future__ import annotations

import asyncio


class DisaggTransferError(ConnectionError):
    """KV pull terminally failed and local re-prefill is disabled —
    migratable: the router should place the request elsewhere."""


# Exception classes per kind, most specific first. TimeoutError is checked
# before ConnectionError because builtin TimeoutError subclasses OSError
# (and asyncio.TimeoutError is a DISTINCT class until Python 3.11).
_TIMEOUT_TYPES = (TimeoutError, asyncio.TimeoutError)
_CONNECTION_TYPES = (ConnectionError, EOFError, OSError)
_DECODE_TYPES = (ValueError, KeyError, TypeError, IndexError)


def classify_failure(exc: BaseException) -> str:
    """→ ``timeout`` | ``connection`` | ``decode`` | ``other``."""
    if isinstance(exc, _TIMEOUT_TYPES):
        return "timeout"
    if isinstance(exc, _CONNECTION_TYPES):
        return "connection"
    if isinstance(exc, _DECODE_TYPES):
        return "decode"
    return "other"
