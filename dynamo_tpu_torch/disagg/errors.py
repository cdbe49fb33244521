"""Failure taxonomy — the port's copy of ``classify_failure`` from
dynamo_tpu/disagg/errors.py (the HTTP frontend's ``error_kind`` for a
connection or timeout failure; the transfer error itself comes with
disaggregated serving).

``classify_failure`` buckets an exception into an ``error_kind`` label:
the difference between "the link is down" (connection), "the link is
slow" (timeout) and "the payload is garbage" (decode) is the difference
between opening a circuit breaker, lengthening a deadline, and paging a
human.
"""

from __future__ import annotations

import asyncio

# Exception classes per kind, most specific first. TimeoutError is checked
# before ConnectionError because builtin TimeoutError subclasses OSError.
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
