"""Drain plane — the port holds only the typed refusal of
dynamo_tpu/runtime/drain.py:57-62, which the request planes' ``err``
frames name (network/errors.py kind ``draining``). The drain controller
(the serving → draining → drained state machine, live handoff and the
rolling-restart ladder) comes with the drain plane (ROADMAP A11).
"""

from __future__ import annotations


class WorkerDrainingError(ConnectionError):
    """Typed migratable refusal/fallback: the worker is draining (or a
    handoff failed mid-drain) and the frontend should re-dispatch the
    request — with its streamed tokens carried — to a serving worker.
    Subclasses ConnectionError so the migratable set already covers it."""
