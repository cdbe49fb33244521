"""The core streaming-engine abstraction — the port's copy of
dynamo_tpu/runtime/engine.py.

Reference parity: ``AsyncEngine`` trait (lib/runtime/src/engine.rs:201) and the
type-erased ``AnyAsyncEngine`` (engine.rs:285). In this framework an engine is
anything with::

    async def generate(request, context) -> AsyncIterator[response]

Handlers may be written as plain async generator functions; ``as_engine``
adapts them. Streams are plain async iterators — one item per token-delta for
LLM engines — and the context controls cancellation (see context.py).
"""

from __future__ import annotations

import inspect
from typing import Any, AsyncIterator, Awaitable, Callable, Optional, Protocol, runtime_checkable

from dynamo_tpu_torch.runtime.context import Context


@runtime_checkable
class AsyncEngine(Protocol):
    """Streaming request→response-stream engine."""

    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        ...


HandlerFn = Callable[..., Any]


class _FnEngine:
    """Adapts a function to the AsyncEngine protocol.

    Accepts any of:
      - ``async def f(request) -> AsyncIterator``        (async generator)
      - ``async def f(request, context) -> AsyncIterator``
      - ``async def f(request[, context]) -> value``     (unary; wrapped into a
        one-item stream)
    """

    def __init__(self, fn: HandlerFn, name: Optional[str] = None) -> None:
        self._fn = fn
        self._wants_context = _accepts_context(fn)
        self.name = name or getattr(fn, "__name__", "engine")

    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        if self._wants_context:
            result = self._fn(request, context)
        else:
            result = self._fn(request)
        return _as_stream(result)

    def __repr__(self) -> str:
        return f"FnEngine({self.name})"


def _accepts_context(fn: HandlerFn) -> bool:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    params = [
        p
        for p in sig.parameters.values()
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
    ]
    # Bound methods already exclude `self`.
    return len(params) >= 2


async def _await_one(awaitable: Awaitable[Any]) -> AsyncIterator[Any]:
    value = await awaitable
    if hasattr(value, "__aiter__"):
        async for item in value:
            yield item
    else:
        yield value


def _as_stream(result: Any) -> AsyncIterator[Any]:
    if hasattr(result, "__aiter__"):
        return result.__aiter__()
    if inspect.isawaitable(result):
        return _await_one(result)
    raise TypeError(
        f"engine handler returned {type(result).__name__}; expected an async "
        "generator or awaitable"
    )


def as_engine(obj: Any, name: Optional[str] = None) -> AsyncEngine:
    """Coerce a handler function / object with .generate into an AsyncEngine."""
    if callable(getattr(obj, "generate", None)):
        return obj
    if callable(obj):
        return _FnEngine(obj, name=name)
    raise TypeError(f"cannot adapt {type(obj).__name__} to AsyncEngine")


async def collect(stream: AsyncIterator[Any]) -> list:
    """Drain a stream into a list (test/batch helper)."""
    out = []
    async for item in stream:
        out.append(item)
    return out
