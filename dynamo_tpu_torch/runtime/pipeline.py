"""Pipeline operators: composable request/response-stream transformations —
the port's copy of dynamo_tpu/runtime/pipeline.py.

Reference parity: the pipeline node graph in lib/runtime/src/pipeline.rs
(Source/Sink/Operator/SegmentSource/SegmentSink) and the assembled chain in
lib/llm/src/entrypoint/input/common.rs:173 (SegmentSource → OpenAIPreprocessor
→ Backend → Migration → Router).

The reference models pipelines as linked graph nodes with typed edges; here an
``Operator`` is a pure transformation around a downstream ``AsyncEngine``:

    stream = operator.generate(request, context, next=downstream)

An operator may rewrite the request (preprocessor), rewrite/augment the
response stream (detokenizer), retry against the downstream (migration), or
choose among many downstreams (router). ``build_pipeline`` folds a list of
operators onto a terminal engine, producing a plain AsyncEngine — so composed
pipelines nest and are themselves routable.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, List, Optional, Protocol, runtime_checkable

from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine, as_engine


@runtime_checkable
class Operator(Protocol):
    def generate(
        self, request: Any, context: Context, next: AsyncEngine
    ) -> AsyncIterator[Any]:
        ...


class _BoundOperator:
    """An Operator partially applied to its downstream engine."""

    __slots__ = ("_op", "_next")

    def __init__(self, op: Operator, next: AsyncEngine) -> None:
        self._op = op
        self._next = next

    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        return self._op.generate(request, context, next=self._next)

    def __repr__(self) -> str:
        return f"{type(self._op).__name__} → {self._next!r}"


def build_pipeline(operators: List[Operator], engine: Any) -> AsyncEngine:
    """Fold operators (outermost first) onto a terminal engine."""
    current: AsyncEngine = as_engine(engine)
    for op in reversed(operators):
        current = _BoundOperator(op, current)
    return current


class PassthroughOperator:
    """Identity operator; useful as a base class and in tests."""

    async def generate(
        self, request: Any, context: Context, next: AsyncEngine
    ) -> AsyncIterator[Any]:
        async for item in next.generate(request, context):
            yield item


class MapRequestOperator(PassthroughOperator):
    """Applies a (possibly async) function to the request before forwarding."""

    def __init__(self, fn) -> None:
        self._fn = fn

    async def generate(self, request, context, next):
        mapped = self._fn(request)
        if hasattr(mapped, "__await__"):
            mapped = await mapped
        async for item in next.generate(mapped, context):
            yield item


class MapStreamOperator(PassthroughOperator):
    """Applies a function to every item of the response stream."""

    def __init__(self, fn) -> None:
        self._fn = fn

    async def generate(self, request, context, next):
        async for item in next.generate(request, context):
            yield self._fn(item)
