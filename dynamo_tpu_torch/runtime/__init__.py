"""Distributed runtime public API (ref: dynamo-runtime crate, lib/runtime) —
the port's copy of dynamo_tpu/runtime/__init__.py, for what the port has:
the JAX list less the ``ALL_*`` metric-name tuples."""

from dynamo_tpu_torch.runtime.component import (
    Client,
    Component,
    Endpoint,
    Instance,
    Namespace,
    NoInstancesError,
    RouterMode,
    ServedEndpoint,
)
from dynamo_tpu_torch.runtime.context import Context, EngineStream, current_context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime, LocalRequestPlane
from dynamo_tpu_torch.runtime.engine import AsyncEngine, as_engine, collect
from dynamo_tpu_torch.runtime.pipeline import (
    MapRequestOperator,
    MapStreamOperator,
    Operator,
    PassthroughOperator,
    build_pipeline,
)
from dynamo_tpu_torch.runtime.tasks import TaskTracker

__all__ = [
    "AsyncEngine",
    "Client",
    "Component",
    "Context",
    "DistributedRuntime",
    "Endpoint",
    "EngineStream",
    "Instance",
    "LocalRequestPlane",
    "MapRequestOperator",
    "MapStreamOperator",
    "Namespace",
    "NoInstancesError",
    "Operator",
    "PassthroughOperator",
    "RouterMode",
    "ServedEndpoint",
    "TaskTracker",
    "as_engine",
    "build_pipeline",
    "collect",
    "current_context",
]
