"""The frontend process (python -m dynamo_tpu_torch.frontend) — the port's
counterpart of dynamo_tpu/frontend/__main__.py: the OpenAI HTTP service over
the models a ModelWatcher finds on the discovery plane, each routed to its
workers (KV-aware by default) behind Migration.

    python -m dynamo_tpu_torch.frontend --host 127.0.0.1 --http-port 8000

It has JAX's flags and defaults, and starts what JAX's frontend starts:
the trajectory collector (the workers' shipped spans, stitched on
``/debug/trajectory/{trace_id}``), the overload controller on the
``DYN_TPU_OVERLOAD_*`` knobs (``runtime/overload.config_from_env``), and
TLS with ``--tls-cert`` and ``--tls-key``. Divergences: SIGTERM and SIGINT
end the wait and the frontend shuts down in JAX's order (the service, the
watcher, the collector, the runtime) and exits 0, where JAX's frontend has
no handler and dies by the signal; ``/metrics`` also carries the models'
Migration families (llm/discovery.py).
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from dynamo_tpu_torch import config
from dynamo_tpu_torch.utils.logging import configure_logging


def build_parser() -> argparse.ArgumentParser:
    """JAX's frontend flags with their defaults
    (dynamo_tpu/frontend/__main__.py:21-48)."""
    parser = argparse.ArgumentParser(
        "dynamo-tpu frontend",
        description="OpenAI-compatible HTTP server with dynamic model discovery",
    )
    parser.add_argument("--host", default=config.HTTP_HOST.get())
    parser.add_argument("--http-port", type=int, default=config.HTTP_PORT.get())
    parser.add_argument(
        "--router-mode",
        choices=["kv", "round-robin", "random"],
        default="kv",
        help="worker selection policy (ref: RouterMode, push_router.rs:76)",
    )
    parser.add_argument(
        "--kv-overlap-score-weight", type=float,
        default=config.ROUTER_OVERLAP_WEIGHT.get(),
    )
    parser.add_argument(
        "--router-temperature", type=float, default=config.ROUTER_TEMPERATURE.get()
    )
    parser.add_argument(
        "--enable-canary", action="store_true",
        help="active canary health checks per worker "
        "(ref: lib/runtime/src/health_check.rs)",
    )
    parser.add_argument("--canary-interval", type=float, default=5.0)
    parser.add_argument("--canary-timeout", type=float, default=10.0)
    parser.add_argument("--tls-cert", default=None,
                        help="PEM certificate chain (enables TLS with --tls-key)")
    parser.add_argument("--tls-key", default=None, help="PEM private key")
    return parser


async def main() -> None:
    from dynamo_tpu_torch.http.model_manager import ModelManager
    from dynamo_tpu_torch.http.service import HttpService
    from dynamo_tpu_torch.llm.discovery import ModelWatcher
    from dynamo_tpu_torch.llm.migration import MigrationMetrics
    from dynamo_tpu_torch.router import KvRouterConfig
    from dynamo_tpu_torch.runtime.component import RouterMode
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.overload import OverloadController, config_from_env
    from dynamo_tpu_torch.runtime.trajectory import TrajectoryCollector
    from dynamo_tpu_torch.utils.tracing import set_service

    parser = build_parser()
    args = parser.parse_args()
    if bool(args.tls_cert) != bool(args.tls_key):
        # JAX's frontend serves plain HTTP then; an operator who set one of
        # the two expects TLS.
        parser.error("--tls-cert and --tls-key are given together or not at all")

    configure_logging()
    runtime = DistributedRuntime.from_settings()
    # Trajectory plane: label this process's spans and collect the fleet's
    # shipped spans into the process-global store (the store auto-attaches
    # to the global tracer, so the frontend's own spans land there too).
    set_service("frontend")
    trajectory = TrajectoryCollector(runtime.event_plane, config.NAMESPACE.get())
    await trajectory.start()
    manager = ModelManager()
    mode = {
        "kv": RouterMode.KV,
        "round-robin": RouterMode.ROUND_ROBIN,
        "random": RouterMode.RANDOM,
    }[args.router_mode]
    watcher = ModelWatcher(
        runtime,
        manager,
        router_mode=mode,
        kv_router_config=KvRouterConfig(
            overlap_score_weight=args.kv_overlap_score_weight,
            router_temperature=args.router_temperature,
        ),
        enable_canary=args.enable_canary,
        canary_interval_s=args.canary_interval,
        canary_timeout_s=args.canary_timeout,
    )
    # Overload armor on by default: bounded EDF admission + (when an ITL
    # SLA is configured) the brownout state machine (DYN_TPU_OVERLOAD_*).
    service = HttpService(
        manager, host=args.host, port=args.http_port,
        tls_cert=args.tls_cert, tls_key=args.tls_key,
        overload=OverloadController(config_from_env()),
    )
    # the models' Migration families, on the registry /metrics renders
    watcher.migration_metrics = MigrationMetrics(service.metrics.registry)
    await watcher.start()
    port = await service.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    print(f"frontend listening on {args.host}:{port}", flush=True)
    try:
        await stop.wait()
    finally:
        await service.stop(grace_period=config.GRACE_PERIOD.get())
        await watcher.stop()
        await trajectory.stop()
        await runtime.shutdown(grace_period=config.GRACE_PERIOD.get())
        await runtime.event_plane.close()


if __name__ == "__main__":
    asyncio.run(main())
