"""The engine worker process (python -m dynamo_tpu_torch.worker) — the
port's counterpart of dynamo_tpu/worker/__main__.py: boot TorchEngine,
publish its KV events and load, serve the ``generate``, ``control`` and
``kv`` endpoints, register the model card, and run until SIGTERM or SIGINT.

    python -m dynamo_tpu_torch.worker --model qwen2.5-0.5b
    python -m dynamo_tpu_torch.worker --model tiny --device cpu
    python -m dynamo_tpu_torch.worker --model qwen2.5-0.5b --is-prefill-worker

Disaggregated prefill and decode, as JAX's worker serves them
(dynamo_tpu/worker/__main__.py:375-492): every worker serves ``kv`` with
``disagg.KvTransferHandler`` (its committed KV blocks, streamed in chunks).
A ``--is-prefill-worker`` registers under ``--prefill-component`` (default
``prefill``), serves ``generate`` with ``disagg.PrefillHandler`` (the
prompt's first token and the bootstrap: block hashes, incarnation, wire
dtype and block bytes) and registers no model card: the frontend's
``PrefillRouter`` finds it by its component. Any other worker serves
``generate`` with ``disagg.DecodeHandler``: a request carrying
``disaggregated_params`` first pulls the bootstrap's blocks from the prefill
worker's ``kv`` endpoint into its pools, then generates; its load reports
carry the pull bandwidth a source and the sources whose breaker is open,
and with ``--system-port`` its system server renders the ``dynamo_tpu_disagg_*``
families and the ``disagg`` flight ring.

``--speculative ngram`` (with ``--spec-k`` and ``--spec-ngram``) serves with
prompt-lookup speculative decoding (engines/gpu/spec.py):

    python -m dynamo_tpu_torch.worker --model qwen2.5-0.5b --speculative ngram

``build_parser()`` has the JAX worker's whole argument surface with its
defaults, plus ``--device`` (cuda by default, which raises without a card;
``cpu`` runs the plain versions, without CUDA graphs). A flag whose
machinery the port lacks is refused with the ROADMAP item that brings it
(``refuse_unported``).

With ``--system-port N`` (0 picks a free port) it serves the system server
(runtime/system_server.py) in JAX's start order: up before
``engine.start()``, so that ``/live`` and ``/healthz`` answer at once while
``/readyz`` is 503 until the worker is registered and serving. It prints
``system server on :PORT``.

As JAX's worker, it labels its spans ``worker-{id:#x}`` and ships them to
the frontend's trajectory collector (``TrajectoryShipper`` on the global
tracer), and runs a worker-side ``OverloadController`` whose brownout
reads the KV pool's occupancy, evaluated on the load-report interval, with
its transitions suspending speculative decode
(``TorchEngine.set_spec_suspended``). Its budget rung stays unregistered:
the port has no tick budget (A9), as JAX leaves it with the budgeter off.

Divergences from the JAX worker, each with its ROADMAP item: SIGTERM ends
the wait at once, where JAX's starts a DrainController live handoff (the
drain plane, A11); there is no handoff endpoint (A11); the system server's
``/drain`` answers 501 (A11). ``--lora-dir`` stacks its adapters on the
card, and ``/v1/loras`` on ``--system-port`` loads and unloads them at run
time.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import random
import signal
from dataclasses import dataclass
from typing import Any, List, Optional

from dynamo_tpu_torch import config
from dynamo_tpu_torch.models import config as model_configs
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

logger = get_logger(__name__)

# The presets the port serves, under the JAX worker's names
# (dynamo_tpu/worker/__main__.py:34-44).
BUILTIN_CONFIGS = {
    "tiny": model_configs.tiny_config,
    "qwen2.5-0.5b": model_configs.qwen2_500m_config,
    "llama-3-8b": model_configs.llama3_8b_config,
    "llama-3.2-3b": model_configs.llama3_3b_config,
    "qwen3-8b": model_configs.qwen3_8b_config,
    "llama-3-70b": model_configs.llama3_70b_config,
    "gemma-2-2b": model_configs.gemma2_2b_config,
    "gemma-3-1b": model_configs.gemma3_1b_config,
}
# JAX presets the port refuses: MoE layers are not ported (ROADMAP A7).
MOE_PRESETS = ("mixtral-8x7b",)


def build_parser() -> argparse.ArgumentParser:
    """The worker's argument surface: JAX's (dynamo_tpu/worker/__main__.py:
    47-170), flag for flag with its defaults, plus ``--device``."""
    parser = argparse.ArgumentParser("dynamo-tpu worker (PyTorch engine)")
    parser.add_argument(
        "--model",
        default="tiny",
        help="HF model directory, or a builtin config name "
        f"({', '.join(BUILTIN_CONFIGS)}) with random weights",
    )
    parser.add_argument("--served-model-name", default=None)
    parser.add_argument("--namespace", default=config.NAMESPACE.get())
    parser.add_argument("--component", default="backend")
    parser.add_argument("--endpoint", default="generate")
    parser.add_argument(
        "--block-size", type=int, default=config.KV_BLOCK_SIZE.get()
    )
    parser.add_argument("--num-kv-blocks", type=int, default=2048)
    parser.add_argument("--max-num-seqs", type=int, default=16)
    parser.add_argument("--max-model-len", type=int, default=2048)
    parser.add_argument("--prefill-chunk", type=int, default=512)
    parser.add_argument("--tensor-parallel-size", "--tp", type=int, default=1)
    parser.add_argument("--no-prefix-caching", action="store_true")
    parser.add_argument(
        "--is-prefill-worker", action="store_true",
        help="serve disaggregated prefill (ref: vllm/args.py --is-prefill-worker)",
    )
    parser.add_argument(
        "--prefill-component", default="prefill",
        help="component name prefill workers register under",
    )
    parser.add_argument(
        "--kv-offload-blocks", type=int, default=0,
        help="host-RAM KV tier capacity in blocks (0 = offload disabled; "
        "ref: KVBM G2 tier)",
    )
    parser.add_argument(
        "--kv-offload-dir", default=None,
        help="disk KV tier spool directory (KVBM G3; requires --kv-offload-blocks)",
    )
    parser.add_argument(
        "--kv-remote", default=None, metavar="NS/COMPONENT/ENDPOINT",
        help="shared KV store endpoint (KVBM G4)",
    )
    parser.add_argument(
        "--kv-host-arena-mb", type=int, default=0,
        help="back the host KV tier with a preallocated arena of this many "
        "MB (0 = plain numpy blocks)",
    )
    parser.add_argument("--decode-steps", type=int, default=8,
                        help="fused decode iterations per device dispatch")
    parser.add_argument("--pipeline-depth", type=int, default=2,
                        help="decode bursts in flight on the device (2 = "
                        "double-buffered dispatch/reap, 1 = synchronous)")
    parser.add_argument("--tick-budget", action="store_true",
                        help="intra-chip prefill/decode disaggregation: cap "
                        "per-tick prefill chunk tokens with the closed-loop "
                        "TickBudgeter")
    parser.add_argument("--tick-budget-floor", type=int, default=None,
                        help="starvation floor in prefill tokens per tick "
                        "(default: one prefill chunk)")
    parser.add_argument("--tick-budget-ceiling", type=int, default=None,
                        help="budget ceiling in prefill tokens per tick "
                        "(default: admit_batches_per_tick x prefill_chunk — "
                        "the unbudgeted per-tick admission cap)")
    parser.add_argument("--tick-budget-policy", type=float, default=0.5,
                        help="0 = strict-ITL (start at the floor), 1 = "
                        "max-throughput (start at the ceiling)")
    parser.add_argument("--tick-budget-itl-slo-ms", type=float, default=None,
                        help="per-token ITL SLO driving the budget's "
                        "shrink/grow control law")
    parser.add_argument("--lora-dir", default=None,
                        help="directory of PEFT LoRA adapters to serve "
                        "(ref: lib/llm/src/lora.rs)")
    parser.add_argument("--weight-cache-dir", default=None,
                        help="fast-restart weight cache (GMS-role)")
    parser.add_argument("--system-port", type=int, default=None,
                        help="per-worker system HTTP server port "
                        "(health/metrics/engine admin/LoRAs; 0 = ephemeral; "
                        "ref: system_status_server.rs)")
    parser.add_argument("--model-type", choices=["chat", "completion", "multimodal"],
                        default="chat",
                        help="model card type; 'multimodal' makes the "
                        "frontend splice encode-worker embeddings (E/P/D)")
    parser.add_argument("--speculative", choices=["ngram"], default=None,
                        help="speculative decoding: ngram = prompt-lookup "
                        "proposals verified in one dispatch (greedy only)")
    parser.add_argument("--spec-k", type=int, default=4,
                        help="proposed tokens per speculative verify step")
    parser.add_argument("--spec-ngram", type=int, default=3,
                        help="match length for prompt-lookup proposals")
    parser.add_argument("--kv-checkpoint-dir", default=None,
                        help="warm-cache checkpoint directory: restored at "
                        "startup when present, saved on graceful shutdown")
    parser.add_argument("--quantization", choices=["int8"], default=None,
                        help="weight-only quantization (int8: per-channel)")
    parser.add_argument("--kv-cache-dtype", choices=["int8", "auto"],
                        default=None,
                        help="KV-cache quantization (int8: per-token-head "
                        "dynamic scales). 'auto' applies the measured "
                        "break-even policy: int8 when max_model_len >= "
                        "DYN_TPU_KV_QUANT_AUTO_CTX or the pool cannot hold "
                        "the worst case at bf16")
    parser.add_argument("--coordinator", default=None,
                        help="multi-host: host:port of rank 0's coordinator; "
                        "one process per host forms ONE logical worker")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="multi-host world size")
    parser.add_argument("--process-id", type=int, default=None,
                        help="multi-host rank of this process")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser


# (refused when, the flag, why and the ROADMAP item that brings it); checked
# in this order.
_UNPORTED: List[tuple] = [
    (lambda a: a.kv_offload_blocks > 0 or a.kv_offload_dir or a.kv_remote
     or a.kv_host_arena_mb, "--kv-offload-blocks/--kv-offload-dir/--kv-remote/"
     "--kv-host-arena-mb", "the tiered KV manager is not ported (ROADMAP A10, KVBM)"),
    (lambda a: a.tick_budget or a.tick_budget_floor is not None
     or a.tick_budget_ceiling is not None or a.tick_budget_policy != 0.5
     or a.tick_budget_itl_slo_ms is not None, "--tick-budget*",
     "the tick budget is not ported (ROADMAP A9, the tick budget)"),
    (lambda a: a.kv_checkpoint_dir, "--kv-checkpoint-dir",
     "the KV checkpoint is not ported (ROADMAP A6-2)"),
    (lambda a: a.coordinator or a.num_processes is not None or a.process_id is not None
     or a.tensor_parallel_size > 1, "--coordinator/--num-processes/--process-id/--tp > 1",
     "parallelism is not ported (ROADMAP A9, parallelism: tensor parallel and "
     "multi-host)"),
    (lambda a: a.no_prefix_caching, "--no-prefix-caching",
     "the port's engine always caches prefixes (ROADMAP A9, prefix caching off)"),
    (lambda a: a.model_type == "multimodal", "--model-type multimodal",
     "the encode stage is not ported (ROADMAP A9, multimodal)"),
    (lambda a: a.model in MOE_PRESETS, "--model " + "/".join(MOE_PRESETS),
     "MoE layers are not ported (ROADMAP A7)"),
    (lambda a: a.weight_cache_dir or a.model not in BUILTIN_CONFIGS,
     "a model directory or --weight-cache-dir",
     "weight loading is not ported (ROADMAP A9, weight loading); pass a builtin "
     f"config name ({', '.join(BUILTIN_CONFIGS)})"),
]


def refuse_unported(parser: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """``parser.error`` (exit 2) for the first flag whose machinery the port
    lacks, naming the ROADMAP item that brings it."""
    for refused, flag, why in _UNPORTED:
        if refused(args):
            parser.error(f"{flag}: {why}")


@dataclass
class WorkerHandle:
    """A serving worker (``serve_worker``): what it serves, and ``close()``,
    the JAX worker's shutdown order short of the runtime itself
    (dynamo_tpu/worker/__main__.py:615-637, less what the port lacks)."""

    engine: Any
    card: Any
    name: str
    instance_id: int
    incarnation: int
    kv_pub: Any
    load_pub: Any
    served: Any  # the generate endpoint
    served_ctl: Any
    served_kv: Any  # the kv endpoint (KvTransferHandler)
    trajectory_shipper: Any
    overload_task: Any  # the worker-side OverloadController's evaluate loop
    system_server: Any  # None without --system-port

    async def close(self) -> None:
        from dynamo_tpu_torch.runtime.tasks import reap_task
        from dynamo_tpu_torch.runtime.trajectory import set_global_shipper

        if self.system_server is not None:
            await self.system_server.stop()
        self.overload_task.cancel()
        await reap_task(self.overload_task, "overload eval loop", logger)
        set_global_shipper(None)
        await self.trajectory_shipper.close()
        await self.load_pub.close()
        await self.kv_pub.close()
        await self.served.shutdown(grace_period=config.GRACE_PERIOD.get())
        await self.served_ctl.shutdown(grace_period=5)
        await self.served_kv.shutdown(grace_period=5)
        await self.engine.stop()


async def serve_worker(args: argparse.Namespace, runtime: Any, *,
                       params: Optional[Any] = None) -> WorkerHandle:
    """Boot the engine and serve it on ``runtime`` as the JAX worker does
    (dynamo_tpu/worker/__main__.py:172-637, in its order): the KV-event
    publisher and TorchEngine(on_kv_event=), the snapshot source, the load
    publisher, the card, the system server (``args.system_port``; readiness
    503 until the end of this call), engine.start(), the ``kv``, ``control``
    and ``generate`` endpoints (under DYN_TPU_WORKER_ID or a random 63-bit
    id, the process incarnation in the instance metadata; ``generate`` by
    PrefillHandler with ``args.is_prefill_worker``, else by DecodeHandler),
    register_llm (not on a prefill worker), the load reports.
    ``params`` overrides the engine's random init (tests pass weights
    converted by models.weights.params_from_jax)."""
    from dynamo_tpu_torch.disagg import DecodeHandler, KvTransferHandler, PrefillHandler
    from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
    from dynamo_tpu_torch.llm.discovery import register_llm
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, RuntimeConfig
    from dynamo_tpu_torch.router import KvEventPublisher, LoadPublisher
    from dynamo_tpu_torch.runtime.liveness import process_incarnation
    from dynamo_tpu_torch.runtime.overload import OverloadController, config_from_env
    from dynamo_tpu_torch.runtime.trajectory import (
        TrajectoryShipper,
        global_store,
        set_global_shipper,
    )
    from dynamo_tpu_torch.utils.tracing import global_tracer, set_service

    if args.is_prefill_worker and args.component == "backend":
        args.component = args.prefill_component
    model_config = BUILTIN_CONFIGS[args.model]()
    engine_args = TorchEngineArgs(
        config=model_config,
        block_size=args.block_size,
        num_kv_blocks=args.num_kv_blocks,
        max_num_seqs=args.max_num_seqs,
        max_model_len=args.max_model_len,
        prefill_chunk=args.prefill_chunk,
        decode_steps=args.decode_steps,
        pipeline_depth=args.pipeline_depth,
        quantization=args.quantization,
        kv_cache_dtype=args.kv_cache_dtype,
        spec_mode=args.speculative,
        spec_k=args.spec_k,
        spec_ngram=args.spec_ngram,
        lora_dir=args.lora_dir,
        device=args.device,
        # a decode burst as a CUDA graph needs the card
        cuda_graphs=args.device != "cpu",
    )
    name = args.served_model_name or model_config.name
    # Stable worker identity (crash plane): a restarted worker re-registers
    # under the SAME id with a fresh process incarnation, so the router's
    # rejoin purge and the fence line up; 0 keeps the random-per-start
    # behavior for ad-hoc workers.
    instance_id = config.WORKER_ID.get() or random.getrandbits(63)
    # Trajectory plane: label this process's spans (clock-domain tag for
    # cross-worker stitching) and ship finished spans frontend-ward.
    set_service(f"worker-{instance_id:#x}")
    trajectory_shipper = TrajectoryShipper(runtime.event_plane, args.namespace)
    trajectory_shipper.attach(global_tracer())
    set_global_shipper(trajectory_shipper)
    # Eagerly attach the local store too, so that this process's own
    # spans are stitched from the first request.
    global_store()
    kv_pub = KvEventPublisher(
        runtime.event_plane, args.namespace, args.component, instance_id
    )
    engine = TorchEngine(engine_args, params, on_kv_event=kv_pub.on_kv_event)
    # Answer router re-sync requests with the pool's committed set (the
    # JetStream replay role) — a restarted router rebuilds its radix index
    # immediately instead of waiting for TTL churn.
    kv_pub.set_snapshot_fn(engine.pool.committed_view)
    load_pub = LoadPublisher(
        runtime.event_plane, args.namespace, args.component, instance_id,
        engine.stats, total_blocks=args.num_kv_blocks,
    )
    card = ModelDeploymentCard(
        name=name,
        model_type=args.model_type,
        model_path=None,
        context_length=args.max_model_len,
        kv_block_size=args.block_size,
        eos_token_ids=list(model_config.eos_token_ids),
        runtime_config=RuntimeConfig(
            total_kv_blocks=args.num_kv_blocks,
            kv_block_size=args.block_size,
            max_num_seqs=args.max_num_seqs,
            max_context_len=args.max_model_len,
        ),
    )
    component = runtime.namespace(args.namespace).component(args.component)
    endpoint = component.endpoint(args.endpoint)

    # The system server is up before the engine starts: /healthz (the
    # process turns) answers through the start while /readyz stays 503,
    # so an orchestrator neither restarts the worker nor routes to it.
    ready_state = {"ready": False, "detail": "starting engine"}
    system_server = None
    if args.system_port is not None:
        from dynamo_tpu_torch.runtime.system_server import SystemStatusServer, attach_engine

        system_server = SystemStatusServer(port=args.system_port)
        attach_engine(system_server, engine)
        system_server.register_readiness(
            "worker", lambda: (ready_state["ready"], ready_state["detail"]))
        await system_server.start()
        print(f"system server on :{system_server.port}", flush=True)

    await engine.start()
    ready_state["detail"] = "registering endpoints"
    incarnation = process_incarnation()
    served_kv = await component.endpoint("kv").serve_endpoint(
        KvTransferHandler(engine).generate, instance_id=instance_id
    )

    async def control(request, context):
        """Admin ops (ref: clear_kv_blocks.rs; fanned out by the frontend)."""
        op = request.get("op") if isinstance(request, dict) else None
        if op == "clear_kv_blocks":
            yield {"cleared": engine.clear_kv_blocks()}
        elif op == "stats":
            yield engine.stats()
        else:
            yield {"error": f"unknown control op {op!r}"}

    served_ctl = await component.endpoint("control").serve_endpoint(
        control, instance_id=instance_id
    )

    if args.is_prefill_worker:
        # Found through its component by the frontend's PrefillRouter, not
        # through the model registry (ref: prefill_router.rs activate).
        handler = PrefillHandler(engine, instance_id)
        served = await endpoint.serve_endpoint(
            handler.generate, instance_id=instance_id, metadata={"incarnation": incarnation},
        )
    else:
        async def kv_client():
            return await (
                runtime.namespace(args.namespace).component(args.prefill_component)
                .endpoint("kv").client()
            )

        handler = DecodeHandler(engine, kv_client_factory=kv_client, worker_id=instance_id)
        # Load reports carry the measured pull bandwidth of each prefill
        # source and the sources whose pull breaker is open.
        load_pub.link_bandwidth_fn = handler.link_bandwidth
        load_pub.link_faults_fn = handler.open_breaker_srcs
        served = await endpoint.serve_endpoint(
            handler.generate, instance_id=instance_id, metadata={"incarnation": incarnation},
        )
        await register_llm(runtime, card, endpoint, instance_id, incarnation=incarnation)
    load_pub.start()
    trajectory_shipper.start()
    # Worker-side overload plane: KV-pool-occupancy-driven brownout that
    # suspends speculative decode before admission backpressure turns into
    # a preemption storm. Its occupancy source and its evaluate loop run on
    # the event loop's thread, where every block-pool call runs. The budget
    # rung stays unregistered: the port has no tick budget (A9).
    overload = OverloadController(
        config_from_env(), occupancy_source=lambda: engine.pool.usage,
    )
    overload.on_transition(lambda _old, new: engine.set_spec_suspended(new > 0))

    async def overload_eval_loop() -> None:
        while True:
            await asyncio.sleep(load_pub.interval_s)
            overload.evaluate()

    overload_task = asyncio.get_running_loop().create_task(
        overload_eval_loop(), name="overload-eval"
    )
    if system_server is not None:
        overload.register_metrics(system_server)
        if isinstance(handler, DecodeHandler):
            handler.register_metrics(system_server)  # the disagg transfer families
    ready_state.update(ready=True, detail=f"serving (incarnation {incarnation:#x})")
    return WorkerHandle(engine=engine, card=card, name=name, instance_id=instance_id,
                        incarnation=incarnation, kv_pub=kv_pub, load_pub=load_pub,
                        served=served, served_ctl=served_ctl, served_kv=served_kv,
                        trajectory_shipper=trajectory_shipper, overload_task=overload_task,
                        system_server=system_server)


async def main() -> None:
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    parser = build_parser()
    args = parser.parse_args()
    refuse_unported(parser, args)
    configure_logging()
    runtime = DistributedRuntime.from_settings()
    worker = None
    try:
        worker = await serve_worker(args, runtime)
        shutdown = asyncio.Event()
        loop = asyncio.get_running_loop()
        sigint_count = 0

        def on_sigint() -> None:
            nonlocal sigint_count
            sigint_count += 1
            if sigint_count >= 2:
                # Second ^C: the operator means NOW. Skip every shutdown step.
                print("second SIGINT: forcing exit", flush=True)
                os._exit(130)
            shutdown.set()

        # Loop signal handlers, NOT signal.signal: the finally block below
        # must run (graceful endpoint shutdown, lease revoke).
        loop.add_signal_handler(signal.SIGTERM, shutdown.set)
        loop.add_signal_handler(signal.SIGINT, on_sigint)
        print(
            f"worker serving {worker.name} as {args.namespace}/{args.component}/"
            f"{args.endpoint} instance {worker.instance_id:#x} "
            f"incarnation {worker.incarnation:#x}",
            flush=True,
        )
        await shutdown.wait()
    finally:
        if worker is not None:
            await worker.close()
        await runtime.shutdown(grace_period=config.GRACE_PERIOD.get())
        await runtime.event_plane.close()


if __name__ == "__main__":
    asyncio.run(main())
