"""TorchEngine: continuous batching over the port's paged-KV model —
counterpart of dynamo_tpu/engines/tpu/engine.py (JaxEngine) and
engines/tpu/admission.py (its Admitter), reduced to the scheduling core:

  - continuous batching over ``max_num_seqs`` slots, with batched prefill
    admission (up to PREFILL_BATCH rows per chunk round) and chunked
    prefill at ``prefill_chunk`` tokens;
  - prefix reuse through the block pool (chained block hashes);
  - fused decode bursts of ``decode_steps`` tokens, stop conditions
    (EOS, stop ids, ``max_tokens``, ``max_model_len``) reconciled on the host
    after each burst, cancellation through ``Context``;
  - preemption-by-recompute when the pool runs dry.

Pipelined decode, as the JAX engine's (engine.py:1443-1663): a tick tops
the in-flight window up to ``pipeline_depth`` bursts (default 2), then
reaps the oldest, so at depth 2 the card runs the next burst while the
host reads back, reconciles stops and emits the previous one. Slot state
lives on the device (engines/gpu/runner.py); the scheduler marks the slots
and tables it changes dirty (install, finish, preempt, block append) and a
dispatch syncs only those rows. Each burst's table width is a power-of-two
bucket (``table_width_bucket``): on the card each bucket's burst is one
captured CUDA graph (``cuda_graphs``). A reaped row whose sequence finished
or was preempted while the burst was in flight is dropped; its overshoot
writes landed in blocks reserved ``LOOKAHEAD_BURSTS`` ahead. Admission and
preemption see reconciled state: the pipeline is drained before either.
Streams are the same at every depth and with or without graphs (sampling
noise is keyed by position, never by which burst draws it).

Logprobs, top logprobs and the logits processors (repetition, presence and
frequency penalties, min_p, logit_bias), as the JAX engine and admission
serve them (admission.py:381-385, 554-589; engine.py:1509-1512,
1772-1792, 1843-1879, 2298-2331): a request that sets a processor marks
its slot (``_uses_procs``), whose penalty bookkeeping is reset at install
(the prompt, and after a preemption the tokens generated so far); a burst
runs the processor variant when a slot it decodes uses one and the
logprobs variant when a request asks for logprobs; every emitted token
carries its TokenLogprob entry, the first token's included, with the top
``min(logprobs, top_logprobs_cap)`` after it.

A failed tick, as the JAX engine's (engine.py:1050-1083, 1664-1710): the
bursts in flight are dropped and every slot's state and table row is
marked dirty, so the next dispatch rolls the device state (and the decode
graphs' inputs, which are that state) back to the host mirrors; the
penalty counts of each live slot that uses processors are rebuilt from
its emitted history; the tick is retried after min(0.05·2^n, 2) s, and
after 5 failures in a row the engine fails terminally (every stream ends
with the error, new requests are refused). The position-keyed sampling
noise makes the retried bursts draw the same tokens. Fault seams:
``ENGINE_TICK_DISPATCH`` and ``ENGINE_TICK_REAP`` (runtime/fault_names.py).

A request whose context stopped while it waited is finished before any
prefill, as the JAX engine's ``_shed_expired`` does (engine.py:1306-1330):
an expired deadline ends in a typed timeout error and counts in
``stats()["deadline_sheds"]``; a cancellation ends quietly. Unlike JAX's,
which sheds only the queue's head when a slot frees, every admission pass
sheds each stopped waiter, full engine or not.
A request that carries a ``traceparent`` gets the retrospective
``engine.queue`` / ``engine.prefill`` / ``engine.decode`` spans when its
stream ends (engine.py:915-955), built from host monotonic stamps the
serving path takes as it passes: no device sync, nothing inside a burst.

Not ported yet (ROADMAP): the abort's and the deadline shed's flight
records and the dump (the engine has no flight ring, A9), the
admission's containment of a request that fails its prefill
deterministically, speculative decoding (and so logprobs under it),
LoRA, MoE, the tick budget, sleep/wake, KV export/import/checkpoint,
multimodal and prefill under CUDA graphs.

The step metrics and the perf ledger, stamped as JAX's engine stamps them
(engine.py:455-479, 1490-1550, 1610-1655; admission.py:464-504):
``step_metrics`` (engines/metrics.py) observes each reaped burst (dispatch
to readback, its occupancy and the tokens it emitted), each dispatch's
host gap (0 when a burst was already in flight) and in-flight depth, and
each prefill chunk round (its rows with tokens, its tokens); the
process-global perf ledger (runtime/perf_ledger.py), configured with the
preset, the device type as the backend, the host and the card's roofline
(runtime/roofline.py), gets the same bursts by shape (width bucket,
variant ``w{nb}[_logprobs][_procs]``, ``fused`` when the runner runs the
fused layer, else ``fallback``) with the dispatch and reap host split, and
each round's tokens/s by its pow2 chunk bucket; ``stop()`` stores the
ledger's fingerprints unless the engine failed terminally. The stamps are
host monotonic reads around calls the engine already makes: none syncs
the device or touches a graph.

The HBM ledger (``hbm``, JAX's categories, engine.py:494-509) samples the
runner's live tensors when the system server scrapes it: ``kv_cache`` counts
each pool's whole allocation, its sink block included (one block a pool
more than JAX's), ``lora`` is 0 (no LoRA, A7), and ``slot_state`` holds the
port's own fields and widths (int64 tokens, salts and bias ids, no adapter
ids), JAX's ``slot_tables`` being the port's ``slot_state["tables"]``.

All device work runs on one executor thread so the asyncio loop never
blocks on the card. Every block-pool call runs on the loop's thread, so the
pool's KV events (``on_kv_event``, as JaxEngine takes it) reach a
``router.publisher.KvEventPublisher`` there: its queue is an asyncio one.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import logging
import math
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from dynamo_tpu_torch.engines.gpu.block_pool import BlockPool, KvEvent
from dynamo_tpu_torch.engines.gpu.runner import DeviceRunner, _DecodeHandles
from dynamo_tpu_torch.engines.metrics import EngineStepMetrics
from dynamo_tpu_torch.llm.protocols.common import (
    BackendOutput,
    FinishReason,
    PreprocessedRequest,
    TokenLogprob,
)
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.logits_process import MAX_BIAS_SLOTS, pack_bias, prompt_hot
from dynamo_tpu_torch.runtime import fault_names
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.device_observe import HbmLedger, tree_device_bytes
from dynamo_tpu_torch.runtime.faults import fault_point, note_activity
from dynamo_tpu_torch.runtime.kv_reuse_observe import global_plane as kv_reuse_plane
from dynamo_tpu_torch.runtime import lifecycle
from dynamo_tpu_torch.runtime.lifecycle import trace_id_of
from dynamo_tpu_torch.runtime.perf_ledger import global_perf_ledger
from dynamo_tpu_torch.runtime.roofline import make_roofline_fn
from dynamo_tpu_torch.tokens.blocks import compute_block_hashes

logger = logging.getLogger(__name__)

# Block-table lookahead reserved by every decode burst, in bursts of
# decode_steps tokens (the JAX engine's PIPELINE_LOOKAHEAD_BURSTS).
LOOKAHEAD_BURSTS = 2
# Admission policy, at the JAX engine's defaults (JaxEngineArgs): rows per
# batched prefill, prefill batches per scheduler tick, pool headroom kept
# for running decodes, and the pool occupancy past which admission waits.
PREFILL_BATCH = 8
ADMIT_BATCHES_PER_TICK = 8
WATERMARK = 0.01
ADMIT_KV_HIGH_WATERMARK = 0.95
# Failed ticks in a row before the engine fails terminally
# (engine.py:1078), and the retry backoff's cap in seconds.
MAX_TICK_FAILURES = 5
TICK_BACKOFF_CAP_S = 2.0


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def table_width_bucket(max_blocks: int, cap: int) -> int:
    """Power-of-two bucket of a dispatched block-table width, clamped to
    the per-sequence table capacity (engine.py:259-267): each bucket is one
    captured decode graph, so contexts that grow add ~log2(cap) graphs, not
    one a width."""
    return min(_next_pow2(max(max_blocks, 1)), cap)


@dataclass
class TorchEngineArgs:
    """Engine knobs: the JaxEngineArgs fields this slice varies, plus the
    device (None = cuda; "cpu" runs the plain versions). Prefix caching is
    always on."""

    config: ModelConfig = field(default_factory=ModelConfig)
    block_size: int = 16
    num_kv_blocks: int = 512
    max_num_seqs: int = 8
    max_model_len: int = 1024
    prefill_chunk: int = 512
    seed: int = 0
    decode_steps: int = 8
    device: Optional[str] = None
    # "int8": per-channel weight-only int8 (ops/quant.py); random weights
    # are then made directly in int8 (models/quantize.py).
    quantization: Optional[str] = None
    # Fused-layer decode (ops/fused_layer.py): None = on when the config is
    # eligible and the device is cuda; True on an ineligible config raises.
    use_megakernel: Optional[bool] = None
    # KV pools: None = the model dtype; "int8" = int8 pools with per-token
    # scales (ops/kv_quant.py); "auto" = int8 at long max_model_len or under
    # pool pressure (resolved in place by DeviceRunner, as the JAX runner).
    kv_cache_dtype: Optional[str] = None
    # Decode bursts in flight (JaxEngineArgs.pipeline_depth): 1 reads each
    # burst back before dispatching the next; 2 keeps the next one queued.
    pipeline_depth: int = 2
    # Each decode width bucket's burst as one captured CUDA graph; needs
    # the card (True with device="cpu" raises). False runs the same burst
    # eagerly: the reference the graphs are held against.
    cuda_graphs: bool = True
    # Top logprobs a token carries at most (JaxEngineArgs.top_logprobs_cap):
    # a logprobs burst computes this many a step, and each request gets the
    # first min(logprobs, cap).
    top_logprobs_cap: int = 20

    @property
    def max_blocks_per_seq(self) -> int:
        return math.ceil(self.max_model_len / self.block_size)


@dataclass
class _Sequence:
    request: PreprocessedRequest
    context: Context
    queue: "asyncio.Queue[Optional[BackendOutput]]"
    prompt: List[int]
    all_tokens: List[int]  # prompt + generated
    generated: List[int] = field(default_factory=list)
    block_ids: List[int] = field(default_factory=list)
    block_hashes: List[int] = field(default_factory=list)  # committed prefix
    slot: int = -1
    salt: int = 0  # sampling salt (arrival order)
    # Host monotonic stamps for the phase spans (0.0 = not yet).
    t_enqueue: float = 0.0
    t_prefill_start: float = 0.0
    t_first_out: float = 0.0
    kv_roi: Optional[Dict[str, Any]] = None  # KvReusePlane.note_request's


@dataclass
class _InflightBurst:
    """A dispatched, not yet reaped decode burst (engine.py:_InflightBurst),
    with the stamps its reap reports to the step metrics and the perf
    ledger."""

    handles: _DecodeHandles
    seqs: List[Tuple[int, "_Sequence"]]  # (slot, sequence) rows it decodes
    t_dispatch: float = 0.0  # host monotonic time the dispatch began
    occupancy: int = 0  # rows it decodes
    nb_bucket: int = 0  # its table width bucket
    variant: str = ""  # w{nb}[_logprobs][_procs]
    dispatch_s: float = 0.0  # host time of the dispatch call
    avg_ctx: float = 0.0  # mean context its rows reach
    gap_s: float = 0.0  # host gap observed at its dispatch


@dataclass
class _ProcPrep:
    """A request's logits-processor parameters (engine.py:_ProcPrep)."""

    minp: float
    rep: float
    pres: float
    freq: float
    bias_ids: np.ndarray  # [MAX_BIAS_SLOTS] int32, -1 = empty
    bias_vals: np.ndarray  # [MAX_BIAS_SLOTS] float32


@dataclass
class _Prep:
    ids: List[int]
    hashes: List[int]
    matched: int
    matched_tokens: int
    sp: Tuple[float, int, float]
    procs: Optional[_ProcPrep] = None


def _logprob_entry(token: int, logprob: float, top, n_top: int) -> List[TokenLogprob]:
    """One token's logprobs: the sampled token first, then the request's
    top ``n_top`` ((id, logprob) pairs, best first; they may repeat the
    sampled token, as OpenAI's top_logprobs do)."""
    return [TokenLogprob(token_id=int(token), logprob=float(logprob))] + [
        TokenLogprob(token_id=int(t), logprob=float(v)) for t, v in list(top or [])[:n_top]]


class TorchEngine:
    """AsyncEngine over the port's model: ``generate(request, context)``."""

    def __init__(
        self,
        args: TorchEngineArgs,
        params: Optional[Any] = None,
        *,
        on_kv_event: Optional[Callable[[KvEvent], None]] = None,
    ) -> None:
        self.args = args
        self.config = args.config
        self.pool = BlockPool(args.num_kv_blocks, args.block_size, on_event=on_kv_event)
        self.runner = DeviceRunner(args, params)
        S = args.max_num_seqs
        self._slots: List[Optional[_Sequence]] = [None] * S
        self._pos = np.zeros(S, dtype=np.int32)  # tokens resident in cache
        self._block_tables = np.zeros((S, args.max_blocks_per_seq), dtype=np.int32)
        self._temp = np.ones(S, dtype=np.float32)
        self._topk = np.zeros(S, dtype=np.int32)
        self._topp = np.ones(S, dtype=np.float32)
        self._tok_mirror = np.zeros(S, dtype=np.int32)  # decode input token
        self._salts = np.zeros(S, dtype=np.int32)
        # Logits-processor mirrors of each slot (neutral when unused).
        self._uses_procs = np.zeros(S, dtype=bool)
        self._minp = np.zeros(S, dtype=np.float32)
        self._rep = np.ones(S, dtype=np.float32)
        self._pres = np.zeros(S, dtype=np.float32)
        self._freq = np.zeros(S, dtype=np.float32)
        self._bias_ids = np.full((S, MAX_BIAS_SLOTS), -1, dtype=np.int32)
        self._bias_vals = np.zeros((S, MAX_BIAS_SLOTS), dtype=np.float32)
        # Penalty bookkeeping resets of installed slots, applied on the device
        # thread before the next dispatch: (slot, prompt, generated, first);
        # first is None for an abort's rebuild, whose generated holds it.
        self._proc_resets: List[Tuple[int, List[int], List[int], Optional[int]]] = []
        self._next_salt = 0
        # Slots whose device state or table row differs from these mirrors,
        # synced at the next dispatch (engine.py:404-410).
        self._dirty_state: set = set(range(S))
        self._dirty_tables: set = set(range(S))
        self._inflight: "collections.deque[_InflightBurst]" = collections.deque()
        self._waiting: "collections.deque[_Sequence]" = collections.deque()
        self._loop_task: Optional[asyncio.Task] = None
        self._stopped = asyncio.Event()
        self._wake = asyncio.Event()
        self._failure: Optional[str] = None  # terminal engine failure
        self._consecutive_tick_failures = 0
        self._executor = ThreadPoolExecutor(1, thread_name_prefix="torch-engine")
        self.steps = 0  # decode bursts
        self.prefill_tokens = 0
        self.generated_tokens = 0
        self.preemptions = 0
        # Requests finished at dequeue because their deadline had expired
        # while they waited (typed timeout, no prefill spent).
        self.deadline_sheds = 0
        # Brownout lever (runtime/overload.py): kept and honoured by the
        # speculative decode, which the port does not have yet (A5).
        self._spec_suspended = False
        runner = self.runner
        # Step-loop metric families (registered on the system server by
        # attach_engine) and the process-global perf ledger with this
        # engine's identity (the fingerprint key) and roofline; configure()
        # also loads any persisted fingerprints (a corrupt file is a
        # counted cold start).
        self.step_metrics = EngineStepMetrics()
        self._perf = global_perf_ledger()
        self._perf.configure(
            preset=self.config.name,
            backend=runner.device.type,
            host=socket.gethostname(),
            roofline_fn=make_roofline_fn(self.config, args.quantization),
        )
        self._t_last_ready: Optional[float] = None  # the last burst's readback
        self.hbm = HbmLedger(runner.device)
        self.hbm.register("kv_cache", lambda: tree_device_bytes((runner.k_cache, runner.v_cache)))
        self.hbm.register("params", lambda: tree_device_bytes(runner.params))
        self.hbm.register("slot_state", lambda: tree_device_bytes(
            [t for name, t in runner.slot_state.items() if name != "tables"]))
        self.hbm.register("slot_tables", lambda: tree_device_bytes(runner.slot_state["tables"]))
        self.hbm.register("lora", lambda: 0)
        self.hbm.register("proc_state", lambda: tree_device_bytes(runner.proc_state))

    # -- lifecycle ---------------------------------------------------------

    async def _device(self, fn, *a, **kw):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._executor, lambda: fn(*a, **kw))

    @contextlib.contextmanager
    def device_held(self) -> Iterator[None]:
        """Park the device thread for the block: no work of this engine
        reaches the card until the block ends, and what the scheduler
        queues meanwhile runs after it. A profiler's stop runs inside it
        (runtime/system_server.attach_engine): Kineto's stop, without the
        GIL, and a graph launch on this thread can deadlock."""
        parked, release = threading.Event(), threading.Event()
        try:
            self._executor.submit(lambda: (parked.set(), release.wait()))
        except RuntimeError:  # shut down: nothing reaches the card
            yield
            return
        parked.wait()
        try:
            yield
        finally:
            release.set()

    async def start(self) -> None:
        if self._loop_task is None:
            self._loop_task = asyncio.get_running_loop().create_task(
                self._scheduler_loop(), name="torch-engine-scheduler"
            )

    async def stop(self) -> None:
        self._stopped.set()
        self._wake.set()
        if self._loop_task is not None:
            await self._loop_task
            self._loop_task = None
        self._executor.shutdown(wait=True)
        # A clean shutdown persists the fingerprints this run earned; after
        # a terminal tick failure the windows describe a degraded engine,
        # and a degraded baseline is worse than none.
        if self._failure is None:
            self._perf.store_fingerprints()

    def stats(self) -> Dict[str, Any]:
        return {
            "active_seqs": sum(1 for s in self._slots if s is not None),
            "waiting": len(self._waiting),
            "kv_usage": self.pool.usage,
            "free_blocks": self.pool.free_blocks,
            "cached_blocks": self.pool.cached_blocks,
            "total_blocks": self.args.num_kv_blocks,
            "decode_steps": self.steps,
            "prefill_tokens": self.prefill_tokens,
            "generated_tokens": self.generated_tokens,
            "preemptions": self.preemptions,
            "nonfinite_logit_rows": self.runner.nonfinite_rows,
            "mk_fused_bursts": self.runner.mk_fused_bursts,
            "pipeline_depth": self._pipeline_depth(),
            "inflight_bursts": len(self._inflight),
            "decode_graphs": len(self.runner.graphs),
            "graph_replays": sum(g.replays for g in self.runner.graphs.values()),
            "graph_capture_ms": self.runner.capture_ms,
            "eager_bursts": self.runner.eager_bursts,
            # Load-report inputs (router/publisher.py LoadPublisher), with the
            # JAX engine's meanings: the admission queue, the pool occupancy
            # past which admission waits, and the drain bit (no drain yet).
            "queue_depth": len(self._waiting),
            "kv_high_watermark": ADMIT_KV_HIGH_WATERMARK,
            "draining": 0,
            "deadline_sheds": self.deadline_sheds,
        }

    def kv_pool_bytes_breakdown(self) -> Dict[str, int]:
        """The KV pools' bytes by block state (active, cached, free, and the
        pools' sink blocks), for GET /debug/memory: they sum to
        ``total_bytes``, the ledger's ``kv_cache``."""
        total = tree_device_bytes((self.runner.k_cache, self.runner.v_cache))
        per_block = total // (self.args.num_kv_blocks + 1)  # + the sink block
        return {**self.pool.bytes_breakdown(per_block), "sink_bytes": per_block,
                "total_bytes": total}

    def clear_kv_blocks(self) -> int:
        """Flush the reusable prefix cache (ref: clear_kv_blocks.rs route).
        In-flight sequences keep their pinned blocks."""
        n = self.pool.cached_blocks
        self.pool.clear()
        return n

    def _pipeline_depth(self) -> int:
        return max(1, int(self.args.pipeline_depth))

    # -- request entry -----------------------------------------------------

    async def generate(self, request: Any, context: Context) -> AsyncIterator[BackendOutput]:
        await self.start()
        if isinstance(request, dict):
            request = PreprocessedRequest.from_dict(request)
        prompt = list(request.token_ids)
        error = None
        if not prompt:
            error = "empty prompt"
        elif len(prompt) >= self.args.max_model_len:
            error = (
                f"prompt length {len(prompt)} exceeds max_model_len "
                f"{self.args.max_model_len}"
            )
        elif math.ceil(len(prompt) / self.args.block_size) + 1 > self.args.num_kv_blocks:
            error = (
                f"prompt needs {math.ceil(len(prompt) / self.args.block_size)} KV "
                f"blocks + 1 for decode, but the pool only has {self.args.num_kv_blocks}"
            )
        elif self._failure is not None:
            error = f"engine failed: {self._failure}"
        elif request.lora_name:
            error = f"unknown LoRA adapter {request.lora_name!r} (LoRA is not ported yet)"
        if error is not None:
            yield BackendOutput(error=error, finish_reason=FinishReason.ERROR)
            return
        seq = _Sequence(
            request=request, context=context, queue=asyncio.Queue(),
            prompt=prompt, all_tokens=list(prompt), salt=self._next_salt,
        )
        self._next_salt = (self._next_salt + 1) & 0x7FFFFFFF
        seq.t_enqueue = time.monotonic()
        self._waiting.append(seq)
        self._wake.set()
        try:
            while True:
                out = await seq.queue.get()
                if out is None:
                    return
                if seq.t_first_out == 0.0 and out.token_ids:
                    seq.t_first_out = time.monotonic()
                yield out
                if out.finish_reason is not None:
                    return
        finally:
            self._export_phase_spans(seq)

    def _export_phase_spans(self, seq: _Sequence) -> None:
        """Retrospective engine.queue / engine.prefill / engine.decode
        spans for one finished stream (engine.py:915-955, less the
        handed-off stream's detach, which the drain plane brings). Built once
        a request from the monotonic stamps the serving path already took —
        nothing here runs inside a decode burst, and requests outside any
        trace cost one dict lookup."""
        if not seq.context.baggage.get("traceparent"):
            return
        try:
            from dynamo_tpu_torch.utils.tracing import export_span

            end = time.monotonic()
            t_admit = seq.t_prefill_start or seq.t_first_out or end
            export_span(
                "engine.queue", seq.context,
                start_mono=seq.t_enqueue or t_admit, end_mono=t_admit,
            )
            if seq.t_prefill_start:
                roi = seq.kv_roi or {}
                export_span(
                    "engine.prefill", seq.context,
                    start_mono=seq.t_prefill_start,
                    end_mono=seq.t_first_out or end,
                    prompt_tokens=len(seq.prompt),
                    cached_tokens=roi.get("cached_tokens"),
                    prefill_seconds_saved=roi.get("seconds_saved"),
                )
            if seq.t_first_out:
                export_span(
                    "engine.decode", seq.context,
                    start_mono=seq.t_first_out, end_mono=end,
                    generated=len(seq.generated),
                )
        except Exception:
            logger.debug("phase-span export failed", exc_info=True)

    def set_spec_suspended(self, suspended: bool) -> None:
        """Brownout lever (engine.py:1293-1305): park/restore speculative
        decode without touching the engine args (runtime/overload.py wires
        this to the healthy↔brownout transitions). The port has no
        speculative decode yet (A5), so, as JAX's engine with spec_mode
        off, it keeps the flag and wakes the loop."""
        suspended = bool(suspended)
        if suspended == self._spec_suspended:
            return
        self._spec_suspended = suspended
        self._wake.set()

    def _shed_expired(self, seq: _Sequence) -> None:
        """Finish a waiting sequence that stopped BEFORE admission
        (engine.py:1306-1330). A deadline expiry is a typed, client-visible
        error (the request's budget is gone — admitting it would burn
        prefill on work nobody is waiting for); a plain cancellation stays
        a quiet CANCELLED. JAX's engine also records a ``deadline_shed``
        flight event; this engine has no flight ring yet (A9)."""
        if seq.context.stop_reason == "deadline":
            self.deadline_sheds += 1
            note_activity("deadline_expired")
            seq.queue.put_nowait(
                BackendOutput(
                    error="deadline expired before admission "
                    "(shed at dequeue, no prefill spent)",
                    error_kind="timeout",
                    finish_reason=FinishReason.ERROR,
                )
            )
        else:
            seq.queue.put_nowait(BackendOutput(finish_reason=FinishReason.CANCELLED))

    # -- scheduler ---------------------------------------------------------

    async def _scheduler_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                # Admission installs into slots and allocates blocks: it must
                # see reconciled state, so the pipeline drains first, when a
                # waiting request has a free slot (engine.py:995-1004).
                if self._inflight and self._waiting and any(s is None for s in self._slots):
                    await self._drain_inflight()
                admitted = False
                for _ in range(ADMIT_BATCHES_PER_TICK):
                    if await self._admit_batch() == 0:
                        break
                    admitted = True
                if admitted:
                    # Prefill just ran on the device: the wait before the
                    # next decode dispatch is device-busy time, not a
                    # host-injected gap.
                    self._t_last_ready = None
                if any(s is not None for s in self._slots) or self._inflight:
                    await self._decode_tick()
                elif not admitted:
                    # Idle: request inter-arrival time is not host gap.
                    self._t_last_ready = None
                    self._wake.clear()
                    try:
                        await asyncio.wait_for(self._wake.wait(), timeout=0.05)
                    except asyncio.TimeoutError:
                        pass
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                # A failed tick may leave dispatched-but-unreaped bursts
                # whose device carry ran ahead of what was emitted: drop
                # them and resync from the host mirrors — the retried
                # bursts regenerate identical tokens (position-keyed RNG).
                self._abort_inflight()
                # Retry with exponential backoff (transient device hiccups
                # can span seconds), then treat the failure as terminal:
                # fail every pending request and refuse new ones. A sticky
                # CUDA error fails every retry and so reaches this bound.
                self._consecutive_tick_failures += 1
                logger.exception(
                    "torch engine scheduler tick failed (%d consecutive)",
                    self._consecutive_tick_failures,
                )
                if self._consecutive_tick_failures >= MAX_TICK_FAILURES:
                    self._fail_terminally(exc)
                    break
                await asyncio.sleep(
                    min(0.05 * 2 ** self._consecutive_tick_failures, TICK_BACKOFF_CAP_S)
                )
            else:
                self._consecutive_tick_failures = 0
        # Bursts in flight are dropped: every sequence is finished below.
        self._inflight.clear()
        reason = FinishReason.ERROR if self._failure else FinishReason.CANCELLED
        err = f"engine failed: {self._failure}" if self._failure else None
        for seq in self._slots:
            if seq is not None:
                self._finish(seq, reason, emit=False)
                seq.queue.put_nowait(BackendOutput(error=err, finish_reason=reason))
        while self._waiting:
            self._waiting.popleft().queue.put_nowait(
                BackendOutput(error=err, finish_reason=reason)
            )

    def _fail_terminally(self, exc: Exception) -> None:
        self._failure = f"{type(exc).__name__}: {exc}"
        logger.critical(
            "torch engine entering failed state: %s (tick strikes=%d)",
            self._failure, self._consecutive_tick_failures,
        )

    # -- admission (engines/tpu/admission.py) ------------------------------

    async def _admit_batch(self) -> int:
        """Admit and prefill up to PREFILL_BATCH waiting sequences in one
        [rows, C] device step per chunk round. Returns rows installed."""
        self._shed_stopped_waiters()
        free = [i for i, s in enumerate(self._slots) if s is None]
        if not free or not self._waiting:
            return 0
        batch: List[Tuple[_Sequence, _Prep]] = []
        limit = min(len(free), PREFILL_BATCH)
        while self._waiting and len(batch) < limit:
            seq = self._waiting[0]
            if (
                self.pool.usage >= ADMIT_KV_HIGH_WATERMARK
                and any(s is not None for s in self._slots)
            ):
                break
            self._waiting.popleft()
            prep = self._prepare_admission(seq)
            if prep is None:  # pool dry; seq was requeued to the front
                break
            batch.append((seq, prep))
        if not batch:
            return 0
        try:
            firsts = await self._prefill(batch)
        except BaseException:  # back to the queue, whose streams shutdown ends
            for seq, prep in reversed(batch):
                self.pool.release(prep.ids, prep.hashes[: prep.matched])
                self._requeue(seq)
            raise
        free_iter = (i for i, s in enumerate(self._slots) if s is None)
        for (seq, prep), first in zip(batch, firsts):
            self._install(seq, prep, next(free_iter), *first)
        return len(batch)

    def _shed_stopped_waiters(self) -> None:
        """Finish every waiting sequence whose context stopped, before any
        pool or prefill spend, wherever it stands in the queue and whether
        a slot is free or not. JAX's admission sheds only the head, when a
        slot frees (admission.py:106-114); a request expired behind a full
        engine then waits out the running streams, and past the TCP
        server's cancel grace its client gets no answer from the stream."""
        if not any(seq.context.stopped for seq in self._waiting):
            return
        kept: "collections.deque[_Sequence]" = collections.deque()
        for seq in self._waiting:
            if seq.context.stopped:
                self._shed_expired(seq)
            else:
                kept.append(seq)
        self._waiting = kept

    def _prepare_admission(self, seq: _Sequence) -> Optional[_Prep]:
        """Prefix match + block allocation for one sequence; None (after
        requeueing it) when the pool is dry."""
        args = self.args
        prompt = seq.all_tokens  # includes regenerated tokens after preemption
        n_blocks = math.ceil(len(prompt) / args.block_size)
        hashes = compute_block_hashes(prompt, args.block_size)
        matched, ids = self.pool.pin_prefix(hashes)
        matched_tokens = min(matched * args.block_size, len(prompt) - 1)
        # Watermark headroom so running decodes can still grow.
        headroom = (
            int(args.num_kv_blocks * WATERMARK)
            if any(s is not None for s in self._slots) else 0
        )
        if n_blocks - len(ids) + 1 + headroom > self.pool.free_blocks:
            self.pool.release(ids, hashes[:matched])
            self._requeue(seq)
            return None
        while len(ids) < n_blocks:
            b = self.pool.alloc()
            if b is None:
                self.pool.release(ids, hashes[:matched])
                self._requeue(seq)
                return None
            ids.append(b)
        seq.block_ids = ids
        seq.block_hashes = hashes[:matched]
        s = seq.request.sampling
        sp = (
            float(s.temperature if s.temperature is not None else 1.0),
            int(s.top_k if s.top_k is not None and s.top_k > 0 else 0),
            float(s.top_p if s.top_p is not None else 1.0),
        )
        return _Prep(ids=ids, hashes=hashes, matched=matched,
                     matched_tokens=matched_tokens, sp=sp, procs=self._procs_of(seq.request))

    def _procs_of(self, req: PreprocessedRequest) -> Optional[_ProcPrep]:
        """The request's processor parameters, or None when it uses none
        (admission.py:568-589): None keeps its bursts on the plain
        variant."""
        s = req.sampling
        rep = float(s.repetition_penalty) if s.repetition_penalty else 1.0
        pres = float(s.presence_penalty) if s.presence_penalty else 0.0
        freq = float(s.frequency_penalty) if s.frequency_penalty else 0.0
        minp = float(s.min_p) if s.min_p else 0.0
        bias = s.logit_bias
        if rep == 1.0 and pres == 0.0 and freq == 0.0 and minp <= 0.0 and not bias:
            return None
        ids, vals = pack_bias(bias, self.config.vocab_size)
        return _ProcPrep(minp=minp, rep=rep, pres=pres, freq=freq, bias_ids=ids, bias_vals=vals)

    async def _prefill(self, batch: List[Tuple[_Sequence, _Prep]]) -> List[Tuple[int, float, Any]]:
        """Joint chunked prefill to completion: one device step per chunk
        round, with per-row start and length. Returns each row's first
        sampled token, its logprob (0.0 unless a row asked for logprobs)
        and its top (id, logprob) pairs (None unless a row asked for
        top logprobs; admission.py:381-385)."""
        args = self.args
        rows = len(batch)
        prompts = [seq.all_tokens for seq, _ in batch]
        pos = [prep.matched_tokens for _, prep in batch]
        first: List[Optional[Tuple[int, float, Any]]] = [None] * rows
        sampling = [seq.request.sampling for seq, _ in batch]
        want_logprobs = any(s.logprobs is not None for s in sampling)
        want_top = any((s.logprobs or 0) > 0 for s in sampling)
        tables = np.zeros((rows, max(len(p.ids) for _, p in batch)), dtype=np.int32)
        temp = np.ones(rows, dtype=np.float32)
        topk = np.zeros(rows, dtype=np.int32)
        topp = np.ones(rows, dtype=np.float32)
        salts = np.zeros(rows, dtype=np.int32)
        for r, (seq, prep) in enumerate(batch):
            tables[r, : len(prep.ids)] = prep.ids
            temp[r], topk[r], topp[r] = prep.sp
            salts[r] = seq.salt
        procs = self._prefill_procs(batch)
        for seq, prep in batch:
            seq.t_prefill_start = time.monotonic()
            lifecycle.record(seq.request.request_id, "prefill_start", context=seq.context,
                             prompt_tokens=len(seq.all_tokens),
                             cached_tokens=prep.matched_tokens)
            # Cache-ROI attribution (admission.py:371-379): one feed an
            # admitted request, stamped into its trajectory when traced.
            seq.kv_roi = kv_reuse_plane().note_request(
                anchor=prep.hashes[prep.matched - 1] if prep.matched else None,
                cached_tokens=prep.matched_tokens,
                recomputed_tokens=len(seq.all_tokens) - prep.matched_tokens,
                trace_id=trace_id_of(seq.context),
            )
        while any(pos[r] < len(prompts[r]) for r in range(rows)):
            chunks = [prompts[r][pos[r] : pos[r] + args.prefill_chunk] for r in range(rows)]
            C = max(len(ch) for ch in chunks)
            tok = np.zeros((rows, C), dtype=np.int32)
            start = np.asarray(pos, dtype=np.int32)
            lens = np.zeros(rows, dtype=np.int32)
            for r, ch in enumerate(chunks):
                tok[r, : len(ch)] = ch
                lens[r] = len(ch)
            # Fresh prefills (first round, no prefix hit) attend densely
            # over the chunk itself: no paged reads.
            first_chunk = bool(np.all(start == 0))
            t0 = time.monotonic()
            out = await self._device(
                self.runner.run_step, tok, start, lens, tables, temp, topk, topp, salts,
                first_chunk=first_chunk, procs=procs, want_logprobs=want_logprobs,
                want_top=want_top,
            )
            dt = time.monotonic() - t0  # run_step read its tokens back
            # Occupancy counts rows still prefilling this round: short
            # prompts finish earlier rounds and ride along with lens 0.
            round_tokens = int(lens.sum())
            self.step_metrics.observe_prefill(dt, int(np.count_nonzero(lens)), round_tokens)
            # The perf ledger's prefill tokens/s by the round's pow2 chunk
            # bucket (admission.py:464-466).
            self._perf.observe_prefill(min(_next_pow2(C), args.prefill_chunk), dt,
                                       round_tokens)
            for r in range(rows):
                n = int(lens[r])
                if n == 0:
                    continue
                self.prefill_tokens += n
                pos[r] += n
                if pos[r] >= len(prompts[r]):
                    top = None
                    if out.top_vals is not None:
                        top = list(zip(out.top_ids[r].tolist(), out.top_vals[r].tolist()))
                    logp = float(out.logprobs[r]) if out.logprobs is not None else 0.0
                    first[r] = (int(out.tokens[r]), logp, top)
        return first

    def _prefill_procs(
        self, batch: List[Tuple[_Sequence, _Prep]],
    ) -> Optional[Dict[str, np.ndarray]]:
        """The prefill step's processor rows (admission.py:403-428), or None
        when no row uses a processor. Each row's mask holds all its tokens
        so far: after a preemption the repetition penalty keeps covering
        what it generated (presence and frequency count zero at this one
        sample; the output counts come back at install)."""
        if all(prep.procs is None for _, prep in batch):
            return None
        rows, V = len(batch), self.config.vocab_size
        procs = {"minp": np.zeros(rows, np.float32), "rep": np.ones(rows, np.float32),
                 "pres": np.zeros(rows, np.float32), "freq": np.zeros(rows, np.float32),
                 "bias_ids": np.full((rows, MAX_BIAS_SLOTS), -1, np.int32),
                 "bias_vals": np.zeros((rows, MAX_BIAS_SLOTS), np.float32),
                 "pmask": np.zeros((rows, V), np.bool_)}
        for r, (seq, prep) in enumerate(batch):
            p = prep.procs
            if p is None:
                continue
            for name in ("minp", "rep", "pres", "freq", "bias_ids", "bias_vals"):
                procs[name][r] = getattr(p, name)
            procs["pmask"][r] = prompt_hot(seq.all_tokens, V)
        return procs

    def _install(self, seq: _Sequence, prep: _Prep, slot: int, first_token: int,
                 first_logprob: float = 0.0, first_top=None) -> None:
        """Commit fresh prompt blocks and join the decode batch."""
        args = self.args
        prompt = seq.all_tokens
        for i in range(prep.matched, len(prompt) // args.block_size):
            parent = prep.hashes[i - 1] if i else None
            self.pool.commit(prep.ids[i], prep.hashes[i], parent)
            seq.block_hashes.append(prep.hashes[i])
        seq.slot = slot
        self._slots[slot] = seq
        self._pos[slot] = len(prompt)
        self._block_tables[slot, :] = 0
        self._block_tables[slot, : len(prep.ids)] = prep.ids
        self._temp[slot], self._topk[slot], self._topp[slot] = prep.sp
        self._salts[slot] = seq.salt
        self._tok_mirror[slot] = first_token
        self._dirty_state.add(slot)
        self._dirty_tables.add(slot)
        self._set_slot_procs(seq, slot, prep.procs, first_token)
        self._emit_token(seq, first_token, first_logprob, first_top)

    def _set_slot_procs(self, seq: _Sequence, slot: int, procs: Optional[_ProcPrep],
                        first_token: int) -> None:
        """A slot's processor mirrors (engine.py:2295-2318): neutral when its
        occupant uses none (a previous occupant's counts are then harmless);
        else its parameters, and a reset of its bookkeeping queued for the
        device thread: the request's prompt in the mask, the tokens generated
        so far (those of a preempted sequence re-admitted) and the first
        token (not in seq.generated yet) in the counts."""
        self._uses_procs[slot] = procs is not None
        if procs is None:
            self._minp[slot], self._rep[slot], self._pres[slot], self._freq[slot] = 0, 1, 0, 0
            self._bias_ids[slot] = -1
            self._bias_vals[slot] = 0.0
            return
        self._minp[slot], self._rep[slot] = procs.minp, procs.rep
        self._pres[slot], self._freq[slot] = procs.pres, procs.freq
        self._bias_ids[slot] = procs.bias_ids
        self._bias_vals[slot] = procs.bias_vals
        self._proc_resets.append((slot, list(seq.request.token_ids), list(seq.generated),
                                  int(first_token)))

    def _requeue(self, seq: _Sequence) -> None:
        seq.block_ids = []
        seq.block_hashes = []
        self._waiting.appendleft(seq)

    # -- decode ------------------------------------------------------------

    def _prepare_decode(self, lookahead: int) -> List[_Sequence]:
        """Finish cancelled/overlong sequences and make every survivor's
        blocks cover the next ``lookahead`` positions, preempting (youngest
        slot first) when the pool is dry."""
        args = self.args
        for slot in range(args.max_num_seqs - 1, -1, -1):
            seq = self._slots[slot]
            if seq is None:
                continue
            if seq.context.stopped:
                self._finish(seq, FinishReason.CANCELLED)
                continue
            pos = int(self._pos[slot])
            if pos >= args.max_model_len:
                self._finish(seq, FinishReason.LENGTH)
                continue
            last_pos = min(pos + lookahead - 1, args.max_blocks_per_seq * args.block_size - 1)
            need_blocks = last_pos // args.block_size + 1
            while len(seq.block_ids) < need_blocks:
                b = self.pool.alloc()
                if b is None:
                    self._preempt(seq)
                    break
                self._block_tables[slot, len(seq.block_ids)] = b
                seq.block_ids.append(b)
                self._dirty_tables.add(slot)
        return [s for s in self._slots if s is not None]

    async def _decode_tick(self) -> None:
        """Top the in-flight window up to ``pipeline_depth`` bursts, then
        reap the oldest (engine.py:1443-1455). At depth 1: dispatch, then
        reap."""
        while len(self._inflight) < self._pipeline_depth():
            if not await self._dispatch_burst():
                break
        if self._inflight:
            await self._reap_burst()

    def _blocks_shortfall(self, lookahead: int) -> int:
        """Blocks the next _prepare_decode would need beyond what the pool
        can serve (engine.py:1457): a non-positive shortfall means it
        allocates without preempting."""
        args = self.args
        need = 0
        for slot, seq in enumerate(self._slots):
            if seq is None:
                continue
            last_pos = min(int(self._pos[slot]) + lookahead - 1,
                           args.max_blocks_per_seq * args.block_size - 1)
            need += max(0, last_pos // args.block_size + 1 - len(seq.block_ids))
        return need - self.pool.free_blocks

    async def _dispatch_burst(self) -> bool:
        """Prepare and enqueue one burst; False when nothing decodes. Only
        dirty slot rows and table rows travel to the device."""
        args = self.args
        K = args.decode_steps
        lookahead = K * LOOKAHEAD_BURSTS
        # A preemption is decided on reconciled state only: reap while
        # growing the tables could run the pool dry (engine.py:1480-1488).
        while self._inflight and self._blocks_shortfall(lookahead) > 0:
            await self._reap_burst()
        active = self._prepare_decode(lookahead)
        if not active:
            return False
        state_sync = self._build_state_sync()
        table_sync = self._build_table_sync()
        resets, self._proc_resets = self._proc_resets, []
        # Host pos lags the device carry by K a burst in flight, so this
        # burst spans up to pos + (inflight + 1)·K: the bucket a depth-1
        # engine takes for the same burst.
        ctx_off = K * (len(self._inflight) + 1)
        ctxs = [int(self._pos[s.slot]) + ctx_off for s in active]
        max_blocks = max((ctx - 1) // args.block_size + 1 for ctx in ctxs)
        nb = table_width_bucket(max_blocks, args.max_blocks_per_seq)
        # the burst's variant (engine.py:1509-1512)
        want_logprobs = any(s.request.sampling.logprobs is not None for s in active)
        use_procs = any(self._uses_procs[s.slot] for s in active)
        had_inflight = bool(self._inflight)
        t0 = time.monotonic()
        # Chaos seam, deliberately AFTER the sync payloads were built (the
        # dirty sets are already cleared): recovery must resync every slot
        # from the mirrors (_abort_inflight), and the position-keyed RNG
        # must regenerate identical tokens on the retried burst.
        fault_point(fault_names.ENGINE_TICK_DISPATCH)
        handles = await self._device(self._dispatch_on_device, nb, state_sync, table_sync,
                                     want_logprobs, use_procs, resets)
        t_dispatched = time.monotonic()
        # Host gap: how long the card sat idle on host work between the
        # previous burst's readback and this dispatch; 0 when another burst
        # was already in flight (engine.py:1525-1534).
        gap = 0.0
        if self._t_last_ready is not None:
            gap = 0.0 if had_inflight else max(0.0, t0 - self._t_last_ready)
            self.step_metrics.observe_host_gap(gap)
        self.step_metrics.observe_inflight(len(self._inflight) + 1)
        self._inflight.append(_InflightBurst(
            handles=handles, seqs=[(s.slot, s) for s in active], t_dispatch=t0,
            occupancy=len(active), nb_bucket=nb,
            variant=f"w{nb}" + ("_logprobs" if want_logprobs else "")
            + ("_procs" if use_procs else ""),
            dispatch_s=t_dispatched - t0, avg_ctx=sum(ctxs) / len(active), gap_s=gap))
        return True

    def _dispatch_on_device(self, nb, state_sync, table_sync, want_logprobs=False,
                            use_procs=False, resets=()) -> _DecodeHandles:
        """Device-thread half of a dispatch: reset the penalty bookkeeping of
        newly installed slots, sync the dirty rows, enqueue."""
        for slot, prompt, generated, first in resets:
            self.runner.proc_reset_slot(slot, prompt, generated)
            if first is not None:
                self.runner.proc_count(slot, first)
        if state_sync is not None:
            self.runner.sync_slots(*state_sync)
        if table_sync is not None:
            self.runner.sync_tables(*table_sync)
        return self.runner.decode_dispatch(nb, want_logprobs, use_procs)

    def _build_state_sync(self):
        """(slots, rows) of the dirty slots for DeviceRunner.sync_slots;
        None when clean, the steady state (engine.py:1556-1583)."""
        if not self._dirty_state:
            return None
        slots = sorted(self._dirty_state)
        self._dirty_state.clear()
        sl = np.asarray(slots, dtype=np.int64)
        return slots, {
            "tokens": self._tok_mirror[sl], "pos": self._pos[sl],
            "active": np.asarray([int(self._slots[s] is not None) for s in slots], np.int32),
            "temp": self._temp[sl], "topk": self._topk[sl], "topp": self._topp[sl],
            "salts": self._salts[sl], "minp": self._minp[sl], "rep": self._rep[sl],
            "pres": self._pres[sl], "freq": self._freq[sl], "bias_ids": self._bias_ids[sl],
            "bias_vals": self._bias_vals[sl],
        }

    def _build_table_sync(self):
        if not self._dirty_tables:
            return None
        slots = sorted(self._dirty_tables)
        self._dirty_tables.clear()
        return slots, self._block_tables[np.asarray(slots, np.int64)].copy()

    async def _reap_burst(self) -> None:
        """Read back and emit the oldest burst in flight. A row whose
        sequence finished or was preempted while the burst was in flight is
        dropped (engine.py:1592-1656)."""
        # Chaos seam: a reap failure drops an in-flight burst whose device
        # carry ran ahead of emission — the abort path must roll back.
        fault_point(fault_names.ENGINE_TICK_REAP)
        rec = self._inflight.popleft()
        out = await self._device(self.runner.decode_read, rec.handles)
        self._t_last_ready = time.monotonic()
        self.steps += 1
        gen0 = self.generated_tokens
        for slot, seq in rec.seqs:
            if self._slots[slot] is not seq or seq.slot != slot:
                continue
            self._emit_burst(seq, out.tokens[slot],
                             *(None if a is None else a[slot]
                               for a in (out.logprobs, out.top_vals, out.top_ids)))
        # Emitted (post-stop-condition) tokens, not dispatched K x B; the
        # duration is dispatch to readback of THIS burst (queue-inclusive
        # at depth 2).
        emitted = self.generated_tokens - gen0
        self.step_metrics.observe_decode(time.monotonic() - rec.t_dispatch, rec.occupancy,
                                         emitted)
        # The same burst by shape, with the dispatch and reap host split;
        # the sentinel's comparison is time-gated inside evaluate().
        self._perf.observe_decode(
            rec.nb_bucket, rec.variant, "fused" if self.runner.use_megakernel else "fallback",
            self._t_last_ready - rec.t_dispatch, emitted, rec.occupancy, rec.avg_ctx,
            rec.gap_s, rec.dispatch_s, time.monotonic() - self._t_last_ready,
            now=self._t_last_ready,
        )
        self._perf.evaluate(now=self._t_last_ready)

    async def _drain_inflight(self) -> None:
        """Reap every burst in flight: the barrier before admission."""
        while self._inflight:
            await self._reap_burst()

    def _abort_inflight(self) -> None:
        """Failure path (engine.py:1664-1710): drop un-reaped bursts and
        resync EVERYTHING from the host mirrors. The device carry
        (pos/tokens) advanced past what was emitted; marking all slots dirty
        makes the next dispatch write every slot's state and table row back
        to the scheduler's view — the same tensors the decode graphs read —
        and the position-keyed sampling RNG makes the retried bursts
        regenerate the identical tokens. The JAX engine also records the
        abort in its flight ring and dumps the rings; this engine has no
        flight ring yet (ROADMAP A9)."""
        logger.error("aborted %d in-flight burst(s)", len(self._inflight))
        self._inflight.clear()
        self._dirty_state.update(range(self.args.max_num_seqs))
        self._dirty_tables.update(range(self.args.max_num_seqs))
        # Aborted processor bursts already advanced their slots' counts in
        # runner.proc_state, and a failed dispatch may have taken pending
        # install resets with it: rebuild every live penalty-using slot's
        # counts from the EMITTED history (on the device thread, before the
        # next dispatch), or the retry would penalize against wrong tallies.
        self._proc_resets = [
            (slot, list(seq.request.token_ids), list(seq.generated), None)
            for slot, seq in enumerate(self._slots)
            if seq is not None and self._uses_procs[slot]
        ]

    def _emit_burst(self, seq: _Sequence, toks: np.ndarray, logps: Optional[np.ndarray] = None,
                    topv: Optional[np.ndarray] = None, topi: Optional[np.ndarray] = None) -> None:
        """Apply stop conditions to one burst of a sequence's tokens and
        stream them as ONE BackendOutput, with each emitted token's
        logprobs when the request asked (engine.py::_emit_burst)."""
        slot = seq.slot
        req = seq.request
        stop = req.stop
        K = len(toks)
        base = len(seq.generated)
        arr = np.asarray(toks)

        def first_hit(token_ids) -> int:
            if not token_ids:
                return K
            m = np.isin(arr, token_ids)
            if stop.min_tokens is not None:
                m &= (base + np.arange(K) + 1) >= stop.min_tokens
            idx = np.flatnonzero(m)
            return int(idx[0]) if idx.size else K

        eos_k = K if stop.ignore_eos else first_hit(req.eos_token_ids or [])
        stop_k = first_hit(stop.stop_token_ids or [])
        len_k = K
        if stop.max_tokens is not None:
            len_k = min(max(stop.max_tokens - base - 1, 0), K)
        model_k = min(max(self.args.max_model_len - len(seq.all_tokens) - 1, 0), K)
        cut = min(eos_k, stop_k, len_k, model_k)
        reason: Optional[FinishReason] = None
        if cut < K:  # precedence at one position: EOS > STOP > LENGTH
            if cut == eos_k:
                reason = FinishReason.EOS
            elif cut == stop_k:
                reason = FinishReason.STOP
            else:
                reason = FinishReason.LENGTH
        n_take = cut + 1 if cut < K else K
        emitted = arr[:n_take].tolist()
        seq.generated.extend(emitted)
        seq.all_tokens.extend(emitted)
        self._tok_mirror[slot] = emitted[-1]
        self.generated_tokens += n_take
        self._pos[slot] += n_take  # these tokens' KV is now resident
        self._commit_complete_blocks(seq, slot)
        logprobs = None
        if req.sampling.logprobs is not None:
            n_top = self._n_top(req)
            logprobs = [
                _logprob_entry(t, logps[k],
                               None if topi is None else zip(topi[k].tolist(), topv[k].tolist()),
                               n_top)
                for k, t in enumerate(emitted)
            ]
        seq.queue.put_nowait(
            BackendOutput(token_ids=emitted, finish_reason=reason,
                          cumulative_tokens=len(seq.generated), logprobs=logprobs)
        )
        if reason is not None:
            self._finish(seq, reason, emit=False)

    def _n_top(self, req: PreprocessedRequest) -> int:
        return min(int(req.sampling.logprobs or 0), int(self.args.top_logprobs_cap))

    def _emit_token(self, seq: _Sequence, token: int, logprob: float = 0.0,
                    top=None) -> None:
        """The prefill's first token: append, check stops, stream (with its
        logprobs when the request asked)."""
        seq.generated.append(token)
        seq.all_tokens.append(token)
        self.generated_tokens += 1
        req = seq.request
        stop = req.stop
        n = len(seq.generated)
        min_ok = stop.min_tokens is None or n >= stop.min_tokens
        reason: Optional[FinishReason] = None
        if not stop.ignore_eos and min_ok and token in (req.eos_token_ids or []):
            reason = FinishReason.EOS
        elif min_ok and token in (stop.stop_token_ids or []):
            reason = FinishReason.STOP
        elif stop.max_tokens is not None and n >= stop.max_tokens:
            reason = FinishReason.LENGTH
        elif len(seq.all_tokens) >= self.args.max_model_len:
            reason = FinishReason.LENGTH
        logprobs = None
        if req.sampling.logprobs is not None:
            logprobs = [_logprob_entry(token, logprob, top, self._n_top(req))]
        seq.queue.put_nowait(
            BackendOutput(token_ids=[token], finish_reason=reason, cumulative_tokens=n,
                          logprobs=logprobs)
        )
        if reason is not None:
            self._finish(seq, reason, emit=False)

    def _commit_complete_blocks(self, seq: _Sequence, slot: int) -> None:
        args = self.args
        pos = int(self._pos[slot])
        while True:
            bi = len(seq.block_hashes)
            if (bi + 1) * args.block_size > pos or bi >= len(seq.block_ids):
                return
            parent = seq.block_hashes[-1] if seq.block_hashes else None
            h = compute_block_hashes(
                seq.all_tokens[bi * args.block_size : (bi + 1) * args.block_size],
                args.block_size, parent_hash=parent,
            )[0]
            self.pool.commit(seq.block_ids[bi], h, parent)
            seq.block_hashes.append(h)

    def _preempt(self, seq: _Sequence) -> None:
        """Release blocks and requeue for recompute; position-keyed sampling
        noise makes the recompute regenerate the same stream."""
        logger.warning("preempting request %s (KV pool exhausted)", seq.request.request_id)
        self.pool.release(seq.block_ids, seq.block_hashes)
        self._clear_slot(seq)
        self.preemptions += 1
        self._requeue(seq)

    def _clear_slot(self, seq: _Sequence) -> None:
        """Free the slot; the next dispatch deactivates its device row, and
        rows of it in a burst still in flight are dropped at reap."""
        if seq.slot >= 0:
            self._slots[seq.slot] = None
            self._pos[seq.slot] = 0
            self._tok_mirror[seq.slot] = 0
            self._dirty_state.add(seq.slot)
            seq.slot = -1

    def _finish(self, seq: _Sequence, reason: FinishReason, emit: bool = True) -> None:
        self.pool.release(seq.block_ids, seq.block_hashes)
        seq.block_ids = []
        seq.block_hashes = []
        self._clear_slot(seq)
        if emit:
            seq.queue.put_nowait(BackendOutput(finish_reason=reason))
