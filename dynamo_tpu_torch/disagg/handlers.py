"""Worker-side disaggregation handlers — the port's copy of
dynamo_tpu/disagg/handlers.py: ``PrefillHandler`` (a prefill worker's
``generate``: the prompt's KV and first token, and the bootstrap),
``KvTransferHandler`` (every worker's ``kv`` endpoint: committed blocks
streamed in chunks, wire v1 and v2) and ``DecodeHandler`` (a decode
worker's ``generate``: pull the bootstrap's blocks from the prefill
worker, with bounded retry from the last imported anchor, per-source
circuit breakers and the link-bandwidth EWMA, then generate, the imported
blocks hit by prefix-cached admission).

Reference parity: components/src/dynamo/vllm/handlers.py
(PrefillWorkerHandler :1469, DecodeWorkerHandler :1254) re-designed around
content-addressed KV blocks instead of NIXL descriptors.

Divergences from the JAX module: the wire's tensors are torch tensors on
the host (disagg/wire.py), and an engine's pool dtype maps to its wire tag
through ``wire.dtype_tag`` (``torch.bfloat16`` -> ``"bfloat16"``), where
JAX's goes through numpy's dtype names; a decode handler's new kv client
waits up to KV_CLIENT_LIST_S for its first instance listing before its
first pull, where JAX's pull fails once against the empty list and
retries (a transfer failure on every decode worker's first pull).
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

from dynamo_tpu_torch import config
from dynamo_tpu_torch.disagg.errors import DisaggTransferError, classify_failure
from dynamo_tpu_torch.disagg.wire import (
    WIRE_VERSION,
    KvWireBlocks,
    dtype_tag,
    pack_array,
    pack_kv,
    reply_wire_nbytes,
    unpack_array,
    unpack_reply,
    wire_block_bytes,
)
from dynamo_tpu_torch.llm.protocols.common import (
    BackendOutput,
    DisaggregatedParams,
    FinishReason,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime import fault_names, lifecycle, trajectory
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.device_observe import FlightRecorder
from dynamo_tpu_torch.runtime.faults import fault_point, note_activity
from dynamo_tpu_torch.runtime.liveness import (
    StaleIncarnationError,
    note_stale_drop,
    process_incarnation,
)
from dynamo_tpu_torch.tokens.blocks import compute_block_hashes
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tracing import export_span

logger = get_logger(__name__)

# Wire dtypes a v2 importer can install (every cell of the interop matrix
# lands in engine.import_blocks_wire_async). Advertised in the pull
# request's ``wire.accept`` so exporters ship pool-native.
ACCEPT_WIRE_DTYPES = ("int8", "bfloat16", "float32", "float16")

# EWMA weight for per-(src, dst) observed transfer bandwidth. One pull is a
# noisy sample (chunking, event-loop contention); 0.25 converges in a few
# pulls without letting one outlier swing the router's link-cost view.
LINK_BW_EWMA_ALPHA = 0.25

# The longest a new kv client waits for its first instance listing.
KV_CLIENT_LIST_S = 1.0

# Forget a source's bandwidth after this long without a pull from it.
# Without the TTL, a departed prefill worker's entry would be republished
# in every load report FOREVER — resurrecting the pairs the scheduler's
# remove_worker purged and leaking dead-worker gauge series.
LINK_BW_TTL_S = 600.0

# -- self-healing pull knobs (env-overridable; ctor args win) ----------------
# Bounded retry: attempts per pull (1 = the old single-shot behavior).
PULL_MAX_ATTEMPTS = config.PULL_ATTEMPTS.get()
# Exponential backoff between attempts: base × 2^(attempt-1), capped.
PULL_BACKOFF_BASE_S = config.PULL_BACKOFF_S.get()
PULL_BACKOFF_CAP_S = 2.0
# Per-ATTEMPT timeout when the request carries no deadline; with a
# deadline, each attempt gets min(this, time remaining) so a dead wire
# can never eat the whole request budget.
PULL_DEFAULT_TIMEOUT_S = config.PULL_TIMEOUT_S.get()
# Circuit breaker: consecutive pull failures from one src before the
# (src → this worker) pair opens, and how long it stays priced out of
# placement before the next pull is admitted as the half-open probe.
BREAKER_OPEN_AFTER = config.BREAKER_OPEN_AFTER.get()
BREAKER_COOLDOWN_S = config.BREAKER_COOLDOWN_S.get()


class CircuitBreaker:
    """Per-(src prefill worker) pull breaker.

    closed → open after ``open_after`` consecutive failures; open →
    half_open when ``allow()`` is first called after ``cooldown_s`` (that
    caller IS the probe; concurrent pulls fail fast until it resolves);
    half_open → closed on probe success, → open (fresh cooldown) on probe
    failure. ``advertised()`` is True only while open AND inside the
    cooldown window — that is the interval load reports carry the src in
    ``link_faults`` so the router prices the pair out of disagg placement;
    after the window the pair becomes placeable again and the first pull
    probes it.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(
        self,
        open_after: int = BREAKER_OPEN_AFTER,
        cooldown_s: float = BREAKER_COOLDOWN_S,
        *,
        clock=time.monotonic,
        on_transition=None,  # (old_state, new_state) -> None
    ) -> None:
        self.open_after = open_after
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._on_transition = on_transition
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0

    def _transition(self, new_state: str) -> None:
        if new_state == self.state:
            return
        old, self.state = self.state, new_state
        if new_state == self.OPEN:
            self.opened_at = self._clock()
        if self._on_transition is not None:
            self._on_transition(old, new_state)

    def allow(self) -> bool:
        """May a pull from this src proceed right now?"""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            if self._clock() - self.opened_at >= self.cooldown_s:
                self._transition(self.HALF_OPEN)
                return True  # this caller is the probe
            return False
        return False  # half-open: a probe is already in flight

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self._transition(self.CLOSED)

    def abort_probe(self) -> None:
        """The half-open probe was cancelled without resolving (client
        disconnect mid-pull): return to OPEN with a fresh cooldown.
        Without this the breaker wedges in HALF_OPEN forever — allow()
        never admits another probe and advertised() never prices the
        pair out. Not a failure: cancellation says nothing about the
        link, so the consecutive count is untouched."""
        if self.state == self.HALF_OPEN:
            self._transition(self.OPEN)

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == self.HALF_OPEN or (
            self.state == self.CLOSED
            and self.consecutive_failures >= self.open_after
        ):
            self._transition(self.OPEN)

    def advertised(self) -> bool:
        return (
            self.state == self.OPEN
            and self._clock() - self.opened_at < self.cooldown_s
        )


def _engine_wire_dtype(engine: Any) -> str:
    """Pool-native wire dtype tag of an engine's KV pool."""
    if getattr(engine.args, "kv_cache_dtype", None) == "int8":
        return "int8"
    return dtype_tag(engine.args.config.dtype)


def _engine_wire_block_bytes(engine: Any, wire_dtype: str) -> int:
    """Per-block wire bytes of an engine's export (k+v, scales included)."""
    cfg = engine.args.config
    return wire_block_bytes(
        cfg.n_layers, engine.args.block_size, cfg.n_kv_heads, cfg.head_dim_,
        wire_dtype,
    )


class DisaggMetrics:
    """Canonical disagg transfer families (runtime/metric_names.py
    ALL_DISAGG). One instance per DecodeHandler; ``render`` plugs into the
    system server's ``register_metrics`` seam. The handler's plain counters
    (``transfers``/``transfer_failures``/…) stay — tests and the aggregate
    rate math read them — these are their scrapeable form."""

    def __init__(self) -> None:
        from dynamo_tpu_torch.runtime import metric_names as mn
        from dynamo_tpu_torch.runtime.metrics_core import MetricsRegistry

        # a worker's families: bucket bounds as JAX's worker writes them
        self.registry = MetricsRegistry(kit_le=True)
        self.transfers = self.registry.counter(
            mn.DISAGG_TRANSFERS_TOTAL, "KV pulls from prefill workers"
        )
        self.transfer_failures = self.registry.counter(
            mn.DISAGG_TRANSFER_FAILURES_TOTAL,
            "Failed KV pull attempts by classified kind (timeout vs "
            "connection vs decode). An attempt that exhausts retries IS "
            "the 2x-cost path: a second full local prefill",
            ["error_kind"],
        )
        self.pull_retries = self.registry.counter(
            mn.DISAGG_PULL_RETRIES_TOTAL,
            "Retried pull attempts (anchor-resume: only the not-yet-"
            "imported tail re-rides the wire)",
        )
        self.breaker_transitions = self.registry.counter(
            mn.DISAGG_BREAKER_TRANSITIONS_TOTAL,
            "Per-src circuit-breaker transitions; an open breaker is "
            "advertised in load reports and prices the (src, this "
            "worker) pair out of disagg placement",
            ["src", "to"],
        )
        self.breaker_open = self.registry.gauge(
            mn.DISAGG_BREAKER_OPEN,
            "1 while the pull breaker for a src prefill worker is open",
            ["src"],
        )
        self.blocks_pulled = self.registry.counter(
            mn.DISAGG_BLOCKS_PULLED_TOTAL, "KV blocks imported from prefill"
        )
        self.bytes_pulled = self.registry.counter(
            mn.DISAGG_BYTES_PULLED_TOTAL, "KV bytes pulled over the wire"
        )
        self.kv_wire_bytes = self.registry.counter(
            mn.DISAGG_KV_WIRE_BYTES_TOTAL,
            "Serialized KV payload bytes pulled, by wire dtype — int8 vs "
            "dense is THE transfer-bound disagg lever",
            ["dtype"],
        )
        self.transfer_duration = self.registry.histogram(
            mn.DISAGG_TRANSFER_DURATION,
            "Wall time of one KV pull (request-scoped, chunks included)",
        )
        self.link_bandwidth = self.registry.gauge(
            mn.DISAGG_LINK_BANDWIDTH,
            "EWMA of observed KV transfer bandwidth per (src prefill "
            "worker, dst decode worker) pair — the router's link-cost "
            "input",
            ["src", "dst"],
        )
        self._link_source = None
        self._dst_label = "local"
        self._link_srcs: set = set()
        self._breaker_source = None
        self._breaker_srcs: set = set()
        self.registry.on_render(self._sample_links)
        self.registry.on_render(self._sample_breakers)

    def watch_links(self, bandwidth_fn, dst_label: str) -> None:
        """Sample ``bandwidth_fn()`` (src worker id → bytes/s EWMA) into
        the per-pair gauge at scrape time; series for sources that aged
        out of the EWMA table are dropped."""
        self._link_source = bandwidth_fn
        self._dst_label = dst_label

    def watch_breakers(self, states_fn) -> None:
        """Sample ``states_fn()`` (src worker id → CircuitBreaker) into the
        per-src open gauge at scrape time; departed srcs drop."""
        self._breaker_source = states_fn

    def _sample_links(self) -> None:
        if self._link_source is None:
            return
        live = set()
        for src, bw in self._link_source().items():
            label = str(src)
            live.add(label)
            self.link_bandwidth.set(bw, src=label, dst=self._dst_label)
        for gone in self._link_srcs - live:
            self.link_bandwidth.remove(src=gone, dst=self._dst_label)
        self._link_srcs = live

    def _sample_breakers(self) -> None:
        if self._breaker_source is None:
            return
        live = set()
        for src, breaker in self._breaker_source().items():
            label = str(src)
            live.add(label)
            self.breaker_open.set(
                0 if breaker.state == CircuitBreaker.CLOSED else 1, src=label
            )
        for gone in self._breaker_srcs - live:
            self.breaker_open.remove(src=gone)
        self._breaker_srcs = live

    def render(self, openmetrics: bool = False) -> str:
        return self.registry.render(openmetrics=openmetrics)


class PrefillHandler:
    """Serve a prefill worker: compute prompt KV + first token, return
    bootstrap metadata (ref: PrefillWorkerHandler.generate handlers.py:1498)."""

    def __init__(self, engine: Any, worker_id: int) -> None:
        self._engine = engine
        self.worker_id = worker_id

    async def generate(
        self, request: Any, context: Context
    ) -> AsyncIterator[BackendOutput]:
        req = (
            request
            if isinstance(request, PreprocessedRequest)
            else PreprocessedRequest.from_dict(dict(request))
        )
        prompt = list(req.token_ids)
        block_size = self._engine.args.block_size
        hashes = compute_block_hashes(prompt, block_size)
        prefill_req = PreprocessedRequest.from_dict(req.to_dict())
        prefill_req.stop.max_tokens = 1
        prefill_req.stop.min_tokens = None
        prefill_req.stop.ignore_eos = True

        first: Optional[BackendOutput] = None
        async for out in self._engine.generate(prefill_req, context):
            if out.error:
                yield out
                return
            if out.token_ids:
                first = out
                break
        if first is None:
            yield BackendOutput(
                error="prefill produced no token", finish_reason=FinishReason.ERROR
            )
            return
        wire_dtype = _engine_wire_dtype(self._engine)
        yield BackendOutput(
            token_ids=first.token_ids,
            logprobs=first.logprobs,
            cumulative_tokens=1,
            disaggregated_params=DisaggregatedParams(
                worker_id=self.worker_id,
                prefilled_tokens=len(prompt),
                kv_transfer={
                    "block_hashes": hashes,
                    "block_size": block_size,
                    "first_token": first.token_ids[0],
                    # Incarnation fencing: the decode worker's pull only
                    # trusts replies stamped with THIS incarnation — a
                    # restarted prefill worker no longer holds the
                    # promised blocks, and a zombie's pool is stale.
                    "incarnation": process_incarnation(),
                    # Transfer-cost inputs for link-aware decode placement
                    # (router/scheduler.py TransferContext): what one
                    # overlap-miss block costs on the wire from THIS worker.
                    "wire_dtype": wire_dtype,
                    "block_bytes": _engine_wire_block_bytes(
                        self._engine, wire_dtype
                    ),
                },
            ),
            finish_reason=FinishReason.LENGTH,
        )


# Target size of one streamed KV chunk. Bounds the host-memory spike and
# the serialization stall of a transfer (a 70B-class prompt's KV is
# hundreds of MB — as ONE message it blocks the event loop and doubles
# peak host memory; as ~8 MB chunks it pipelines: the exporter gathers
# chunk N+1 while chunk N is on the wire and the importer scatters chunk
# N-1, and the importer's engine keeps serving decode ticks between
# chunks). Ref: the reference streams device-direct chunked/overlapped
# (lib/llm/src/block_manager/block/transfer/cuda.rs:1, lib/memory/src/nixl/).
KV_CHUNK_BYTES = config.KV_CHUNK_BYTES.get()


class KvTransferHandler:
    """Serve content-addressed KV block export (the 'kv' side-channel
    endpoint; plays the role of the NIXL read target).

    Streams the payload as bounded chunks: each reply message carries
    ≤ ~KV_CHUNK_BYTES of blocks plus ``done`` on the final message. Device
    gathers happen per chunk, so HBM→host readback overlaps the previous
    chunk's network write instead of spiking once."""

    def __init__(self, engine: Any, chunk_bytes: Optional[int] = None) -> None:
        self._engine = engine
        self.chunk_bytes = chunk_bytes or KV_CHUNK_BYTES

    def _negotiate_wire_dtype(self, request: Any) -> Optional[str]:
        """Wire dtype this reply ships, or None for the v1 dense schema.

        A request without a ``wire`` envelope comes from a v1 importer:
        answer in the v1 shape (dense ``k``/``v``, int8 pools dequantized)
        so old decode workers keep interoperating. A v2 importer gets the
        pool-native form unless its ``accept`` list vetoes it — then the
        exporter ships a dense dtype the importer DID list (for any pool
        form, not just int8), falling back to the pool's dense dtype when
        the accept list names nothing we can produce."""
        wire_req = request.get("wire") or {}
        if int(wire_req.get("version") or 1) < WIRE_VERSION:
            return None
        native = _engine_wire_dtype(self._engine)
        accept = wire_req.get("accept")
        if not accept or native in accept:
            return native
        for cand in ("bfloat16", "float32", "float16"):
            if cand in accept:
                return cand
        return (
            dtype_tag(self._engine.args.config.dtype)
            if native == "int8" else native
        )

    def _blocks_per_chunk(self, wire_dtype: Optional[str] = None) -> int:
        """Chunk sizing by the bytes THIS reply actually ships: v1 replies
        (wire_dtype None) densify int8 pools to the v1 bf16 wire, so they
        must be sized by the dense block, not the pool-native one."""
        if wire_dtype is None:
            wire_dtype = (
                "bfloat16" if _engine_wire_dtype(self._engine) == "int8"
                else dtype_tag(self._engine.args.config.dtype)
            )
        block_bytes = _engine_wire_block_bytes(self._engine, wire_dtype)
        return max(1, self.chunk_bytes // max(block_bytes, 1))

    async def generate(self, request: Any, context: Context) -> AsyncIterator[dict]:
        hashes: List[int] = list(request.get("block_hashes") or [])
        wire_dtype = self._negotiate_wire_dtype(request)
        per = self._blocks_per_chunk(wire_dtype)
        # Every reply chunk carries the exporter's incarnation so the
        # importer can fence a zombie/restarted exporter's payload.
        inc = process_incarnation()
        sent_any = False
        for off in range(0, len(hashes), per):
            chunk = hashes[off : off + per]
            # Chaos seam: an export failing mid-stream kills this reply
            # stream; the puller classifies it and retries from its last
            # imported anchor.
            fault_point(fault_names.DISAGG_KV_EXPORT, off=off)
            if wire_dtype is None:
                # v1 importer: dense k/v fields.
                found, k, v = await self._engine.export_blocks_async(chunk)
                if not found:
                    break  # chain broken (evicted): stop at last good run
                sent_any = True
                done = off + per >= len(hashes) or len(found) < len(chunk)
                yield {
                    "found": found,
                    "k": pack_array(k),
                    "v": pack_array(v),
                    "done": done,
                    "inc": inc,
                }
            else:
                found, wire = await self._engine.export_blocks_wire_async(chunk)
                if not found:
                    break
                if wire.dtype != wire_dtype:
                    # negotiated down: ship the dense dtype the importer
                    # accepted (dequant or cast)
                    wire = KvWireBlocks.dense(*wire.to_dense(wire_dtype))
                sent_any = True
                done = off + per >= len(hashes) or len(found) < len(chunk)
                yield {"found": found, "kv": pack_kv(wire), "done": done,
                       "inc": inc}
            if len(found) < len(chunk):
                return
        if not sent_any:
            yield {"found": [], "kv": None, "k": None, "v": None,
                   "done": True, "inc": inc}


class DecodeHandler:
    """Serve a decode worker: import transferred KV (if the request carries
    disaggregated_params), then generate normally — prefix-cached admission
    picks up the imported blocks (ref: DecodeWorkerHandler handlers.py:1254)."""

    def __init__(
        self, engine: Any, kv_client_factory=None,
        *, worker_id: Optional[int] = None,
        fallback_local_prefill: bool = True,
        pull_attempts: Optional[int] = None,
        pull_timeout_s: Optional[float] = None,
        breaker_open_after: Optional[int] = None,
        breaker_cooldown_s: Optional[float] = None,
        backoff_base_s: Optional[float] = None,
    ) -> None:
        self._engine = engine
        # async () -> Client for the prefill component's "kv" endpoint
        self._kv_client_factory = kv_client_factory
        self._kv_client = None
        # This worker's identity — the ``dst`` of every (src prefill
        # worker, dst decode worker) bandwidth pair it measures.
        self.worker_id = worker_id
        # Strict disagg: with fallback disabled, a terminally-failed pull
        # raises DisaggTransferError (MIGRATABLE) instead of silently
        # re-prefilling — the frontend re-dispatches to another worker.
        self.fallback_local_prefill = fallback_local_prefill
        self.pull_attempts = pull_attempts or PULL_MAX_ATTEMPTS
        self.pull_timeout_s = pull_timeout_s or PULL_DEFAULT_TIMEOUT_S
        self.backoff_base_s = (
            PULL_BACKOFF_BASE_S if backoff_base_s is None else backoff_base_s
        )
        self._breaker_open_after = breaker_open_after or BREAKER_OPEN_AFTER
        self._breaker_cooldown_s = breaker_cooldown_s or BREAKER_COOLDOWN_S
        # Observability for the fallback path: a transfer failure silently
        # converting into a second full prefill is a 2× cost bug that must
        # be visible in metrics.
        self.transfers = 0
        self.transfer_failures = 0
        self.transfer_failures_by_kind: Dict[str, int] = {}
        self.pull_retries = 0
        self.pull_fallbacks = 0  # pulls that gave up (the real 2× path)
        self.breaker_opens = 0
        self.blocks_pulled = 0
        self.bytes_pulled = 0
        # Serialized KV payload bytes by wire dtype (the kv_wire_bytes_total
        # counter's host-side mirror; bench reads this).
        self.wire_bytes_by_dtype: Dict[str, int] = {}
        self.transfer_seconds = 0.0  # summed per-pull elapsed (can overlap)
        # Window edges for aggregate-rate math: concurrent pulls overlap,
        # so bytes / (last_end - first_start) is the honest achieved rate
        # while summed per-pull seconds would understate it.
        self.transfer_first_start = 0.0
        self.transfer_last_end = 0.0
        # src prefill worker id → (EWMA pull bandwidth B/s, last-pull
        # monotonic). Seeds the router's link-cost model via load reports
        # (router/publisher.py link_bandwidth_fn); entries not refreshed
        # within LINK_BW_TTL_S age out so a departed prefill worker stops
        # being republished (and can't resurrect scheduler-purged pairs).
        self._link_bw: Dict[int, Tuple[float, float]] = {}
        # src prefill worker id → CircuitBreaker over pulls from it.
        self._breakers: Dict[int, CircuitBreaker] = {}
        # Retry/breaker history for post-mortems. Single writer: every
        # record happens on the handler's event loop.
        self.flight = FlightRecorder("disagg", capacity=512)
        self.metrics = DisaggMetrics()
        self.metrics.watch_links(
            self.link_bandwidth,
            str(worker_id) if worker_id is not None else "local",
        )
        self.metrics.watch_breakers(lambda: dict(self._breakers))

    def link_bandwidth(self) -> Dict[int, float]:
        """src prefill worker id → EWMA observed transfer bandwidth, B/s
        (sources without a pull in LINK_BW_TTL_S are pruned)."""
        now = time.monotonic()
        self._link_bw = {
            src: (bw, at) for src, (bw, at) in self._link_bw.items()
            if now - at < LINK_BW_TTL_S
        }
        return {src: bw for src, (bw, _) in self._link_bw.items()}

    def _observe_link(self, src: int, nbytes: int, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 0:
            return
        bw = nbytes / seconds
        prev = self._link_bw.get(src)
        self._link_bw[src] = (
            bw if prev is None
            else LINK_BW_EWMA_ALPHA * bw + (1 - LINK_BW_EWMA_ALPHA) * prev[0],
            time.monotonic(),
        )

    def register_metrics(self, server: Any) -> None:
        """Expose this handler's transfer families on a SystemStatusServer."""
        server.register_metrics(self.metrics.render)
        server.register_flight(self.flight.name, self.flight.snapshot)

    # -- circuit breaker ----------------------------------------------------

    def _breaker_for(self, src: int) -> CircuitBreaker:
        breaker = self._breakers.get(src)
        if breaker is None:
            def on_transition(old: str, new: str, _src=src) -> None:
                self.flight.record(
                    "breaker", src=_src, frm=old, to=new,
                )
                self.metrics.breaker_transitions.inc(src=str(_src), to=new)
                if new == CircuitBreaker.OPEN:
                    self.breaker_opens += 1
                    note_activity("breaker_opens")

            breaker = CircuitBreaker(
                self._breaker_open_after, self._breaker_cooldown_s,
                on_transition=on_transition,
            )
            self._breakers[src] = breaker
        return breaker

    def open_breaker_srcs(self) -> List[int]:
        """src prefill worker ids whose breaker is inside its open window —
        published in load reports (LoadSnapshot.link_faults) so the
        router's LinkCostModel prices the (src, this worker) pair out of
        disagg placement until the half-open probe window. Non-int keys
        (a bootstrap that omitted worker_id breakers under None) are not
        publishable as link pairs and are excluded — the router could
        neither normalize nor match them."""
        return sorted(
            src for src, b in self._breakers.items()
            if isinstance(src, int) and b.advertised()
        )

    def _first_missing(self, hashes: List[int]) -> Optional[int]:
        """Index of the first block NOT resident in the pool, or None when
        the whole chain is already installed. Recomputed before every
        attempt: blocks committed by a failed attempt stay committed, so a
        retry resumes from the last imported anchor instead of re-pulling
        (anchor-resume — the wire only ever carries the missing tail)."""
        pool = self._engine.pool
        for i, h in enumerate(hashes):
            if not pool.contains(h):
                return i
        return None

    def _attempt_timeout(self, context: Optional[Context]) -> Optional[float]:
        """Per-attempt wall budget: the configured timeout, shrunk to the
        request's remaining Context deadline when it carries one."""
        remaining = context.time_remaining() if context is not None else None
        if remaining is None:
            return self.pull_timeout_s
        return min(self.pull_timeout_s, remaining)

    async def _pull_once(
        self,
        want: List[int],
        anchor: Optional[int],
        src: Optional[int],
        acct: Dict[str, int],
        expect_inc: Optional[int] = None,
    ) -> None:
        """One pull attempt over the missing tail. Chunked: each reply is a
        bounded slice, imported as it lands — device scatters and the
        decode loop's ticks interleave with the next chunk's network read
        instead of waiting for one monolithic payload. Wire bytes are
        accounted at RECEIPT (a chunk that lands but fails to import still
        crossed the network — the accounting the anchor-resume tests
        assert), blocks at successful import. Progress accumulates into
        ``acct`` IN PLACE (not a return value): a raising attempt's
        partial imports/bytes must survive into the pull's totals, and
        ``self.bytes_pulled`` deltas can't be used — concurrent pulls
        would attribute each other's bytes to their own link."""
        if self._kv_client is None:
            client = await self._kv_client_factory()
            # A new client learns the instances from discovery's watch a
            # moment after it is made (discd's snapshot arrives
            # asynchronously): wait for the first listing, bounded, so that
            # the first pull of a decode worker does not fail against an
            # empty list. JAX's handler fails that pull once and retries.
            if hasattr(client, "wait_for_instances"):
                try:
                    await client.wait_for_instances(timeout=KV_CLIENT_LIST_S)
                except asyncio.TimeoutError:
                    pass
            self._kv_client = client
        async for reply in self._kv_client.direct(
            {
                "op": "export",
                "block_hashes": want,
                # Schema v2 negotiation: ship pool-native (int8 stays
                # int8 on the wire); v1 exporters ignore this and reply
                # dense.
                "wire": {
                    "version": WIRE_VERSION,
                    "accept": list(ACCEPT_WIRE_DTYPES),
                },
            }, src
        ):
            # Incarnation fence: the bootstrap named the incarnation that
            # computed (and promised) these blocks. A reply stamped with
            # any OTHER incarnation — a zombie's late chunks, or a
            # restarted exporter whose pool no longer holds them — is
            # counted and dropped, never scattered into our pool.
            reply_inc = reply.get("inc")
            if (
                expect_inc and reply_inc is not None
                and reply_inc != expect_inc
            ):
                note_stale_drop("pull_reply")
                raise StaleIncarnationError(
                    f"KV pull reply from prefill worker {src} carries "
                    f"incarnation {reply_inc}, bootstrap promised "
                    f"{expect_inc} — the worker restarted; re-prefill"
                )
            found = reply.get("found") or []
            wire = unpack_reply(reply)
            if not found or wire is None:
                break
            chunk_bytes = reply_wire_nbytes(reply)
            acct["bytes"] += chunk_bytes
            self.bytes_pulled += chunk_bytes
            self.wire_bytes_by_dtype[wire.dtype] = (
                self.wire_bytes_by_dtype.get(wire.dtype, 0) + chunk_bytes
            )
            self.metrics.bytes_pulled.inc(chunk_bytes)
            self.metrics.kv_wire_bytes.inc(chunk_bytes, dtype=wire.dtype)
            # Chaos seams: the wire dying with this chunk received but not
            # imported, and the import (device scatter) itself failing.
            fault_point(fault_names.DISAGG_PULL_CHUNK, src=src)
            fault_point(fault_names.DISAGG_KV_IMPORT, src=src)
            n = await self._engine.import_blocks_wire_async(
                found, wire, anchor_parent=anchor
            )
            acct["blocks"] += n
            self.blocks_pulled += n
            self.metrics.blocks_pulled.inc(n)
            if n < len(found):
                # Pool dry mid-chunk: anchoring later chunks on an
                # uninstalled hash would commit children whose parent
                # never committed (pool invariant) and every further
                # chunk would transfer + scatter into a full pool.
                logger.warning(
                    "KV pool dry after importing %d/%d blocks of a "
                    "chunk; stopping the pull early", n, len(found),
                )
                break
            anchor = found[-1]
            if reply.get("done", True):
                break

    async def _pull_blocks(
        self,
        dp: DisaggregatedParams,
        context: Optional[Context] = None,
        trace_id: Optional[str] = None,
    ) -> int:
        info = dp.kv_transfer or {}
        hashes = list(info.get("block_hashes") or [])
        if not hashes or self._kv_client_factory is None:
            return 0
        # Skip blocks already resident (earlier transfer or shared prefix).
        if self._first_missing(hashes) is None:
            return 0
        src = dp.worker_id
        expect_inc = info.get("incarnation")
        breaker = self._breaker_for(src)
        if not breaker.allow():
            # Fail fast: the (src → me) link is open-circuit. No wire time
            # is spent; either re-prefill locally or hand the stream back
            # for migration to a worker with a working link.
            self.flight.record("pull_rejected", src=src, state=breaker.state)
            self.pull_fallbacks += 1
            if not self.fallback_local_prefill:
                raise DisaggTransferError(
                    f"pull breaker for prefill worker {src} is "
                    f"{breaker.state}; local prefill fallback disabled"
                )
            return 0
        self.transfers += 1
        self.metrics.transfers.inc()
        t0 = time.monotonic()
        if not self.transfer_first_start:
            self.transfer_first_start = t0
        self.flight.record("pull_start", src=src, blocks=len(hashes))
        # Trajectory span events: each retry/terminal failure is stamped
        # onto the pull span so the stitched view shows WHERE the
        # kv_transfer phase's time went (attempt boundaries, error kinds).
        span_events: List[Dict[str, Any]] = []
        # Per-PULL progress, mutated inside _pull_once so a raising
        # attempt's partial imports survive, and isolated from concurrent
        # pulls (which share self.bytes_pulled).
        acct = {"blocks": 0, "bytes": 0}
        last_error: Optional[BaseException] = None
        attempt = 0
        while True:
            attempt += 1
            missing_from = self._first_missing(hashes)
            if missing_from is None:
                break  # everything landed
            want = hashes[missing_from:]
            # The block the next chunk chains from: the last resident
            # block before the missing run (imports from the FAILED
            # attempt included — that is the resume point).
            anchor = hashes[missing_from - 1] if missing_from > 0 else None
            timeout = self._attempt_timeout(context)
            try:
                if timeout is not None and timeout <= 0:
                    raise asyncio.TimeoutError(
                        "request deadline exhausted before the pull"
                    )
                await asyncio.wait_for(
                    self._pull_once(want, anchor, src, acct, expect_inc),
                    timeout,
                )
                breaker.record_success()
                break
            except asyncio.CancelledError:
                # Cancellation resolves nothing about the link: if this
                # attempt was the half-open probe, hand the breaker back
                # to OPEN (a wedged HALF_OPEN admits no further probes).
                breaker.abort_probe()
                raise
            except Exception as exc:
                kind = classify_failure(exc)
                last_error = exc
                self.transfer_failures += 1
                self.transfer_failures_by_kind[kind] = (
                    self.transfer_failures_by_kind.get(kind, 0) + 1
                )
                self.metrics.transfer_failures.inc(error_kind=kind)
                breaker.record_failure()
                self.flight.record(
                    "pull_error", src=src, attempt=attempt,
                    error_kind=kind, error=f"{type(exc).__name__}: {exc}",
                )
                remaining = (
                    context.time_remaining() if context is not None else None
                )
                if (
                    attempt >= self.pull_attempts
                    or not breaker.allow()
                    or (remaining is not None and remaining <= 0)
                ):
                    logger.exception(
                        "KV pull from prefill worker %s failed terminally "
                        "(%s, attempt %d/%d) after %d blocks",
                        src, kind, attempt, self.pull_attempts,
                        acct["blocks"],
                    )
                    break
                self.pull_retries += 1
                self.metrics.pull_retries.inc()
                note_activity("pull_retries")
                span_events.append({
                    "name": f"retry:{kind}", "time_s": time.time(),
                })
                trajectory.note_event(
                    trace_id, "disagg", "pull_retry",
                    src=src, attempt=attempt, error_kind=kind,
                )
                delay = min(
                    self.backoff_base_s * 2 ** (attempt - 1),
                    PULL_BACKOFF_CAP_S,
                )
                if remaining is not None:
                    delay = min(delay, remaining)
                logger.warning(
                    "KV pull from prefill worker %s failed (%s, attempt "
                    "%d/%d); resuming from anchor after %d imported blocks "
                    "in %.3fs",
                    src, kind, attempt, self.pull_attempts,
                    acct["blocks"], delay,
                )
                if delay > 0:
                    await asyncio.sleep(delay)
        now = time.monotonic()
        self.transfer_seconds += now - t0
        self.transfer_last_end = now
        # Per-(src, dst) bandwidth: this pull's achieved rate feeds the
        # EWMA the router's link-cost model consumes via load reports.
        self._observe_link(src, acct["bytes"], now - t0)
        # Exemplar: a transfer-latency spike on a dashboard resolves to the
        # trace (and thus the /debug/requests timeline) that caused it.
        self.metrics.transfer_duration.observe(now - t0, trace_id=trace_id)
        pull_ok = last_error is None or self._first_missing(hashes) is None
        self.flight.record(
            "pull_done", src=src, blocks=acct["blocks"],
            bytes=acct["bytes"], attempts=attempt, ok=pull_ok,
        )
        if trace_id:
            # Trajectory kv_transfer phase span: the whole pull — retries
            # and backoff included — attributed in the stitched view.
            export_span(
                "disagg.pull", context,
                start_mono=t0, end_mono=now,
                proc=(
                    f"worker-{self.worker_id:#x}"
                    if isinstance(self.worker_id, int) else None
                ),
                status="ok" if pull_ok else "error: pull_failed",
                events=span_events,
                src=src, blocks=acct["blocks"], bytes=acct["bytes"],
                attempts=attempt, retries=attempt - 1,
            )
        if last_error is not None and self._first_missing(hashes) is not None:
            # Terminal failure: the chain is still incomplete.
            self.pull_fallbacks += 1
            if not self.fallback_local_prefill:
                raise DisaggTransferError(
                    f"KV pull from prefill worker {src} failed after "
                    f"{attempt} attempt(s): {last_error!r}; local prefill "
                    "fallback disabled"
                ) from last_error
            logger.warning(
                "decoding with local prefill after failed pull from "
                "worker %s (fallback #%d — a recurring fallback means "
                "every request pays prefill TWICE)",
                src, self.pull_fallbacks,
            )
        return acct["blocks"]

    async def generate(
        self, request: Any, context: Context
    ) -> AsyncIterator[BackendOutput]:
        req = (
            request
            if isinstance(request, PreprocessedRequest)
            else PreprocessedRequest.from_dict(dict(request))
        )
        if req.disaggregated_params is not None:
            t0 = time.monotonic()
            pulled = await self._pull_blocks(
                req.disaggregated_params,
                context=context,
                trace_id=lifecycle.trace_id_of(context),
            )
            lifecycle.record(
                req.request_id, "kv_transfer",
                context=context,
                blocks=pulled,
                worker=req.disaggregated_params.worker_id,
                duration_ms=round((time.monotonic() - t0) * 1000, 3),
            )
            if pulled:
                logger.info(
                    "imported %d KV blocks from prefill worker %s",
                    pulled, req.disaggregated_params.worker_id,
                )
        async for out in self._engine.generate(req, context):
            yield out
