"""DeviceRunner — owner of the device state (weights, KV pools, sampling
seed, decode slot state) and the device programs the scheduler calls;
counterpart of dynamo_tpu/engines/tpu/runner.py.

Prefill: ``run_step`` runs one chunk round from the scheduler's host
arrays. Decode, as the JAX runner's hot path (runner.py:392-438,
931-1130): the slot state every burst reads (``slot_state``: tokens, pos,
active, sampling parameters, salts and block tables of all
``max_num_seqs`` slots) lives on the device and changes only through
``sync_slots`` / ``sync_tables``, which write the rows the scheduler marked
dirty. ``decode_dispatch(nb)`` enqueues one burst (models/llama.
decode_burst) over the first ``nb`` table pages and returns at once; the
burst writes its carry (last token, advanced pos) back into the state, so
a steady-state burst moves no host bytes in. On the card each width
bucket's burst is one CUDA graph (``cuda_graphs``), captured at its first
use right after that burst ran eagerly on the capture stream, and replayed
after; the graphs share one memory pool. The outputs go to pinned host
buffers by non-blocking copies, one buffer set per burst in flight, and
``decode_read`` waits on the burst's event. ``run_decode`` is the
synchronous form (sync every row, dispatch, read).

Logprobs and logits processors (runner.py:443-460, 650-700, 818-845): a
burst is keyed (width bucket, want_logprobs, use_procs), as the JAX
programs are, and each variant is its own graph, captured the first time a
burst needs it. A burst with neither keeps the plain graph: no [S, V] pass
is added. The processor parameters of each slot are slot state too
(llama.PROC_SLOT_STATE, synced with the rest), and the penalty bookkeeping
(``proc_state``: output counts and prompt masks, [S, V]) lives on the
device from the first request that uses a processor, advanced in place by
the processor bursts and reset a slot at a time (``proc_reset_slot``,
``proc_count``). The prefill step has the same variants
(``run_step(procs=..., want_logprobs=..., want_top=...)``).

Each graph captured counts in the process's compile telemetry
(runtime/device_observe.py, ``/debug/compiles``) as a compile of JAX's
``runner.decode_state``, with the capture's wall time; prefill is eager and
counts nothing.

Divergences from the JAX runner: no demotion machinery (a capture or
launch that fails raises, and the engine fails its streams).

Everything runs on the engine's single device thread.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dynamo_tpu_torch import config as knobs
from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.quantize import init_quantized_params, quantize_params
from dynamo_tpu_torch.ops import logits_process
from dynamo_tpu_torch.ops.cuda.graphs import CapturedCall
from dynamo_tpu_torch.ops.fused_layer import supports_reason
from dynamo_tpu_torch.ops.sampling import (
    fold_row_keys,
    log_softmax_f32,
    pick_logprobs,
    sample_tokens,
    top_of,
)
from dynamo_tpu_torch.runtime.device_observe import (
    WatchedCapture,
    global_compile_watcher,
    watched_capture,
)

# A decode graph's key: (width bucket, want_logprobs, use_procs), as the
# JAX runner keys its programs (runner.py:1008).
GraphKey = Tuple[int, bool, bool]
# The program a decode graph's capture counts under (compile telemetry):
# the JAX runner's decode program's name.
DECODE_PROGRAM = "runner.decode_state"


class DeviceRunner:
    def __init__(self, args: Any, params: Optional[llama.Params] = None) -> None:
        self.args = args
        self.config = args.config
        self.device = resolve_device(args.device)
        if args.quantization not in (None, "int8"):
            raise ValueError(f"unsupported quantization {args.quantization!r} (int8 only)")
        if args.kv_cache_dtype not in (None, "int8", "auto"):
            raise ValueError(f"unsupported kv_cache_dtype {args.kv_cache_dtype!r} "
                             "(None, 'int8' or 'auto')")
        if args.kv_cache_dtype == "auto":
            args.kv_cache_dtype = self._resolve_auto_kv_dtype(args)
        if params is None:
            params = (
                init_quantized_params(self.config, args.seed, self.device)
                if args.quantization
                else llama.init_params(self.config, args.seed, self.device)
            )
        if args.quantization:  # idempotent for int8 trees
            params = quantize_params(params)
        self.params = params
        self.use_megakernel = self._megakernel_gate()
        self.mk_fused_bursts = 0  # decode bursts run through the fused layer
        self.k_cache, self.v_cache = llama.init_kv_cache(
            self.config, args.num_kv_blocks, args.block_size, self.device,
            kv_dtype=args.kv_cache_dtype,
        )
        # One fixed sampling seed; per-row noise is keyed (seed, sequence
        # salt, token index), never by dispatch order (ops/sampling.py).
        self.seed = args.seed ^ 0x5EED
        # Decode rows whose logits held a NaN/inf (active rows only); the
        # smoke run on the card asserts it stays 0.
        self.nonfinite_rows = 0
        if args.cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs=True needs a CUDA device, got {self.device}; "
                             "pass cuda_graphs=False to run the decode burst eagerly")
        S, K = args.max_num_seqs, args.decode_steps
        dev = self.device
        self.slot_state = {
            name: torch.zeros((S, args.max_blocks_per_seq) if name == "tables" else (S,),
                              dtype=dtype, device=dev)
            for name, dtype in llama.SLOT_STATE.items()
        }
        self.slot_state["temp"].fill_(1.0)
        self.slot_state["topp"].fill_(1.0)
        # the processor parameters, neutral (rep 1, empty bias slots)
        nbias = logits_process.MAX_BIAS_SLOTS
        for name, dtype in llama.PROC_SLOT_STATE.items():
            shape = (S, nbias) if name.startswith("bias") else (S,)
            self.slot_state[name] = torch.zeros(shape, dtype=dtype, device=dev)
        self.slot_state["rep"].fill_(1.0)
        self.slot_state["bias_ids"].fill_(-1)
        # [S, V] penalty bookkeeping, made at the first processor request
        self.proc_state: Optional[logits_process.ProcState] = None
        self._active = np.zeros(S, np.int32)  # host mirror of slot_state["active"]
        self._out_tokens = torch.zeros((S, K), dtype=torch.int64, device=dev)
        self._out_finite = torch.ones(S, dtype=torch.bool, device=dev)
        # logprobs [S, K] and top-N values and ids [S, K, cap], made at the
        # first logprobs burst
        self._out_logprobs: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
        self._free_outputs: Deque[_HostOutputs] = collections.deque()
        # (width bucket, want_logprobs, use_procs) -> its captured burst;
        # one memory pool for all
        self.graphs: Dict[GraphKey, CapturedCall] = {}
        self._graph_pool = None
        self._capture_stream: Optional[torch.cuda.Stream] = None
        self.capture_ms = 0.0
        self.eager_bursts = 0
        # Compile telemetry (runtime/device_observe.py, /debug/compiles):
        # each decode graph captured counts under JAX's program name, one
        # capturing object a burst variant (want_logprobs, use_procs) as JAX
        # has one jit object a variant, each with JAX's signature budget
        # (runner.py:431-441): pow2 table widths give ~log2(cap) + 1 keys a
        # variant; past 2x + 4 the widths stopped bucketing.
        width_buckets = max(int(args.max_blocks_per_seq), 1).bit_length() + 1
        self._decode_sig_budget = 2 * width_buckets + 4
        global_compile_watcher().set_budget(DECODE_PROGRAM, self._decode_sig_budget)
        self._captures: Dict[Tuple[bool, bool], WatchedCapture] = {}
        # Host-to-device traffic of the decode path, as the JAX runner's
        # transfer_log: ("slot_sync" | "table_sync", rows) and ("decode", nb).
        self.transfer_log: Deque[Tuple[str, int]] = collections.deque(maxlen=4096)

    @staticmethod
    def _resolve_auto_kv_dtype(args: Any) -> Optional[str]:
        """``kv_cache_dtype="auto"`` as the JAX runner resolves it
        (runner.py:257-282): int8 when max_model_len reaches
        KV_QUANT_AUTO_CTX, or when the pool holds fewer tokens than
        max_num_seqs full-length sequences; else bf16 (None). The JAX rule
        also asks for the layered cache, which the port's always is."""
        pool_tokens = args.num_kv_blocks * args.block_size
        pressure = pool_tokens < args.max_num_seqs * args.max_model_len
        long_ctx = args.max_model_len >= knobs.KV_QUANT_AUTO_CTX.get()
        return "int8" if long_ctx or pressure else None

    def _megakernel_gate(self) -> bool:
        """The JAX runner's gate (runner.py:284-306): int8 weights, bf16
        layered pools, no LoRA, and an architecture the fused layer takes.
        The mesh condition has no counterpart here, and ``max_num_seqs % 4``
        is dropped: the CUDA kernel takes any batch. ``None`` turns it on
        when eligible and on the card; ``True`` on an ineligible config
        raises instead of running another path."""
        c, want = self.config, self.args.use_megakernel
        if self.args.quantization != "int8":
            reason = "weights not int8-quantized (quantization is not 'int8')"
        elif self.args.kv_cache_dtype:
            reason = "int8 KV pools; the fused layer reads bf16 pools"
        elif c.dtype != torch.bfloat16:
            reason = f"KV pools are {c.dtype}, the fused layer reads bf16 pools"
        else:
            reason = supports_reason(c, lora=False, quantized_weights=True)
        if want is None:
            return reason is None and self.device.type == "cuda"
        if want and reason is not None:
            raise ValueError(f"use_megakernel=True, but the fused layer cannot serve {c.name}: {reason}")
        return bool(want)

    def _dev(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, dtype)

    @torch.inference_mode()
    def run_step(
        self, tokens, start_pos, chunk_lens, block_tables, temp, topk, topp, salts,
        *, first_chunk: bool = False, procs: Optional[Dict[str, np.ndarray]] = None,
        want_logprobs: bool = False, want_top: bool = False,
    ) -> "StepResult":
        """One prefill chunk round over [B, C] rows + the sample of each
        row's next token, keyed at index start + len. With ``procs``
        (PROC_SLOT_STATE rows plus ``pmask`` [B, V], each row's tokens so
        far) the repetition penalty over those tokens and the bias apply
        first, and min_p in the sample (JAX runner.py:650-698); then the
        chosen tokens' logprobs (``want_logprobs``) and the top
        ``top_logprobs_cap`` (``want_top``) from the processed logits.
        Returns the [B] ids and those, as numpy."""
        d = self._dev
        start = d(start_pos, torch.int32)
        lens = d(chunk_lens, torch.int32)
        logits, self.k_cache, self.v_cache = llama.forward_paged(
            self.params, self.config, d(tokens, torch.int64), start, lens,
            d(block_tables, torch.int32), self.k_cache, self.v_cache,
            first_chunk=first_chunk,
        )
        keys = fold_row_keys(self.seed, d(salts, torch.int64), start + lens)
        min_p = None
        if procs is not None:
            params = logits_process.ProcParams(
                rep=d(procs["rep"], torch.float32), pres=d(procs["pres"], torch.float32),
                freq=d(procs["freq"], torch.float32),
                bias_ids=d(procs["bias_ids"], torch.int64),
                bias_vals=d(procs["bias_vals"], torch.float32))
            logits = logits_process.apply_prompt_only(logits, d(procs["pmask"], torch.bool),
                                                      params)
            min_p = d(procs["minp"], torch.float32)
        toks = sample_tokens(
            logits, d(temp, torch.float32), d(topk, torch.int32), d(topp, torch.float32),
            min_p, row_keys=keys,
        )
        logp = top = None
        if want_logprobs or want_top:
            logp_all = log_softmax_f32(logits)
            logp = pick_logprobs(logp_all, toks).cpu().numpy()
            if want_top:
                top = [t.cpu().numpy() for t in top_of(logp_all, self.args.top_logprobs_cap)]
        return StepResult(toks.cpu().numpy(), logp, *(top or (None, None)))

    # -- logits-processor device state (runner.py:818-845) ---------------

    def ensure_proc_state(self) -> logits_process.ProcState:
        if self.proc_state is None:
            self.proc_state = logits_process.init_state(
                self.args.max_num_seqs, self.config.vocab_size, self.device)
        return self.proc_state

    @torch.inference_mode()
    def proc_reset_slot(self, slot: int, prompt_ids, generated) -> None:
        """(Re)set one slot's penalty bookkeeping: its prompt's mask and the
        counts of the tokens it generated so far."""
        logits_process.reset_slot(self.ensure_proc_state(), slot, prompt_ids, generated)

    @torch.inference_mode()
    def proc_count(self, slot: int, token: int) -> None:
        """Count one generated token of a slot (the prefill's)."""
        logits_process.count_token(self.ensure_proc_state(), slot, int(token))

    # -- decode: device-resident slot state (runner.py:931-1130) -----------

    def _to_state(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """A host array on the way into the slot state: on the card from
        pinned memory by a non-blocking copy, so a sync queues behind the
        bursts in flight instead of waiting for them (the caching host
        allocator keeps the pinned block until the copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @torch.inference_mode()
    def sync_slots(self, slots: List[int], rows: Dict[str, np.ndarray]) -> None:
        """Write the scheduler's dirty slot rows into the device state:
        ``rows[name][i]`` lands at ``slot_state[name][slots[i]]``, for every
        field of SLOT_STATE but the tables, and for the PROC_SLOT_STATE
        fields when given. The only host-to-device path for slot state
        after start."""
        if not slots:
            return
        fields = set(llama.SLOT_STATE) - {"tables"}
        if set(rows) not in (fields, fields | set(llama.PROC_SLOT_STATE)):
            raise ValueError(f"slot sync rows {sorted(rows)} != state fields {sorted(fields)} "
                             f"(with or without {sorted(llama.PROC_SLOT_STATE)})")
        dtypes = {**llama.SLOT_STATE, **llama.PROC_SLOT_STATE}
        idx = self._to_state(np.asarray(slots, np.int64), torch.int64)
        for name in sorted(rows):
            self.slot_state[name].index_copy_(0, idx, self._to_state(rows[name], dtypes[name]))
        self._active[np.asarray(slots)] = np.asarray(rows["active"], np.int32)
        self.transfer_log.append(("slot_sync", len(slots)))

    @torch.inference_mode()
    def sync_tables(self, slots: List[int], rows: np.ndarray) -> None:
        """Write dirty block-table rows (the full table width) into the
        device state; called only when a slot's table changed."""
        if not slots:
            return
        idx = self._to_state(np.asarray(slots, np.int64), torch.int64)
        self.slot_state["tables"].index_copy_(0, idx, self._to_state(rows, torch.int32))
        self.transfer_log.append(("table_sync", len(slots)))

    def _logprob_buffers(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self._out_logprobs is None:
            S, K, N = self.args.max_num_seqs, self.args.decode_steps, self.args.top_logprobs_cap
            dev = self.device
            self._out_logprobs = (torch.zeros((S, K), dtype=torch.float32, device=dev),
                                  torch.zeros((S, K, N), dtype=torch.float32, device=dev),
                                  torch.zeros((S, K, N), dtype=torch.int64, device=dev))
        return self._out_logprobs

    def _burst(self, key: GraphKey) -> None:
        nb, want_logprobs, use_procs = key
        llama.decode_burst(
            self.params, self.config, self.slot_state, self.k_cache, self.v_cache, self.seed,
            self._out_tokens, self._out_finite, num_steps=self.args.decode_steps, width=nb,
            use_megakernel=self.use_megakernel,
            proc_state=self.ensure_proc_state() if use_procs else None,
            logprob_outputs=self._logprob_buffers() if want_logprobs else None,
        )

    def _replay_or_capture(self, key: GraphKey) -> None:
        """The burst of ``key`` (width bucket, want_logprobs, use_procs) by
        its graph; at the key's first use it runs eagerly on the capture
        stream (this burst's real run, and the warm-up) and is captured
        right after."""
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            return
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._burst(key)
        self.eager_bursts += 1
        t0 = time.monotonic()
        self.graphs[key] = CapturedCall(lambda: self._burst(key), pool=self._graph_pool,
                                        stream=stream)
        seconds = time.monotonic() - t0
        self.capture_ms += 1e3 * seconds
        self._capture_watch(key).captured(key, seconds)
        torch.cuda.current_stream(self.device).wait_stream(stream)

    def _capture_watch(self, key: GraphKey) -> WatchedCapture:
        """The capturing object of ``key``'s burst variant (compile
        telemetry), made at the variant's first capture."""
        variant = key[1:]
        watch = self._captures.get(variant)
        if watch is None:
            watch = self._captures[variant] = watched_capture(
                DECODE_PROGRAM, budget=self._decode_sig_budget)
        return watch

    @torch.inference_mode()
    def decode_dispatch(self, nb: int, want_logprobs: bool = False,
                        use_procs: bool = False) -> "_DecodeHandles":
        """Enqueue one burst of ``decode_steps`` over the slot state at
        table width ``nb`` and return without waiting: by graph replay when
        ``args.cuda_graphs``, else eagerly. ``use_procs`` applies the slots'
        processors and min_p (and counts the tokens); ``want_logprobs``
        adds the chosen tokens' logprobs and the top ``top_logprobs_cap``.
        Its outputs start their copies to a pinned buffer set, and an event
        marks the burst's end. Pair with ``decode_read``."""
        nb = int(nb)
        if not 1 <= nb <= self.args.max_blocks_per_seq:
            raise ValueError(f"table width {nb} outside 1..{self.args.max_blocks_per_seq}")
        key = (nb, bool(want_logprobs), bool(use_procs))
        if self.args.cuda_graphs:
            self._replay_or_capture(key)
        else:
            self._burst(key)
            self.eager_bursts += 1
        self.mk_fused_bursts += int(self.use_megakernel)
        self.transfer_log.append(("decode", nb))
        host = self._free_outputs.popleft() if self._free_outputs else _HostOutputs.make(
            self._out_tokens, self._out_finite)
        host.tokens.copy_(self._out_tokens, non_blocking=True)
        host.finite.copy_(self._out_finite, non_blocking=True)
        if want_logprobs:
            bufs = self._logprob_buffers()
            for dst, src in zip(host.logprob_buffers(bufs), bufs):
                dst.copy_(src, non_blocking=True)
        if host.event is not None:
            host.event.record()
        return _DecodeHandles(host=host, active=self._active.copy(),
                              want_logprobs=bool(want_logprobs))

    def decode_read(self, handles: "_DecodeHandles") -> "DecodeResult":
        """Wait for a dispatched burst and return its [S, K] tokens, [S]
        finite flags and (with want_logprobs, else None) [S, K] logprobs
        and [S, K, cap] top values and ids, as numpy (rows not active
        repeat their input token); counts the active rows whose logits were
        not finite."""
        host = handles.host
        if host.event is not None:
            host.event.synchronize()
        toks, finite = host.tokens.numpy().copy(), host.finite.numpy().copy()
        logprobs = (None, None, None)
        if handles.want_logprobs:
            logprobs = tuple(t.numpy().copy() for t in host.logprobs)
        self._free_outputs.append(host)
        self.nonfinite_rows += int(np.count_nonzero(~finite & (handles.active > 0)))
        return DecodeResult(toks, finite, *logprobs)

    def sync_all(self, tokens, start_pos, active, block_tables, temp, topk, topp, salts,
                 procs: Optional[Dict[str, np.ndarray]] = None) -> int:
        """Write every slot's row of the decode state from host arrays
        (tables zero-padded to the full width; with ``procs``, the
        PROC_SLOT_STATE rows too); returns the tables' width."""
        S, P = self.args.max_num_seqs, self.args.max_blocks_per_seq
        tables = np.asarray(block_tables, np.int32)
        if len(tokens) != S or tables.shape[0] != S or tables.shape[1] > P:
            raise ValueError(f"the decode state holds {S} slots of {P} pages, got "
                             f"{len(tokens)} tokens and tables {tables.shape}")
        self.sync_slots(list(range(S)), {
            "tokens": np.asarray(tokens), "pos": np.asarray(start_pos),
            "active": np.asarray(active), "temp": np.asarray(temp), "topk": np.asarray(topk),
            "topp": np.asarray(topp), "salts": np.asarray(salts), **(procs or {}),
        })
        full = np.zeros((S, P), np.int32)
        full[:, : tables.shape[1]] = tables
        self.sync_tables(list(range(S)), full)
        return tables.shape[1]

    def run_decode(
        self, tokens, start_pos, active, block_tables, temp, topk, topp, salts,
    ) -> np.ndarray:
        """Synchronous form (tools, tests, chip_smoke.py's profile bursts):
        ``sync_all``, one burst at the tables' width, read back. Returns
        [S, K] sampled ids."""
        nb = self.sync_all(tokens, start_pos, active, block_tables, temp, topk, topp, salts)
        return self.decode_read(self.decode_dispatch(nb)).tokens


class StepResult(NamedTuple):
    """A prefill step's outputs as numpy: [B] ids, and (else None) [B]
    logprobs and [B, cap] top values and ids."""

    tokens: np.ndarray
    logprobs: Optional[np.ndarray] = None
    top_vals: Optional[np.ndarray] = None
    top_ids: Optional[np.ndarray] = None


class DecodeResult(NamedTuple):
    """A decode burst's outputs as numpy: [S, K] ids, [S] finite flags,
    and (with want_logprobs, else None) [S, K] logprobs and [S, K, cap] top
    values and ids."""

    tokens: np.ndarray
    finite: np.ndarray
    logprobs: Optional[np.ndarray] = None
    top_vals: Optional[np.ndarray] = None
    top_ids: Optional[np.ndarray] = None


@dataclass
class _HostOutputs:
    """Host buffers of one burst's outputs (pinned on the card) and the
    event recorded after their copies."""

    tokens: torch.Tensor
    finite: torch.Tensor
    event: Optional[torch.cuda.Event]
    logprobs: Optional[Tuple[torch.Tensor, ...]] = None  # made at the first logprobs burst

    @staticmethod
    def _like(t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.device.type == "cuda")

    @classmethod
    def make(cls, tokens: torch.Tensor, finite: torch.Tensor) -> "_HostOutputs":
        return cls(tokens=cls._like(tokens), finite=cls._like(finite),
                   event=torch.cuda.Event() if tokens.device.type == "cuda" else None)

    def logprob_buffers(self, like: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
        if self.logprobs is None:
            self.logprobs = tuple(self._like(t) for t in like)
        return self.logprobs


@dataclass
class _DecodeHandles:
    """One dispatched burst (runner.py:77-87): its output buffers and the
    slots that were active when it was enqueued."""

    host: _HostOutputs
    active: np.ndarray
    want_logprobs: bool = False
