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

Speculative verify (runner.py:785-815, 1189-1218): ``run_spec`` runs one
[S, C] forward with every position's logits and the rejection-sampling
verify (ops/sampling.spec_verify_sample) over static input buffers written
from the host before each call. On the card each (width bucket, C) is one
CUDA graph (``spec_graphs``, keyed apart from the decode graphs), in the
decode graphs' pool and on their capture stream, and each capture counts
as a compile of JAX's ``runner.spec_verify`` under the decode programs'
budget. Its noise is keyed by token index, never by a dispatch counter.

KV block movement (runner.py:90-186, 1232-1359), for disaggregation: the
gather of committed blocks out of the pools and the scatter of blocks into
them, over bf16 and int8 pools alike, in the wire's layout (disagg/wire.py:
[n, L, BS, KH, D], scales [n, L, KH, BS]). Int8 pools ship their codes and
scales as they are; a dense payload into an int8 pool is requantized on the
device (ops/kv_quant.quantize_kv_chunk), an int8 payload into a dense pool
dequantized there (``dequantize_pages``). Readback is two-phase, as JAX's:
``gather_blocks*_dispatch`` queues the gather and a non-blocking copy into
pinned host memory on the engine's device thread and returns at once, and
``gather_blocks*_readback`` waits for the copy's event on a transfer
thread, so decode bursts keep flowing while a transfer drains. These are
plain torch ops (indexed copies; JAX's are XLA, not Pallas), and on the CPU
the same functions run.

Multi-LoRA (runner.py:226-233, 568-645): adapters stay on the host as
float32 tensors (lora/loader.py); only their stack lives on the card
(``lora``: target -> layer-major (A [L, N+1, d_in, r_max], B [L, N+1,
r_max, d_out]) in the model dtype), slot 0 the zero "no adapter" one, and
``lora_index`` maps a name to its stable slot. ``install_adapter`` takes the
first free slot (else a new one), ``remove_adapter`` leaves a zero
placeholder at rank 1 in its slot, so ids that rows hold stay valid. The
prefill, every decode burst and the verify read the stack and each row's
id (``slot_state["adapter_ids"]``, the verify's static ``adapter_ids``). A
captured graph holds the stack's addresses, so a restack that keeps the
stack's shape (slots, r_max, targets) copies into the same tensors on the
engine's stream, behind the bursts in flight, and every graph stays valid;
one that changes it waits for the stream, drops every decode and verify
graph and allocates anew. Graph keys carry the stack's shape (``lora_key``;
none without a stack, so an engine without adapters keeps its keys and
launches nothing extra), and each recapture counts as a new signature of
its program under JAX's budget, which allows for restacks.

Divergences from the JAX runner: no demotion machinery (a capture or
launch that fails raises, and the engine fails its streams); a scatter
writes into the pools in place (``index_copy_``) where JAX rebinds the
caches to a donated result, because the captured decode graphs hold the
pools' addresses and a cache write needs each pool's sink block
(ops/attention.sink_pool_tensor).

Everything runs on the engine's single device thread.
"""

from __future__ import annotations

import collections
import logging
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
from dynamo_tpu_torch.ops.kv_quant import dequantize_pages, is_quantized_pool, quantize_kv_chunk
from dynamo_tpu_torch.ops.sampling import (
    fold_row_keys,
    log_softmax_f32,
    pick_logprobs,
    sample_tokens,
    spec_verify_sample,
    top_of,
)
from dynamo_tpu_torch.runtime.device_observe import (
    WatchedCapture,
    global_compile_watcher,
    watched_capture,
)

logger = logging.getLogger(__name__)

# A decode graph's key: (width bucket, want_logprobs, use_procs), as the
# JAX runner keys its programs (runner.py:1008), followed by the LoRA
# stack's shape when a stack is loaded (DeviceRunner.lora_key).
GraphKey = Tuple[Any, ...]
# A verify graph's key: ("spec", width bucket, rows a sequence), and the
# stack's shape likewise. Its own first field keeps it apart from every
# GraphKey; verify graphs live in their own dictionary besides.
SpecKey = Tuple[Any, ...]
# The programs a graph's capture counts under (compile telemetry): the JAX
# runner's decode and speculative-verify programs' names.
DECODE_PROGRAM = "runner.decode_state"
SPEC_PROGRAM = "runner.spec_verify"


# The dense wire dtype of an int8 pool's dense export (v1 importers; JAX's
# KV_QUANT_WIRE_DTYPE). Dense pools ship their storage dtype.
KV_QUANT_WIRE_DTYPE = torch.bfloat16


def _gather_blocks(cache: List[Any], idx: torch.Tensor) -> torch.Tensor:
    """[n, L, BS, KH, D] of blocks ``idx`` of per-layer pools; int8 pools
    dequantized to KV_QUANT_WIRE_DTYPE (JAX's ``_gather_blocks``, which
    returns [L, n, ...])."""
    def one(c):
        if is_quantized_pool(c):
            return dequantize_pages(c["q8"].index_select(0, idx), c["s"].index_select(0, idx),
                                    KV_QUANT_WIRE_DTYPE)
        return c.index_select(0, idx)

    return torch.stack([one(c) for c in cache], dim=1)


def _gather_blocks_q8(cache: List[Any], idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pool-native gather of int8 pools: (codes [n, L, BS, KH, D] int8,
    scales [n, L, KH, BS] float32) of blocks ``idx``, not dequantized."""
    return (torch.stack([c["q8"].index_select(0, idx) for c in cache], dim=1),
            torch.stack([c["s"].index_select(0, idx) for c in cache], dim=1))


def _scatter_blocks(cache: List[Any], idx: torch.Tensor, blocks: torch.Tensor) -> None:
    """Pools <- dense ``blocks`` [n, L, BS, KH, D] at ``idx``, in place: a
    dense pool takes them in its dtype, an int8 pool their codes and
    scales (ops/kv_quant.quantize_kv_chunk), so bf16 and int8 engines
    interoperate."""
    for layer, c in enumerate(cache):
        blk = blocks[:, layer]
        if is_quantized_pool(c):
            q8, s = quantize_kv_chunk(blk)  # [n, BS, KH, D], [n, BS, KH]
            c["q8"].index_copy_(0, idx, q8)
            c["s"].index_copy_(0, idx, s.transpose(1, 2))
        else:
            c.index_copy_(0, idx, blk.to(c.dtype))


def _scatter_blocks_q8(cache: List[Any], idx: torch.Tensor, q8: torch.Tensor,
                       s: torch.Tensor) -> None:
    """Pools <- int8 wire blocks (codes [n, L, BS, KH, D], scales
    [n, L, KH, BS]) at ``idx``, in place: an int8 pool takes them verbatim
    (an int8 -> int8 transfer is bit-exact), a dense pool dequantizes them."""
    for layer, c in enumerate(cache):
        if is_quantized_pool(c):
            c["q8"].index_copy_(0, idx, q8[:, layer])
            c["s"].index_copy_(0, idx, s[:, layer])
        else:
            c.index_copy_(0, idx, dequantize_pages(q8[:, layer], s[:, layer], c.dtype))


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
        # Multi-LoRA: the stack on the card, name -> slot index (index 0 is
        # the zero "no adapter" slot), and the host adapters by slot - 1
        # (None: a freed slot).
        self.lora: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
        self.lora_index: Dict[str, int] = {}
        self._adapter_list: List[Optional[Any]] = []
        self.use_megakernel = self._megakernel_gate(lora=bool(args.lora_dir))
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
        # Speculative verify (run_spec): one graph a (width bucket, rows a
        # sequence), in the decode graphs' pool and on their capture
        # stream, reading static input buffers written before each replay;
        # captures count under JAX's verify program with its budget.
        self.spec_graphs: Dict[SpecKey, CapturedCall] = {}
        self._spec_io: Dict[int, Dict[str, torch.Tensor]] = {}  # rows a sequence -> buffers
        self._spec_capture: Optional[WatchedCapture] = None
        self.spec_eager = 0  # verifies run eagerly (captures' first runs included)
        if getattr(args, "spec_mode", None):
            global_compile_watcher().set_budget(SPEC_PROGRAM, self._decode_sig_budget)
        # Host-to-device traffic of the decode path, as the JAX runner's
        # transfer_log: ("slot_sync" | "table_sync", rows) and ("decode", nb).
        self.transfer_log: Deque[Tuple[str, int]] = collections.deque(maxlen=4096)
        # restacks that kept the stack's shape (in place) and that changed it
        self.lora_restacks = {"in_place": 0, "reshaped": 0}
        if args.lora_dir:
            self._load_loras(args.lora_dir)

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

    def _megakernel_gate(self, lora: bool) -> bool:
        """The JAX runner's gate (runner.py:284-306): int8 weights, bf16
        layered pools, no LoRA stack (``lora``: a ``lora_dir`` at start, an
        adapter's first load later), and an architecture the fused layer
        takes. The mesh condition has no counterpart here, and
        ``max_num_seqs % 4`` is dropped: the CUDA kernel takes any batch.
        ``None`` turns it on when eligible and on the card; ``True`` on an
        ineligible config raises instead of running another path (under
        ``lora_dir`` JAX warns and runs XLA)."""
        c, want = self.config, self.args.use_megakernel
        if self.args.quantization != "int8":
            reason = "weights not int8-quantized (quantization is not 'int8')"
        elif self.args.kv_cache_dtype:
            reason = "int8 KV pools; the fused layer reads bf16 pools"
        elif c.dtype != torch.bfloat16:
            reason = f"KV pools are {c.dtype}, the fused layer reads bf16 pools"
        else:
            reason = supports_reason(c, lora=lora, quantized_weights=True)
        if want is None:
            return reason is None and self.device.type == "cuda"
        if want and reason is not None:
            raise ValueError(f"use_megakernel=True, but the fused layer cannot serve {c.name}: {reason}")
        return bool(want)

    def _dev(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, dtype)

    # -- LoRA (runner.py:226-233, 568-645) ---------------------------------

    def lora_key(self) -> Tuple[Any, ...]:
        """The stack's shape as a graph key's tail: (slots, r_max, targets),
        or nothing without a stack."""
        if self.lora is None:
            return ()
        A = next(iter(self.lora.values()))[0]  # [L, N+1, d_in, r_max]
        return ((A.shape[1], A.shape[3], tuple(sorted(self.lora))),)

    def _load_loras(self, lora_dir: str) -> None:
        """Load every adapter under ``lora_dir`` and stack them layer-major
        for the layer loop (lora/loader.py)."""
        from dynamo_tpu_torch.lora import LocalLoRASource, load_lora_adapter

        source = LocalLoRASource(lora_dir)
        names = source.list_adapters()
        if not names:
            logger.warning("lora_dir %s contains no adapters", lora_dir)
            return
        self._adapter_list = [
            _adapter_to_host(load_lora_adapter(source.fetch(n, lora_dir), self.config, name=n))
            for n in names
        ]
        self._restack_loras()

    @torch.inference_mode()
    def _restack_loras(self) -> None:
        """Rebuild the stack from ``_adapter_list`` (None entries are freed
        slots that keep later indices stable: rows hold adapter ids by
        position). The same shape: copied into the stack in place, on the
        current stream after the bursts in flight. Another shape: the
        stream is waited for, every decode and verify graph dropped, and
        the stack made anew."""
        from dynamo_tpu_torch.lora.loader import LoRAAdapter, stack_adapters

        real = [a for a in self._adapter_list if a is not None]
        if not real:
            if self.lora is not None:
                self._drop_graphs()  # the graphs' keys end with the stack's shape
            self.lora = None
            self.lora_index = {}
            return
        padded = [
            a if a is not None else LoRAAdapter(name=f"__free_{i}", rank=1, scaling=0.0)
            for i, a in enumerate(self._adapter_list)
        ]
        targets = sorted({t for a in real for t in a.targets})
        # [N+1, L, ...] -> layer-major [L, N+1, ...] for the layer loop
        stacked = {t: (A.transpose(0, 1).contiguous(), B.transpose(0, 1).contiguous())
                   for t, (A, B) in stack_adapters(padded, self.config, targets).items()}
        shape = lambda st: {t: (A.shape, B.shape) for t, (A, B) in st.items()}  # noqa: E731
        if self.lora is not None and shape(self.lora) == shape(stacked):
            cuda = self.device.type == "cuda"
            for t, pair in stacked.items():
                for dst, src in zip(self.lora[t], pair):
                    dst.copy_(src.pin_memory() if cuda else src, non_blocking=cuda)
            self.lora_restacks["in_place"] += 1
        else:
            self._drop_graphs()
            self.lora = {t: (A.to(self.device), B.to(self.device)) for t, (A, B) in stacked.items()}
            self.lora_restacks["reshaped"] += 1
        self.lora_index = {
            a.name: i for i, a in enumerate(self._adapter_list, start=1) if a is not None
        }
        logger.info("LoRA stack: %d slot(s), adapters %s (targets: %s)",
                    len(self._adapter_list), sorted(self.lora_index), targets)

    def _drop_graphs(self) -> None:
        """Every captured decode and verify graph, dropped once the bursts
        in flight that replay them have run (the stack's shape changes, the
        first stack's included: no key replays them after it)."""
        if not (self.graphs or self.spec_graphs):
            return
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.graphs.clear()
        self.spec_graphs.clear()

    def install_adapter(self, adapter: Any) -> None:
        """Add one host adapter into the first free slot and restack. The
        first stack on a runner whose fused layer is on asks its gate again,
        as ``lora_dir`` would have at start: ``use_megakernel=True`` raises
        (the route answers 409) and ``None`` turns the fused layer off."""
        if self.use_megakernel and self.lora is None:
            self.use_megakernel = self._megakernel_gate(lora=True)
            logger.warning("the fused decoder layer is off from here on: it takes no LoRA stack")
        for i, slot in enumerate(self._adapter_list):
            if slot is None:
                self._adapter_list[i] = adapter
                break
        else:
            self._adapter_list.append(adapter)
        self._restack_loras()

    def remove_adapter(self, name: str) -> int:
        """Free an adapter slot by name; returns its (stable) index."""
        idx = self.lora_index[name]
        self._adapter_list[idx - 1] = None
        self._restack_loras()
        return idx

    def _row_ids(self, adapter_ids) -> Optional[torch.Tensor]:
        """A prefill's rows' adapter ids on the device, or None without a
        stack (nothing extra is launched)."""
        if self.lora is None or adapter_ids is None:
            return None
        return self._dev(adapter_ids, torch.int32)

    @torch.inference_mode()
    def run_step(
        self, tokens, start_pos, chunk_lens, block_tables, temp, topk, topp, salts,
        *, first_chunk: bool = False, procs: Optional[Dict[str, np.ndarray]] = None,
        want_logprobs: bool = False, want_top: bool = False, adapter_ids=None,
    ) -> "StepResult":
        """One prefill chunk round over [B, C] rows + the sample of each
        row's next token, keyed at index start + len. With ``procs``
        (PROC_SLOT_STATE rows plus ``pmask`` [B, V], each row's tokens so
        far) the repetition penalty over those tokens and the bias apply
        first, and min_p in the sample (JAX runner.py:650-698); then the
        chosen tokens' logprobs (``want_logprobs``) and the top
        ``top_logprobs_cap`` (``want_top``) from the processed logits.
        ``adapter_ids`` [B] select each row's adapter of the stack.
        Returns the [B] ids and those, as numpy."""
        d = self._dev
        start = d(start_pos, torch.int32)
        lens = d(chunk_lens, torch.int32)
        logits, self.k_cache, self.v_cache = llama.forward_paged(
            self.params, self.config, d(tokens, torch.int64), start, lens,
            d(block_tables, torch.int32), self.k_cache, self.v_cache,
            first_chunk=first_chunk, lora=self.lora, adapter_ids=self._row_ids(adapter_ids),
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
    def zero_adapter_ids(self, slots: List[int]) -> None:
        """Stack index 0 in the device rows of ``slots``, whose adapter was
        unloaded while they run; the rest of each row, its carry among it,
        stays."""
        idx = self._to_state(np.asarray(slots, np.int64), torch.int64)
        self.slot_state["adapter_ids"].index_fill_(0, idx, 0)

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
        nb, want_logprobs, use_procs = key[:3]
        llama.decode_burst(
            self.params, self.config, self.slot_state, self.k_cache, self.v_cache, self.seed,
            self._out_tokens, self._out_finite, num_steps=self.args.decode_steps, width=nb,
            use_megakernel=self.use_megakernel,
            proc_state=self.ensure_proc_state() if use_procs else None,
            logprob_outputs=self._logprob_buffers() if want_logprobs else None,
            lora=self.lora,
        )

    def _replay_or_capture(self, key: GraphKey) -> None:
        """The burst of ``key`` (width bucket, want_logprobs, use_procs[,
        the stack's shape]) by its graph; at the key's first use it runs
        eagerly on the capture stream (this burst's real run, and the
        warm-up) and is captured right after."""
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            return
        self.graphs[key] = self._run_and_capture(lambda: self._burst(key),
                                                 self._capture_watch(key), key)
        self.eager_bursts += 1

    def _run_and_capture(self, fn, watch: WatchedCapture, key: Any) -> CapturedCall:
        """Run ``fn`` eagerly on the capture stream (the call's real run, and
        the warm-up), then capture it into the graphs' shared pool; the
        capture counts under ``watch`` with its wall time."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            fn()
        t0 = time.monotonic()
        graph = CapturedCall(fn, pool=self._graph_pool, stream=stream)
        seconds = time.monotonic() - t0
        self.capture_ms += 1e3 * seconds
        watch.captured(key, seconds)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        return graph

    def _capture_watch(self, key: GraphKey) -> WatchedCapture:
        """The capturing object of ``key``'s burst variant (compile
        telemetry), made at the variant's first capture; a key with another
        stack shape is another signature of the same variant."""
        variant = key[1:3]
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
        key = (nb, bool(want_logprobs), bool(use_procs)) + self.lora_key()
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

    # -- speculative verify (runner.py:785-815, 1189-1218) -----------------

    def _spec_buffers(self, C: int) -> Dict[str, torch.Tensor]:
        """The verify's static inputs and outputs at C rows a sequence,
        made at its first use; a replay reads and writes these."""
        io = self._spec_io.get(C)
        if io is None:
            S, P, dev = self.args.max_num_seqs, self.args.max_blocks_per_seq, self.device
            shapes = {"tokens": ((S, C), torch.int64), "start": ((S,), torch.int32),
                      "lens": ((S,), torch.int32), "tables": ((S, P), torch.int32),
                      "temp": ((S,), torch.float32), "topk": ((S,), torch.int32),
                      "topp": ((S,), torch.float32), "salts": ((S,), torch.int64),
                      "adapter_ids": ((S,), torch.int32),
                      "emitted": ((S, C), torch.int64), "counts": ((S,), torch.int64)}
            io = self._spec_io[C] = {name: torch.zeros(shape, dtype=dtype, device=dev)
                                     for name, (shape, dtype) in shapes.items()}
        return io

    def _verify(self, io: Dict[str, torch.Tensor], nb: int) -> None:
        """The verify body (JAX's ``_build_spec_fn`` step): one forward over
        the [S, C] tokens at the first ``nb`` table pages with every
        position's logits (the fused layer's gate is C = 1, so the layers
        run unfused), its K/V written into the pools, then
        spec_verify_sample with position i's noise keyed (seed, salt, start
        + i + 1), the index of the token it decides. Reads and writes only
        the buffers of ``io`` and the pools, so it runs eagerly and under
        capture alike."""
        tokens, start = io["tokens"], io["start"]
        C = tokens.shape[1]
        logits, _, _ = llama.forward_paged(
            self.params, self.config, tokens, start, io["lens"],
            io["tables"][:, :nb].contiguous(), self.k_cache, self.v_cache, all_logits=True,
            lora=self.lora, adapter_ids=io["adapter_ids"] if self.lora else None,
        )
        index = start.to(torch.int64)[:, None] + 1 + torch.arange(C, device=tokens.device)[None, :]
        keys = fold_row_keys(self.seed, io["salts"][:, None], index)
        emitted, counts = spec_verify_sample(
            logits, tokens[:, 1:], torch.clamp(io["lens"] - 1, min=0), io["temp"], io["topk"],
            io["topp"], row_keys=keys,
        )
        io["emitted"].copy_(emitted)
        io["counts"].copy_(counts)

    def _spec_watch(self) -> WatchedCapture:
        if self._spec_capture is None:
            self._spec_capture = watched_capture(SPEC_PROGRAM, budget=self._decode_sig_budget)
        return self._spec_capture

    @torch.inference_mode()
    def run_spec(self, tokens, start_pos, chunk_lens, block_tables, temp=None, topk=None,
                 topp=None, salts=None, adapter_ids=None) -> Tuple[np.ndarray, np.ndarray]:
        """Speculative verify with rejection sampling over every slot: tokens
        [S, C] (each row's next token, then its proposals), start [S], lens
        [S] (1 + the row's proposals; 0 for a row that verifies nothing),
        the tables' first ``nb`` pages [S, nb], and each row's sampling
        parameters, salt and adapter id (greedy, base). On the card with
        ``cuda_graphs`` each (nb, C) is one captured graph, run eagerly at
        its first use; else eagerly. Returns (emitted [S, C], counts [S])
        as numpy: row i's first counts[i] entries are its accepted
        proposals and the corrected or bonus token."""
        S, C = tokens.shape
        nb = int(block_tables.shape[1])
        if S != self.args.max_num_seqs or C < 1:
            raise ValueError(f"verify tokens {tuple(tokens.shape)}: want [{self.args.max_num_seqs}, C]")
        if not 1 <= nb <= self.args.max_blocks_per_seq:
            raise ValueError(f"table width {nb} outside 1..{self.args.max_blocks_per_seq}")
        io = self._spec_buffers(C)
        rows = {"tokens": tokens, "start": start_pos, "lens": chunk_lens,
                "temp": np.zeros(S, np.float32) if temp is None else temp,
                "topk": np.zeros(S, np.int32) if topk is None else topk,
                "topp": np.ones(S, np.float32) if topp is None else topp,
                "salts": np.zeros(S, np.int64) if salts is None else salts,
                "adapter_ids": np.zeros(S, np.int32) if adapter_ids is None else adapter_ids}
        for name, a in rows.items():
            io[name].copy_(self._to_state(a, io[name].dtype))
        io["tables"][:, :nb].copy_(self._to_state(block_tables, torch.int32))
        if self.args.cuda_graphs:
            self._replay_or_capture_spec(("spec", nb, C) + self.lora_key(), io)
        else:
            self._verify(io, nb)
            self.spec_eager += 1
        self.transfer_log.append(("spec", nb))
        return io["emitted"].cpu().numpy(), io["counts"].cpu().numpy()

    def _replay_or_capture_spec(self, key: SpecKey, io: Dict[str, torch.Tensor]) -> None:
        """The verify of ``key`` by its graph; at the key's first use it runs
        eagerly on the capture stream and is captured right after."""
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
        graph = self.spec_graphs.get(key)
        if graph is not None:
            graph.replay()
            return
        nb = key[1]
        self.spec_graphs[key] = self._run_and_capture(lambda: self._verify(io, nb),
                                                      self._spec_watch(), key)
        self.spec_eager += 1

    # -- KV block movement (runner.py:1223-1359) ---------------------------

    def pool_quantized(self) -> bool:
        return is_quantized_pool(self.k_cache[0])

    def kv_wire_dtype(self) -> str:
        """Pool-native wire dtype tag (disagg/wire.py): "int8" for int8
        pools, the storage dtype's name otherwise."""
        from dynamo_tpu_torch.disagg.wire import dtype_tag

        return "int8" if self.pool_quantized() else dtype_tag(self.config.dtype)

    def _ids(self, ids: List[int]) -> torch.Tensor:
        return self._to_state(np.asarray(ids, np.int64), torch.int64)

    def _to_host(self, *tensors: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], Any]:
        """Start non-blocking copies of device tensors into pinned host
        buffers; (the buffers, an event recorded after the copies). On the
        CPU the tensors themselves and no event."""
        if self.device.type != "cuda":
            return tensors, None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors)
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _from_host(self, t: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A host tensor on the way into the pools: on the card through a
        pinned copy and a non-blocking transfer, so the scatter queues
        behind the bursts in flight instead of waiting for them."""
        t = t.to(dtype) if dtype is not None else t
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @torch.inference_mode()
    def gather_blocks_dispatch(self, ids: List[int]):
        """Queue the dense gather of blocks ``ids`` and the copy of the
        result to the host, and return the handles without waiting. Runs on
        the engine's device thread but pays only the launches; the wait is
        ``gather_blocks_readback``'s, on a transfer thread. Stream order
        keeps the gather ahead of any later burst's cache writes."""
        idx = self._ids(ids)
        return self._to_host(_gather_blocks(self.k_cache, idx), _gather_blocks(self.v_cache, idx))

    @staticmethod
    def gather_blocks_readback(handles) -> Tuple[torch.Tensor, torch.Tensor]:
        """The waiting half of gather_blocks_dispatch: ([n, L, BS, KH, D]
        k, v) host tensors. Call from a transfer thread, never the device
        thread."""
        (k, v), event = handles
        if event is not None:
            event.synchronize()
        return k, v

    def gather_blocks(self, ids: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Synchronous form (tests)."""
        return self.gather_blocks_readback(self.gather_blocks_dispatch(ids))

    @torch.inference_mode()
    def scatter_blocks(self, ids: List[int], k_blocks: torch.Tensor, v_blocks: torch.Tensor) -> None:
        """Install dense [n, L, BS, KH, D] host blocks at ``ids``, in the
        model dtype (requantized into int8 pools), in place."""
        idx = self._ids(ids)
        _scatter_blocks(self.k_cache, idx, self._from_host(k_blocks, self.config.dtype))
        _scatter_blocks(self.v_cache, idx, self._from_host(v_blocks, self.config.dtype))

    @torch.inference_mode()
    def gather_blocks_wire_dispatch(self, ids: List[int]):
        """Queue a pool-native gather (int8 pools: codes and scales, not
        dequantized — half the readback and half the wire) and its copy to
        the host; the two-phase contract of gather_blocks_dispatch."""
        if not self.pool_quantized():
            return ("dense", self.kv_wire_dtype(), self.gather_blocks_dispatch(ids))
        idx = self._ids(ids)
        kq, ks = _gather_blocks_q8(self.k_cache, idx)
        vq, vs = _gather_blocks_q8(self.v_cache, idx)
        return ("q8", "int8", self._to_host(kq, ks, vq, vs))

    @staticmethod
    def gather_blocks_wire_readback(handles):
        """The waiting half of gather_blocks_wire_dispatch: the blocks as
        disagg/wire.py KvWireBlocks. Call from a transfer thread."""
        from dynamo_tpu_torch.disagg.wire import KvWireBlocks

        form, dtype, (tensors, event) = handles
        if event is not None:
            event.synchronize()
        if form == "dense":
            k, v = tensors
            return KvWireBlocks(dtype=dtype, k=k, v=v)
        kq, ks, vq, vs = tensors
        return KvWireBlocks(dtype=dtype, k=kq, v=vq, k_scale=ks, v_scale=vs)

    def gather_blocks_wire(self, ids: List[int]):
        """Synchronous form (tests)."""
        return self.gather_blocks_wire_readback(self.gather_blocks_wire_dispatch(ids))

    @torch.inference_mode()
    def scatter_blocks_wire(self, ids: List[int], wire) -> None:
        """Install KvWireBlocks at ``ids``, in place: dense payloads through
        scatter_blocks (requantized into int8 pools on the device); int8
        payloads cross as int8 and land verbatim in int8 pools or
        dequantized on the device in dense pools."""
        if not wire.quantized:
            self.scatter_blocks(ids, wire.k, wire.v)
            return
        idx = self._ids(ids)
        _scatter_blocks_q8(self.k_cache, idx, self._from_host(wire.k),
                           self._from_host(wire.k_scale))
        _scatter_blocks_q8(self.v_cache, idx, self._from_host(wire.v),
                           self._from_host(wire.v_scale))

    def sync_all(self, tokens, start_pos, active, block_tables, temp, topk, topp, salts,
                 procs: Optional[Dict[str, np.ndarray]] = None, adapter_ids=None) -> int:
        """Write every slot's row of the decode state from host arrays
        (tables zero-padded to the full width; with ``procs``, the
        PROC_SLOT_STATE rows too; adapter ids 0 unless given); returns the
        tables' width."""
        S, P = self.args.max_num_seqs, self.args.max_blocks_per_seq
        tables = np.asarray(block_tables, np.int32)
        if len(tokens) != S or tables.shape[0] != S or tables.shape[1] > P:
            raise ValueError(f"the decode state holds {S} slots of {P} pages, got "
                             f"{len(tokens)} tokens and tables {tables.shape}")
        self.sync_slots(list(range(S)), {
            "tokens": np.asarray(tokens), "pos": np.asarray(start_pos),
            "active": np.asarray(active), "temp": np.asarray(temp), "topk": np.asarray(topk),
            "topp": np.asarray(topp), "salts": np.asarray(salts),
            "adapter_ids": np.zeros(S, np.int32) if adapter_ids is None else np.asarray(adapter_ids),
            **(procs or {}),
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


def _adapter_to_host(adapter: Any) -> Any:
    """Keep retained adapters as float32 host tensors (runner.py:226-233):
    only the stack belongs on the card; a device copy of each adapter kept
    for restacking would double the LoRA memory."""
    adapter.weights = {t: (A.detach().to("cpu", torch.float32), B.detach().to("cpu", torch.float32))
                       for t, (A, B) in adapter.weights.items()}
    return adapter


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
