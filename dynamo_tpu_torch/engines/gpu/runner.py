"""DeviceRunner — owner of the device state (weights, KV pools, sampling
seed) and the two device programs the scheduler calls; counterpart of
dynamo_tpu/engines/tpu/runner.py.

The JAX runner keeps device-resident slot state, a donated carry and a
cache of compiled programs per shape bucket. PyTorch runs eagerly, so this
runner takes the scheduler's host arrays on every call: ``run_step`` for
one prefill chunk round, ``run_decode`` for one burst of ``decode_steps``.
Both run on the engine's single device thread.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from dynamo_tpu_torch import config as knobs
from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.quantize import init_quantized_params, quantize_params
from dynamo_tpu_torch.ops.fused_layer import supports_reason
from dynamo_tpu_torch.ops.sampling import fold_row_keys, sample_tokens


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
        *, first_chunk: bool = False,
    ) -> np.ndarray:
        """One prefill chunk round over [B, C] rows + the sample of each
        row's next token, keyed at index start + len. Returns [B] ids."""
        d = self._dev
        start = d(start_pos, torch.int32)
        lens = d(chunk_lens, torch.int32)
        logits, self.k_cache, self.v_cache = llama.forward_paged(
            self.params, self.config, d(tokens, torch.int64), start, lens,
            d(block_tables, torch.int32), self.k_cache, self.v_cache,
            first_chunk=first_chunk,
        )
        keys = fold_row_keys(self.seed, d(salts, torch.int64), start + lens)
        toks = sample_tokens(
            logits, d(temp, torch.float32), d(topk, torch.int32), d(topp, torch.float32),
            row_keys=keys,
        )
        return toks.cpu().numpy()

    @torch.inference_mode()
    def run_decode(
        self, tokens, start_pos, active, block_tables, temp, topk, topp, salts,
    ) -> np.ndarray:
        """One burst of ``decode_steps`` fused decode steps. Returns [B, K]
        sampled ids (rows with active = 0 repeat their input token)."""
        d = self._dev
        out = llama.decode_multi(
            self.params, self.config, d(tokens, torch.int64), d(start_pos, torch.int32),
            d(active, torch.int32), d(block_tables, torch.int32),
            self.k_cache, self.v_cache, self.seed,
            d(temp, torch.float32), d(topk, torch.int32), d(topp, torch.float32),
            num_steps=self.args.decode_steps, salts=d(salts, torch.int64),
            use_megakernel=self.use_megakernel,
        )
        self.mk_fused_bursts += int(self.use_megakernel)
        finite = out.finite.cpu().numpy()
        self.nonfinite_rows += int(np.count_nonzero(~finite & (np.asarray(active) > 0)))
        return out.tokens.cpu().numpy()
