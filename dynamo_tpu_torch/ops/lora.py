"""Batched multi-LoRA application — counterpart of dynamo_tpu/ops/lora.py.

Every sequence in the continuous batch carries an adapter index (0 = no
adapter, zero weights); adapters live stacked on a leading axis, and one
captured decode graph serves any mix of adapters. Scaling (alpha / r) is
folded into B at stack time (lora/loader.py), so a target costs a gather of
each row's A and B and two batched products, JAX's formulation. JAX's two
einsums are XLA, not Pallas, so these are plain torch ops: no kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

# stacked adapter weights of one target module in one layer:
#   A: [N_adapters+1, d_in, r],  B: [N_adapters+1, r, d_out]
LoraLayer = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def apply_lora(
    x: torch.Tensor,  # [B, C, d_in] (normed layer input / attn output)
    ab: Tuple[torch.Tensor, torch.Tensor],
    adapter_ids: torch.Tensor,  # [B] int, 0 = none
) -> torch.Tensor:
    """x @ A[ids] @ B[ids] — the low-rank delta, [B, C, d_out]."""
    A, B = ab
    Ax = torch.einsum("bcd,bdr->bcr", x, A.index_select(0, adapter_ids))
    return torch.einsum("bcr,brh->bch", Ax, B.index_select(0, adapter_ids))


def lora_delta(
    lora: Optional[LoraLayer],
    target: str,
    x: torch.Tensor,
    adapter_ids: Optional[torch.Tensor],
) -> Optional[torch.Tensor]:
    """Delta for ``target``, or None when the stack does not touch it or
    there are no ids (JAX returns a zero-dim zero there, which XLA folds
    away; models/llama.py adds nothing then, so a model without LoRA
    launches nothing extra)."""
    if not lora or target not in lora or adapter_ids is None:
        return None
    return apply_lora(x, lora[target], adapter_ids)
