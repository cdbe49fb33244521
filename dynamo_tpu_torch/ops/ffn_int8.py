"""The int8 weight-streaming FFN of the TPU prototype ``ffn_pallas``
(_prof_fused_ffn.py:116, body ``_ffn_kernel`` :32): a SwiGLU MLP with
int8 weights and per-column float32 scales, no norm and no residual.

    g = (x·Wg)·sg,  u = (x·Wu)·su          float32
    h = bf16((g·sigmoid(g))·u)
    out = bf16((h·Wd)·sd)

x bf16 [M, d]; Wg, Wu int8 [d, F]; Wd int8 [F, d]; sg, su float32 [1, F];
sd float32 [1, d]. Its rounding points differ from the serving MLP's (three
``qeinsum``s, each product rounded to bf16 before its scale), so it has a
plain version and an entry point of its own (the kernel's wrapper,
ops/cuda/ffn_int8.ffn_int8); no serving path calls it.
"""

from __future__ import annotations

import torch


def ffn_int8_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                 sg: torch.Tensor, su: torch.Tensor, sd: torch.Tensor) -> torch.Tensor:
    """Plain version at the prototype's rounding points: the products of
    bf16 activations and int8 codes summed in float32 (each product is
    exact in float32, and in TF32 too, so the card's matmul precision
    setting does not move them), the scales applied in float32,
    (g·sigmoid(g))·u rounded to bf16, and the down product times its scale
    rounded to bf16."""
    f32 = torch.float32
    xf = x.to(torch.bfloat16).to(f32)
    g = torch.matmul(xf, wg.to(f32)) * sg.reshape(-1)
    u = torch.matmul(xf, wu.to(f32)) * su.reshape(-1)
    h = (g * torch.sigmoid(g) * u).to(torch.bfloat16)
    y = torch.matmul(h.to(f32), wd.to(f32)) * sd.reshape(-1)
    return y.to(torch.bfloat16)

