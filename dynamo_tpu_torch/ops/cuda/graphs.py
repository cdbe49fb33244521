"""CUDA graph capture of a call that goes through the port's kernel
wrappers, with launch counts that stay exact under replay.

Each wrapper adds one to its ``launch_counts`` entry on the host where it
launches its kernel. Under stream capture nothing launches: the wrapper's
Python runs once and its kernel becomes a node of the graph, which every
replay runs again without the Python. ``CapturedCall`` therefore takes the
counts' change over the capture as the graph's deltas, puts the counts back
as they were (the capture launched nothing), and adds the deltas on every
replay. A capture that fails raises; nothing falls back to an eager call.

What the kernels need under capture, checked for the decode path: each
launches on the current stream and its wrapper allocates with
``torch.empty`` (from the graph's pool while capturing); the fused layer
launches cooperatively through ``cudaLaunchKernelExC`` with the
cooperative attribute, which capture records, and zeroes its workspace's
counters itself at every launch; the launch plans, split counts and the
card's capacity queries are cached by the eager warm-up; the tensor maps
of csrc/int8_stream.cuh are cached by address, shape and box, so a map
made for an eager tensor is never taken for a graph-pool tensor of
another shape at the same address, and a node keeps the map it was
captured with.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch


def counters() -> List[Dict[str, int]]:
    """Every kernel wrapper's launch-count dictionary."""
    from dynamo_tpu_torch.ops.cuda import (
        decode_attention_proto, ffn_int8, fused_layer, int8_matmul, lm_head, paged_attention,
    )

    return [paged_attention.launch_counts, paged_attention.int8_launch_counts,
            fused_layer.launch_counts, lm_head.launch_counts, int8_matmul.launch_counts,
            decode_attention_proto.launch_counts, ffn_int8.launch_counts]


def _snapshot() -> List[Dict[str, int]]:
    return [dict(c) for c in counters()]


class CapturedCall:
    """One CUDA graph of ``fn()``, captured on ``stream`` into the memory
    pool ``pool`` (shared between graphs that never run at once). ``fn``
    must read and write only tensors whose addresses outlive the graph, and
    must already have run once eagerly on ``stream`` (the warm-up the
    PyTorch documentation prescribes: lazy initialisation, cached launch
    plans and occupancy queries happen there, not in the capture)."""

    def __init__(self, fn: Callable[[], Any], *, pool: Any, stream: "torch.cuda.Stream") -> None:
        before = _snapshot()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                fn()
        finally:
            after = _snapshot()
            for live, old in zip(counters(), before):
                live.clear()
                live.update(old)
        self.deltas = [{k: after_c[k] - old.get(k, 0) for k in after_c if after_c[k] != old.get(k, 0)}
                       for after_c, old in zip(after, before)]
        self.replays = 0

    def replay(self) -> None:
        """Run the graph on the current stream and add its launches."""
        self.graph.replay()
        self.replays += 1
        for live, delta in zip(counters(), self.deltas):
            for name, n in delta.items():
                live[name] = live.get(name, 0) + n

    @property
    def launches(self) -> int:
        """Kernel launches through the wrappers a replay adds."""
        return sum(sum(d.values()) for d in self.deltas)
