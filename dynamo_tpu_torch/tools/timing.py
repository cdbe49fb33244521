"""Clocks for the profiling entry points (tools/prof_*.py): CUDA events on
the card, the host clock when the caller asked for the CPU. Every result
names the device it ran on, so a CPU time is never read as a card's."""

from __future__ import annotations

import time
from typing import Callable, List

import torch


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu (host clock)"


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def elapsed_ms(fn: Callable[[], object], device: torch.device, reps: int) -> List[float]:
    """Milliseconds of each of ``reps`` calls of ``fn`` after one warm-up
    call: CUDA events around each call on the card (the device time from
    its first queued op to its last), the host clock around a synchronised
    call on the CPU."""
    fn()
    synchronize(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize(device)
            times.append(t0.elapsed_time(t1))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return times


def queued_ms(fn: Callable[[], object], iters: int) -> float:
    """Device ms of one call of ``fn`` on the card: CUDA events around
    ``iters`` calls queued back to back, after three warm-up calls. The
    stream is first held by a sleep kernel longer than the host takes to
    queue the calls, so a call whose host side outlasts its kernel is timed
    on the device and not at the host's enqueue rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t_host
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(1.0, 2 * iters * host_s + 1e-3) * 2e9))  # cycles, ~2 GHz
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters
