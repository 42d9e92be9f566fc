"""Timing a call on the device it runs on."""

from __future__ import annotations

import time

import torch


def time_ms(fn, device: torch.device, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call: CUDA events on the card, the host clock on
    the CPU (rehearsal only)."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters
