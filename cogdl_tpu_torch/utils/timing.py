"""Timing a call on the device it runs on."""

from __future__ import annotations

import time

import torch

# The card's sleep ahead of a device-time window: long enough that the host
# queues every timed call before it ends (20 calls of a probe wrapper take
# 0.5-1.5 ms to enqueue on the H100's host, a first call in a process
# several times that), checked on the host clock each time.
SLEEP_MS = 20.0
# torch.cuda._sleep counts SM clock cycles; the H100's boost clock. At a
# lower clock the sleep lasts longer, which only widens the margin.
SLEEP_CYCLES_PER_MS = 1.98e6


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


def behind_sleep(enqueue, sleep_ms: float = SLEEP_MS,
                 clock=time.perf_counter) -> float:
    """Run ``enqueue()``, which queues work on the current stream, while the
    stream sleeps ``sleep_ms`` on the card, so that the card starts the
    work only once the host has queued all of it; returns the host seconds
    ``enqueue`` took. Raises if they outlasted the sleep, measured by
    events around it: the card could then have waited for the host."""
    before, after = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = clock()
    before.record()
    torch.cuda._sleep(int(sleep_ms * SLEEP_CYCLES_PER_MS))
    after.record()
    enqueue()
    enqueue_s = clock() - t0
    after.synchronize()
    slept_ms = before.elapsed_time(after)
    if not enqueue_s * 1e3 < slept_ms:
        raise RuntimeError(
            f"behind_sleep: the host took {enqueue_s * 1e3:.3f} ms to "
            f"enqueue and the card slept {slept_ms:.3f} ms before the work: "
            "the window may hold host time; raise sleep_ms")
    return enqueue_s


def time_device_ms(fn, device: torch.device, iters: int = 20,
                   warmup: int = 3, sleep_ms: float = SLEEP_MS,
                   clock=time.perf_counter):
    """``(device_ms, host_us_per_call)`` of ``fn`` with the host held out of
    the device's window: the host queues all ``iters`` calls while the
    stream sleeps (:func:`behind_sleep`, which raises if the enqueue
    outlasted the sleep), and CUDA events after the sleep and after the
    last call time what the card did, back to back. ``host_us_per_call``
    is the host clock's time to enqueue one call. On the CPU both numbers
    are the host clock's (rehearsal only)."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = clock()
        for _ in range(iters):
            fn()
        dt = clock() - t0
        return dt * 1e3 / iters, dt * 1e6 / iters
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def enqueue():
        start.record()
        for _ in range(iters):
            fn()
        end.record()

    enqueue_s = behind_sleep(enqueue, sleep_ms, clock)
    end.synchronize()
    return start.elapsed_time(end) / iters, enqueue_s * 1e6 / iters
