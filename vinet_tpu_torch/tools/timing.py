"""Device time of a function on a CUDA card, by CUDA events."""

from __future__ import annotations

import time

import torch

SPIN_CYCLES_PER_S = 2e9  # torch.cuda._sleep counts clock cycles; about 2 GHz


def cuda_ms(fn, iters: int, hide_host: bool = True) -> float:
    """Mean device time of fn over iters back-to-back calls, by CUDA events.

    With ``hide_host``, a spin kernel queued ahead of the first event holds
    the card while the host queues all iters calls, so the host's cost per
    call (Python, ctypes) does not enter the time of a kernel shorter than
    it. Without it, the calls are timed as the host issues them, and a kernel
    shorter than its caller's host cost reads as that cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hide_host:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(min(host_s, 0.1) * SPIN_CYCLES_PER_S * 1.5) + 1_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
