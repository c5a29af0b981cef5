"""Device time of one call (counterpart of bench.py:47
``device_seconds_per_iter``, which ``validate/test.py`` uses for its
device-only images/s).

On the card: CUDA events around ``reps`` calls after ``warmup`` calls,
the host queueing ahead, so the figure is the card's time per call
unless the host cannot keep up. On the CPU: ``time.perf_counter``.
"""

from __future__ import annotations

import time

import torch


def device_seconds_per_iter(fn, device, reps: int = 5, warmup: int = 2) -> float:
    """Seconds per call of ``fn()`` on ``device``."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps
