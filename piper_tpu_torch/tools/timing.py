"""Timing on a CUDA card: CUDA events around calls, and the kernels' own
device time under torch.profiler."""

from __future__ import annotations

import statistics
from typing import Callable


def event_ms(fn: Callable, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn() (ms). Around small
    launches this is the host's enqueue time where the host is the slower."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn: Callable, reps: int = 10) -> float:
    """Device time of fn() (ms): the sum of its kernels' times under
    torch.profiler, per call, after one warm-up call. Raises if the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / reps / 1e3
