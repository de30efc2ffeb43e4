"""Timing on a CUDA card: CUDA events around calls, the kernels' own device
time under torch.profiler, and the least time the card could take."""

from __future__ import annotations

import statistics
from typing import Callable, Iterable, Optional, Sequence, Tuple

# One H100 SXM's published peaks (NVIDIA's data sheet; dense, at its 700 W
# limit): HBM3 bytes/s, and FLOP/s by the type the products run in.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
# A kernel tier's products (precision.py) at the card's fastest rate for
# them: fp32-class products as 3 passes of TF32 ("highest", as K2-K4 form
# them; CUDA-core fp32 is 67 TFLOP/s), 3 passes ("high") or 1 pass
# ("default") of bf16, on the tensor cores.
TIER_FLOPS = {"highest": PEAK_FLOPS["tf32"] / 3, "high": PEAK_FLOPS["bf16"] / 3,
              "default": PEAK_FLOPS["bf16"]}
_PROFILE_ATTEMPTS = 3


def bound_ms(nbytes: float, flops: float = 0.0,
             flops_per_s: float = PEAK_FLOPS["fp32"]) -> Tuple[float, str]:
    """The least time (ms) the card could take for work that must move
    `nbytes` (each input read once, each output written once) and do `flops`
    at `flops_per_s`: the larger of the two times, and which one it is
    ("bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


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


def device_kernels(events: Iterable, name: Optional[str] = None) -> Tuple[int, float]:
    """(count, µs) of the device kernels among torch.profiler's averaged
    events (`prof.key_averages()`): those whose name holds `name`, or all of
    them when `name` is None."""
    from torch.autograd import DeviceType

    count, us = 0, 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA or (name is not None and name not in e.key):
            continue
        count += e.count
        us += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
    return count, us


def device_ms(fn: Callable, reps: int = 10, name: Optional[str] = None,
              expected: Optional[int] = None) -> float:
    """Device time of fn() (ms) under torch.profiler, per call, after one
    warm-up call: the sum over its kernels, or over those whose name holds
    `name`. With `expected` (kernels per call) the window must hold exactly
    expected * reps such kernels; without it, some device time. A window
    that fails the check is profiled again, up to _PROFILE_ATTEMPTS times in
    all, and then this raises (on the H100 a window late in a long process
    has come back empty, once in some fifty)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(_PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        count, us = device_kernels(prof.key_averages(), name)
        seen.append(count)
        if (count == expected * reps) if expected is not None else us > 0:
            return us / reps / 1e3
    what = f"kernels named {name!r}" if name else "kernels"
    if expected is not None:
        raise RuntimeError(f"torch.profiler: expected {expected * reps} {what} in {reps} "
                           f"calls, counted {seen} in {_PROFILE_ATTEMPTS} windows")
    raise RuntimeError(f"torch.profiler recorded no device time of {what} in "
                       f"{_PROFILE_ATTEMPTS} windows")


def call_kernels(fn: Callable, name: Optional[str] = None, reps: int = 10,
                 attempts: int = _PROFILE_ATTEMPTS) -> Tuple[int, int]:
    """(all device kernels, those whose name holds `name`) that one call of
    fn() launches, from torch.profiler windows of `reps` calls each, as
    device_ms profiles them: the first counts that two windows in a row
    agree on, nonzero and a multiple of `reps`, divided by `reps`. Raises
    after `attempts` + 1 windows without that. (On the H100 a window of one
    call has counted one kernel fewer than its share of a longer window.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        counts = [device_kernels(events)[0]]
        if name is not None:
            counts.append(device_kernels(events, name)[0])
        if seen and counts == seen[-1] and all(n > 0 and n % reps == 0 for n in counts):
            return counts[0] // reps, counts[-1] // reps if name is not None else 0
        seen.append(counts)
    raise RuntimeError(f"torch.profiler: no two windows of {reps} calls agree on their "
                       f"kernels (all, named {name!r}) as a multiple of {reps}: {seen}")


def profile_call(fn: Callable, symbol: str, counters: Sequence[Callable],
                 attempts: int = _PROFILE_ATTEMPTS) -> dict:
    """fn() once under torch.profiler: its device kernels and their summed
    device time (device busy), and the kernels whose symbol holds `symbol`:
    their time and count. The count must equal the launches the wrappers
    `counters` (each with a `.launches`) saw during the call, or the call
    is profiled again, `attempts` times in all, and then this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        before = sum(fn.launches for fn in counters)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        want = sum(fn.launches for fn in counters) - before
        events = prof.key_averages()
        count, us = device_kernels(events)
        k_count, k_us = device_kernels(events, symbol)
        if k_count == want > 0:
            return {"device_kernels": count, "device_busy_ms": us / 1e3, "kernel_symbol": symbol,
                    "kernel_ms": k_us / 1e3, "kernel_launches": k_count}
    raise AssertionError(f"profile: {k_count} {symbol} kernels in the window, {want} launched")
