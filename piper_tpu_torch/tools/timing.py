"""Timing on a CUDA card: CUDA events around calls, the kernels' own device
time under torch.profiler, and the least time the card could take."""

from __future__ import annotations

import statistics
from typing import Callable, Iterable, Optional, Sequence, Tuple

# One H100 SXM's published peaks (NVIDIA's data sheet; dense, at its 700 W
# limit): HBM3 bytes/s, and FLOP/s by the type the products run in.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
# 32-bit integer operations a second: 64 INT32 lanes an SM a clock (the
# Hopper architecture white paper), 132 SMs, the 1.98 GHz boost clock the
# fp32 peak above assumes (128 fp32 lanes: 67 TFLOP/s counting an FMA as 2).
PEAK_INT32_OPS = 132 * 64 * 1.98e9
# A kernel tier's products (precision.py) at the card's fastest rate for
# them: fp32-class products as 3 passes of TF32 ("highest", as K2-K4 form
# them; CUDA-core fp32 is 67 TFLOP/s), 3 passes ("high") or 1 pass
# ("default") of bf16, on the tensor cores.
TIER_FLOPS = {"highest": PEAK_FLOPS["tf32"] / 3, "high": PEAK_FLOPS["bf16"] / 3,
              "default": PEAK_FLOPS["bf16"]}
_PROFILE_ATTEMPTS = 5
# On the H100, torch.profiler now and then drops the first kernels of a
# window: one, or some hundreds, in a few windows of a hundred (more on a
# loaded host), never one further in. So every window opens with SENTINELS
# launches of ATen's empty spin_kernel (torch.cuda._sleep(0)): a window that
# kept one of them kept every kernel launched after it, and one that kept
# none is profiled again. The sentinels are left out of every count and sum.
SENTINEL = "spin_kernel"
SENTINELS = 128
# Windows profiled in this process, and those that lost every sentinel.
WINDOWS = {"profiled": 0, "lost_head": 0}


def bound_ms(nbytes: float, flops: float = 0.0,
             flops_per_s: float = PEAK_FLOPS["fp32"]) -> Tuple[float, str]:
    """The least time (ms) the card could take for work that must move
    `nbytes` (each input read once, each output written once) and do `flops`
    at `flops_per_s`: the larger of the two times, and which one it is
    ("bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def card(device) -> Optional[dict]:
    """The card's name and power limit as nvidia-smi gives them
    ({"name", "power_limit", "nvidia_smi"}), or None on the CPU."""
    import subprocess

    import torch

    if torch.device(device).type != "cuda":
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(0), "power_limit": smi.split(",")[-1].strip(),
            "nvidia_smi": smi}


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
    them but the windows' sentinels when `name` is None."""
    from torch.autograd import DeviceType

    count, us = 0, 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        if (SENTINEL in e.key) if name is None else (name not in e.key):
            continue
        count += e.count
        us += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
    return count, us


def profiled(run: Callable) -> Optional[list]:
    """run() under torch.profiler, behind the SENTINELS, until the card is
    done: the window's averaged events, or None where the window lost every
    sentinel (and so, maybe, the first of run()'s kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SENTINELS):
            torch.cuda._sleep(0)
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    WINDOWS["profiled"] += 1
    if device_kernels(events, SENTINEL)[0]:
        return events
    WINDOWS["lost_head"] += 1
    return None


def _calls(fn: Callable, reps: int) -> Callable:
    def run():
        for _ in range(reps):
            fn()
    return run


def device_ms(fn: Callable, reps: int = 10, name: Optional[str] = None,
              expected: Optional[int] = None) -> float:
    """Device time of fn() (ms) under torch.profiler, per call, after one
    warm-up call: the sum over its kernels, or over those whose name holds
    `name`. With `expected` (kernels per call) the window must hold exactly
    expected * reps such kernels; without it, some device time. A window
    that fails the check, or lost its sentinels, is profiled again, up to
    _PROFILE_ATTEMPTS times in all, and then this raises."""
    fn()
    seen = []
    for _ in range(_PROFILE_ATTEMPTS):
        events = profiled(_calls(fn, reps))
        if events is None:
            seen.append("lost head")
            continue
        count, us = device_kernels(events, name)
        seen.append(count)
        if (count == expected * reps) if expected is not None else us > 0:
            return us / reps / 1e3
    what = f"kernels named {name!r}" if name else "kernels"
    if expected is not None:
        raise RuntimeError(f"torch.profiler: expected {expected * reps} {what} in {reps} "
                           f"calls, counted {seen} in {_PROFILE_ATTEMPTS} windows")
    raise RuntimeError(f"torch.profiler recorded no device time of {what} in "
                       f"{_PROFILE_ATTEMPTS} windows: {seen}")


def call_kernels(fn: Callable, name: Optional[str] = None, reps: int = 10,
                 attempts: int = _PROFILE_ATTEMPTS) -> Tuple[int, int]:
    """(all device kernels, those whose name holds `name`) that one call of
    fn() launches, from torch.profiler windows of `reps` calls each, as
    device_ms profiles them: the first counts that two whole windows in a
    row agree on, nonzero and a multiple of `reps`, divided by `reps`; a
    window that lost its sentinels is passed over. Raises after `attempts` + 1
    windows without that."""
    fn()
    seen, last = [], None
    for _ in range(attempts + 1):
        events = profiled(_calls(fn, reps))
        if events is None:
            seen.append("lost head")
            continue
        counts = [device_kernels(events)[0]]
        if name is not None:
            counts.append(device_kernels(events, name)[0])
        if counts == last and all(n > 0 and n % reps == 0 for n in counts):
            return counts[0] // reps, counts[-1] // reps if name is not None else 0
        seen.append(counts)
        last = counts
    raise RuntimeError(f"torch.profiler: no two windows of {reps} calls agree on their "
                       f"kernels (all, named {name!r}) as a multiple of {reps}: {seen}")


def profile_call(fn: Callable, symbol: str, counters: Sequence[Callable],
                 attempts: int = _PROFILE_ATTEMPTS) -> dict:
    """fn() once under torch.profiler: its device kernels and their summed
    device time (device busy), and the kernels whose symbol holds `symbol`:
    their time and count. The count must equal the launches the wrappers
    `counters` (each with a `.launches`) saw during the call, and the window
    must keep its sentinels, or the call is profiled again, `attempts` times
    in all, and then this raises."""
    seen = []
    for _ in range(attempts):
        before = sum(fn.launches for fn in counters)
        events = profiled(fn)
        want = sum(fn.launches for fn in counters) - before
        if events is None:
            seen.append(f"lost head, {want} launched")
            continue
        count, us = device_kernels(events)
        k_count, k_us = device_kernels(events, symbol)
        if k_count == want > 0:
            return {"device_kernels": count, "device_busy_ms": us / 1e3, "kernel_symbol": symbol,
                    "kernel_ms": k_us / 1e3, "kernel_launches": k_count}
        seen.append(f"{k_count} in the window, {want} launched")
    raise AssertionError(f"profile: {symbol} kernels: {seen}")
