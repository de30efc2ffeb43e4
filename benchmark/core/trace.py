"""The device trace of a run: torch.profiler (CUDA activity) over the last
slice of the window, read into busy time, kernel time by name and idle
gaps labelled by what the benchmark's host thread was doing.

Sentinels: a frozen copy of `piper_tpu_torch/tools/timing.py`'s device
(commit 1fc906d). On the H100 torch.profiler now and then drops the first
kernels of a window, never one further in; so a trace opens with
SENTINELS launches of ATen's empty spin_kernel (torch.cuda._sleep(0)), here
on a side stream so they run at once beside the program's work. A trace
that kept one of them kept every kernel after it; the analysis starts at
the first one kept, and the sentinels are left out of every sum. The first
one also ties the host clock to the trace's: it starts on the device a few
microseconds after its launch, whose host time is noted.

Host spans: the benchmark records its own calls into the program
(`bench.submit_batch`, `bench.wait_batch`, `bench.submit`) while a trace
runs; an idle gap is labelled by the span open across its midpoint. Only
CUDA activity is recorded: recording every host operation slowed the host
itself (a host-bound cell's throughput fell by a quarter).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

SENTINEL = "spin_kernel"
SENTINELS = 128


def span(tracer: Optional["Tracer"], name: str):
    """A host span of the benchmark's, kept while `tracer` runs."""
    return tracer.span(name) if tracer is not None else contextlib.nullcontext()


class Tracer:
    """One profiled interval of a run."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.side = torch.cuda.Stream(device=device)
        self.prof = None
        self.h0 = None
        self.spans: List[Tuple[float, float, str]] = []
        self.active = False

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA])

    def warm(self) -> None:
        """A throwaway profile, so that the trace's start does not pay the
        profiler's first initialisation."""
        with self._profile():
            self.torch.cuda._sleep(0)
            self.torch.cuda.synchronize()

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.__enter__()
        with self.torch.cuda.stream(self.side):
            self.h0 = time.perf_counter()
            for _ in range(SENTINELS):
                self.torch.cuda._sleep(0)
        self.active = True

    def stop(self) -> None:
        self.active = False
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((t0, time.perf_counter(), name))

    def analyse(self, t_open: float, t_close: float) -> Optional[dict]:
        """Busy time, kernel time by name and idle gaps over the host
        interval [t_open, t_close] (perf_counter seconds), from the first
        kept sentinel on."""
        from torch.autograd import DeviceType

        dev = [(e.time_range.start, e.time_range.end, e.name) for e in self.prof.events()
               if e.device_type == DeviceType.CUDA]
        sentinels = [s for s, _, n in dev if SENTINEL in n]
        work = [d for d in dev if SENTINEL not in d[2]]
        if not work:
            return None
        first = min(sentinels) if sentinels else min(s for s, _, _ in work)
        offset = first - self.h0 * 1e6  # trace µs = host s * 1e6 + offset
        lo = max(t_open * 1e6 + offset, first)
        hi = t_close * 1e6 + offset
        work = sorted((max(s, lo), min(e, hi), n) for s, e, n in work if e > lo and s < hi)
        by_name: Dict[str, float] = defaultdict(float)
        busy, cur_s, cur_e = 0.0, None, None
        gaps: List[Tuple[float, float]] = []
        last_end = lo
        for s, e, n in work:
            by_name[n] += e - s
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
            if s > last_end:
                gaps.append((last_end, s))
            last_end = max(last_end, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        if hi > last_end:
            gaps.append((last_end, hi))
        spans = [(a * 1e6 + offset, b * 1e6 + offset, n) for a, b, n in self.spans]
        return {
            "window_s": (hi - lo) / 1e6,
            "busy_s": busy / 1e6,
            "kernel_s": {n: v / 1e6 for n, v in by_name.items()},
            "idle_gaps": _label_gaps(gaps, spans),
            "lost_head": not sentinels,
        }


def _label_gaps(gaps, spans, longest: int = 200) -> List[Tuple[str, float]]:
    """Idle seconds summed by label, the ten largest: each of the `longest`
    gaps by the benchmark span open across its midpoint (the latest
    started), the shorter ones together."""
    totals: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    spans = sorted(spans)
    for g0, g1 in gaps[:longest]:
        mid = (g0 + g1) / 2
        label = "no bench span"
        for s, e, n in spans:
            if s > mid:
                break
            if e >= mid:
                label = n
        totals[label] += (g1 - g0) / 1e6
        counts[label] += 1
    if len(gaps) > longest:
        label = f"gaps under {(gaps[longest - 1][1] - gaps[longest - 1][0]) / 1e3:.3f} ms"
        totals[label] = sum(g1 - g0 for g0, g1 in gaps[longest:]) / 1e6
        counts[label] = len(gaps) - longest
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    return [(f"{k} (x{counts[k]})", v) for k, v in ranked]
