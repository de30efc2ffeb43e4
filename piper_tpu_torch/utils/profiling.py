"""Per-stage synthesis profiler and the port's timeline: one set of spans.

The analog of the reference's per-op-type profiler + flush accounting
(GraphExecutor.swift:163-175, :285-319): on the card whole stages are
queued as a few launches, so the interesting axes are stage wall time,
shape bucket, and first runs — not per-op dispatch.

A span (`Profiler.span`, or the process-wide `span` for code with no
runtime at hand) times one piece of host work at a layer boundary.

- Aggregates, always on: on exit a span adds host wall ms to its row
  (stage, bucket), as `record` does; `row=None` adds none (the runtime
  feeds the JAX runtime's row names from its spans' `ms` itself).
  PIPER_TPU_PROFILE=1 prints the table at exit (engine/runtime.py).
- The timeline, while it is open: every span also appends one `Record` to
  `RING`, a bounded deque at module level, so a reader finds the records
  after the runtime is freed. A record holds the span's name, start and
  end on `time.perf_counter()`, thread, parent span, batch id (shared by
  every span of one batch or group: a span takes its parent's, or a new
  one), attributes and, where the span brackets device work on the card
  (`device=`), a pair of CUDA events recorded on the current stream at its
  start and end. The events are read only when a reader asks, so the hot
  path never synchronizes. An event marks a position in its stream: where
  the stream is busy it runs as the work queued before it ends, where the
  stream is idle as the host records it. So a start event on an idle
  stream times the moment the host began queueing the span's work, before
  its first launch is prepared.

The timeline is open while PIPER_TPU_TRACE=1 (read when a Profiler is
made; the runtime then prints one stderr line a run) or while a
torch.profiler session is active anywhere in the process:
`torch.autograd.profiler._is_profiler_enabled` is a module global every
thread sees (`torch.autograd._profiler_enabled()` is per thread, and reads
False in a worker thread while the main thread profiles). Closed, a span
costs one flag check and its aggregate row, and makes no events.

One clock: the first span with events after the timeline opens records an
anchor event on an idle side stream of its device and notes
`perf_counter()` beside it; `Record.clock(ev)` maps any event of the record
onto perf_counter as t_anchor + anchor.elapsed_time(ev) / 1e3, the clock
the benchmark's tracer ties to the profiler's trace.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch.autograd.profiler as _autograd_profiler

from piper_tpu_torch.utils.env import trace_enabled

RING_SIZE = 1 << 15
RING: deque = deque(maxlen=RING_SIZE)

_tls = threading.local()
_ids = itertools.count(1)
_batch_ids = itertools.count(1)
_anchor_lock = threading.Lock()
_anchors: Dict[int, "Anchor"] = {}
_anchor_streams: Dict[int, object] = {}
_anchored_under_profiler = False


@dataclass
class StageStats:
    count: int = 0
    total_ms: float = 0.0
    max_ms: float = 0.0
    compiles: int = 0

    def add(self, ms: float, compiled: bool) -> None:
        self.count += 1
        self.total_ms += ms
        self.max_ms = max(self.max_ms, ms)
        if compiled:
            self.compiles += 1

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0


@dataclass
class Anchor:
    """One CUDA event recorded on an idle stream and the host's
    perf_counter() just after its record call."""

    event: object
    t: float


class Record:
    """One span on the timeline. `events` is (start, end) CUDA events or
    None; `clock(ev)` maps one of them onto perf_counter."""

    __slots__ = ("name", "id", "parent", "batch", "thread", "t0", "t1", "bucket", "attrs",
                 "events", "anchor")

    def __init__(self, name, id, parent, batch, thread, t0, t1=None, bucket=None, attrs=None,
                 events=None, anchor=None):
        self.name, self.id, self.parent, self.batch, self.thread = name, id, parent, batch, thread
        self.t0, self.t1, self.bucket, self.attrs = t0, t1, bucket, attrs or {}
        self.events, self.anchor = events, anchor

    def clock(self, ev) -> float:
        return self.anchor.t + self.anchor.event.elapsed_time(ev) / 1e3

    def __repr__(self) -> str:
        return (f"Record({self.name!r}, id={self.id}, parent={self.parent}, batch={self.batch}, "
                f"{self.thread}, {self.t0:.6f}-{self.t1:.6f}, {self.attrs})")


def profiler_active() -> bool:
    """A torch.profiler session is active in some thread of the process."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


def _anchor(device) -> Anchor:
    """The anchor of `device` for the timeline's current opening: made
    anew when a torch.profiler session has started or stopped since."""
    global _anchored_under_profiler
    import torch

    on = profiler_active()
    with _anchor_lock:
        if on != _anchored_under_profiler:
            _anchors.clear()
            _anchored_under_profiler = on
        idx = device.index if device.index is not None else torch.cuda.current_device()
        a = _anchors.get(idx)
        if a is None:
            # High priority: a pool the program's and the benchmark's
            # side streams (default priority) do not draw from.
            side = _anchor_streams.get(idx)
            if side is None:
                side = _anchor_streams[idx] = torch.cuda.Stream(device=idx, priority=-1)
                # A stream's first command pays CUDA's set-up for it: pay
                # it here, once, on this idle stream alone.
                warm = torch.cuda.Event()
                warm.record(side)
                warm.synchronize()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(side)
            a = _anchors[idx] = Anchor(ev, time.perf_counter())
        return a


def _event(device):
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class Span:
    """Context manager of Profiler.span. Inside the body `bucket` and
    `attrs` may be set; after exit `ms` is the host wall time."""

    __slots__ = ("prof", "name", "bucket", "row", "device", "batch", "attrs", "rec", "t0", "ms")

    def __init__(self, prof, name, bucket, row, device, batch, attrs):
        self.prof, self.name, self.bucket, self.row = prof, name, bucket, row
        self.device, self.batch, self.attrs = device, batch, attrs
        self.rec = None
        self.ms = 0.0

    def __enter__(self) -> "Span":
        if self.prof.trace or profiler_active():
            stack = getattr(_tls, "stack", None)
            if stack is None:
                stack = _tls.stack = []
            parent = stack[-1] if stack else None
            if self.batch is None:
                self.batch = parent.batch if parent is not None else next(_batch_ids)
            rec = self.rec = Record(self.name, next(_ids), parent.id if parent else None,
                                    self.batch, threading.current_thread().name, 0.0)
            stack.append(rec)
            if self.device is not None and self.device.type == "cuda":
                rec.anchor = _anchor(self.device)
                rec.events = (_event(self.device), None)
            rec.t0 = self.t0 = time.perf_counter()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        rec = self.rec
        if rec is not None:
            if rec.events is not None:
                rec.events = (rec.events[0], _event(self.device))
            rec.t1 = t1 = time.perf_counter()
            rec.bucket, rec.attrs = self.bucket, self.attrs
            _tls.stack.pop()
            RING.append(rec)
        else:
            t1 = time.perf_counter()
        self.ms = (t1 - self.t0) * 1e3
        if self.row is not None:
            self.prof.record(self.row, self.bucket, self.ms)


_ROW = object()  # span()'s default row: the span's own name


class Profiler:
    """Accumulates (stage, bucket) -> timing stats and makes the spans
    that feed them and the timeline. `trace` (PIPER_TPU_TRACE=1 when the
    profiler is made) keeps the timeline open for this profiler's spans."""

    def __init__(self):
        self.stats: Dict[Tuple[str, int], StageStats] = defaultdict(StageStats)
        self.trace = trace_enabled()
        # Pipelined serving records from fetcher/worker threads.
        self._lock = threading.Lock()

    def record(self, stage: str, bucket: int, ms: float, compiled: bool = False) -> None:
        with self._lock:
            self.stats[(stage, bucket)].add(ms, compiled)

    def span(self, name: str, bucket=None, *, row=_ROW, device=None, batch: Optional[int] = None,
             **attrs) -> Span:
        """A span of host work named `name`, adding its row (`row`, by
        default `name`; None for none) at `bucket`. `device`: the card the
        work is queued on (CUDA events bracket it while the timeline is
        open); `batch`: the batch id when the caller carries it across
        threads or calls (default: the parent span's, or a new one)."""
        return Span(self, name, bucket, name if row is _ROW else row, device, batch, attrs)

    def rows(self) -> List[Tuple[str, int, StageStats]]:
        with self._lock:
            return sorted(
                ((s, b, st) for (s, b), st in self.stats.items()),
                key=lambda r: -r[2].total_ms,
            )

    def summary(self, top: int = 20) -> str:
        lines = [
            f"{'stage':<17} {'bucket':>7} {'count':>6} {'mean_ms':>9} "
            f"{'max_ms':>9} {'total_ms':>10} {'compiles':>8}"
        ]
        for stage, bucket, st in self.rows()[:top]:
            lines.append(
                f"{stage:<17} {str(bucket):>7} {st.count:>6} {st.mean_ms:>9.2f} "
                f"{st.max_ms:>9.2f} {st.total_ms:>10.1f} {st.compiles:>8}"
            )
        return "\n".join(lines)

    def dump(self, file=None) -> None:
        print(self.summary(), file=file or sys.stderr)


PROCESS = Profiler()


def span(name: str, bucket=None, **kwargs) -> Span:
    """Profiler.span on the process-wide profiler `PROCESS`, for code
    with no runtime at hand."""
    return PROCESS.span(name, bucket, **kwargs)
