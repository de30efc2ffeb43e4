"""Per-stage synthesis profiler.

The analog of the reference's per-op-type profiler + flush accounting
(GraphExecutor.swift:163-175, :285-319): on TPU whole stages are single
compiled programs, so the interesting axes are stage wall time, shape bucket,
and compile events — not per-op dispatch.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


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


class Profiler:
    """Accumulates (stage, bucket) -> timing stats."""

    def __init__(self):
        self.stats: Dict[Tuple[str, int], StageStats] = defaultdict(StageStats)
        self._t0: Optional[float] = None
        # Pipelined serving records from fetcher/worker threads.
        self._lock = threading.Lock()

    def record(self, stage: str, bucket: int, ms: float, compiled: bool = False) -> None:
        with self._lock:
            self.stats[(stage, bucket)].add(ms, compiled)

    def rows(self) -> List[Tuple[str, int, StageStats]]:
        with self._lock:
            return sorted(
                ((s, b, st) for (s, b), st in self.stats.items()),
                key=lambda r: -r[2].total_ms,
            )

    def summary(self, top: int = 20) -> str:
        lines = [
            f"{'stage':<12} {'bucket':>7} {'count':>6} {'mean_ms':>9} "
            f"{'max_ms':>9} {'total_ms':>10} {'compiles':>8}"
        ]
        for stage, bucket, st in self.rows()[:top]:
            lines.append(
                f"{stage:<12} {bucket:>7} {st.count:>6} {st.mean_ms:>9.2f} "
                f"{st.max_ms:>9.2f} {st.total_ms:>10.1f} {st.compiles:>8}"
            )
        return "\n".join(lines)

    def dump(self, file=None) -> None:
        print(self.summary(), file=file or sys.stderr)
