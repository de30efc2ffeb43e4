"""What a loop's window hands back: the rows to judge, the end-to-end
readings, the program's counters and the trace."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from benchmark.reference.judge import Row


@dataclass
class Window:
    t_open: float = 0.0   # the end of set-up: setup_s runs from the process's start to here
    t_close: float = 0.0
    rows: List[Row] = field(default_factory=list)
    frames: List[List[int]] = field(default_factory=list)     # live frames, by group
    phonemes: List[List[int]] = field(default_factory=list)   # live phonemes, by group
    e2e: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    info: Dict[str, object] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    trace: Optional[dict] = None
    traced_frames: List[List[int]] = field(default_factory=list)  # groups done in the trace
