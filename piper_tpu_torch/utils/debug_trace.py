"""Per-layer intermediate tracing for parity bisection.

The reference can execute the graph to any of its 2755 nodes and inspect the
whole value table (GraphExecutor.execute(maxNodeIndex:),
GraphExecutor.swift:73-152). The native modules here are a few dozen layers,
so the equivalent is a per-layer trace: while a collector is active, each
module records its named intermediates (one entry per conv/flow-step/attn
layer, keyed by the checkpoint parameter path that produced it). If a real
voice ever mismatches the oracle, diffing two traces bisects the first
divergent layer directly.

Zero cost when inactive: `trace_put` is a no-op unless `collecting()` wraps
the call, and the jitted production paths never run under a collector.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

_collector: Optional[Dict] = None


def trace_put(name: str, value) -> None:
    """Record an intermediate under `name` if a trace collector is active."""
    if _collector is not None:
        _collector[name] = value


def tracing() -> bool:
    return _collector is not None


@contextmanager
def collecting(into: Dict):
    """Activate per-layer trace collection into `into` for the duration."""
    global _collector
    prev = _collector
    _collector = into
    try:
        yield into
    finally:
        _collector = prev
