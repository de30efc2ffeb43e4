"""The readers of the program's timeline (read_gap_share.offline,
batch_gap_share.offline, frame_fill.offline) on hand-made records: nothing
on an empty timeline or a program without one, the values worked out by
hand on three batches with stub CUDA events, and the batches whose decode
ended outside the traced slice left out."""

from __future__ import annotations

import itertools
from collections import deque

import pytest

from benchmark.core import spec as specs
from benchmark.core.window import Window
from piper_tpu_torch.utils import profiling

READERS = ("read_gap_share.offline", "batch_gap_share.offline", "frame_fill.offline")
_ids = itertools.count(1)


class Ev:
    """A CUDA event stand-in at `ms` on the card's clock."""

    def __init__(self, ms: float):
        self.ms = ms

    def elapsed_time(self, other: "Ev") -> float:
        return other.ms - self.ms


def _rec(name, batch, t0, t1, events=None, **attrs):
    ev = None if events is None else (Ev(events[0]), Ev(events[1]))
    return profiling.Record(name, id=next(_ids), parent=None, batch=batch,
                            thread="worker", t0=t0, t1=t1, attrs=attrs, events=ev)


def _timeline():
    """Three batches: encode (device ms), read gap, decode and copy, then
    the next batch's encode after a batch gap. Batch k's runtime.decode
    ends at host second k + 0.5."""
    recs = []
    for k, (enc, dec, rows, padded, f_bucket, frames) in enumerate([
            ((0.0, 10.0), (12.0, 50.0), 2, 2, 64, 50),     # read gap 2
            ((51.0, 60.0), (63.0, 100.0), 3, 1, 128, 300),  # batch gap 1, read gap 3
            ((100.5, 110.0), (114.0, 150.0), 4, 0, 192, 600),  # batch gap 0.5, read gap 4
    ], start=1):
        recs += [_rec("pipeline.wait", None, k - 0.2, k - 0.1),
                 _rec("runtime.encode", k, k + 0.0, k + 0.1, enc),
                 _rec("runtime.read", k, k + 0.1, k + 0.3),
                 _rec("runtime.decode", k, k + 0.3, k + 0.5, dec, rows=rows,
                      padded_rows=padded, f_bucket=f_bucket, frames=frames)]
    return recs


def _ctx(interval, window_s=10.0):
    w = Window()
    if interval is not None:
        w.info["trace_interval"] = list(interval)
    return specs.Context(config={}, mix={}, window=w,
                         trace={"window_s": window_s, "busy_s": 9.0})


@pytest.fixture
def ring(monkeypatch):
    r = deque(maxlen=profiling.RING_SIZE)
    monkeypatch.setattr(profiling, "RING", r)
    return r


@pytest.mark.parametrize("name", READERS)
def test_each_reader_finds_nothing_on_an_empty_timeline(ring, name):
    assert specs.reader(name).read(_ctx((0.0, 10.0))) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_finds_nothing_in_a_program_without_a_timeline(monkeypatch, name):
    monkeypatch.delattr(profiling, "RING")
    assert specs.reader(name).read(_ctx((0.0, 10.0))) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_finds_nothing_without_a_traced_slice(ring, name):
    ring.extend(_timeline())
    assert specs.reader(name).read(_ctx(None)) is None


@pytest.mark.parametrize("name,whole,slice_", [
    # (2 + 3 + 4) ms; batches 2 and 3: (3 + 4) ms; over 10 s
    ("read_gap_share.offline", 100 * 9e-3 / 10, 100 * 7e-3 / 10),
    # batch 1 has no batch before it; batches 2 and 3: (1 + 0.5) ms
    ("batch_gap_share.offline", 100 * 1.5e-3 / 10, 100 * 1.5e-3 / 10),
    # live frames over (rows + padded rows) x f_bucket
    ("frame_fill.offline", 100 * 950 / (4 * 64 + 4 * 128 + 4 * 192),
     100 * 900 / (4 * 128 + 4 * 192)),
])
def test_each_reader_gives_the_value_worked_out_by_hand(ring, name, whole, slice_):
    ring.extend(_timeline())
    reader = specs.reader(name)
    assert reader.read(_ctx((0.0, 3.6))) == pytest.approx(whole, rel=1e-12)
    # batch 1's decode ended at 1.5 s, outside (1.6, 3.6]: left out
    assert reader.read(_ctx((1.6, 3.6))) == pytest.approx(slice_, rel=1e-12)
    # no decode ended inside the slice
    assert reader.read(_ctx((3.6, 9.0))) is None
