"""A run with its timed path broken underneath comes out not correct.

Each test drives a whole run on the CPU (the harness's look for a card
skipped, the tiny voice, the small mixes) with the program's fetch patched
to plant one fault the cell can have: an answer altered where it is
produced, half of a batch's rows replaced by the other half's, a row cut
short, answers delivered to the wrong requests. A sound run comes out
correct."""

from __future__ import annotations

import json

import pytest

from benchmark import run
from benchmark.tests.conftest import MIXES


def _altered(rows):
    out = []
    for a in rows:
        a = a.copy()
        a[len(a) // 2] = 30000 if a[len(a) // 2] < 0 else -30000
        out.append(a)
    return out


def _half_left_out(rows):
    h = (len(rows) + 1) // 2
    return rows[:h] + [rows[i % h].copy() for i in range(len(rows) - h)]


def _cut_short(rows):
    return [a[:-256] if len(a) > 256 else a for a in rows]


def _swapped(rows):
    return rows[::-1] if len(rows) > 1 and len(rows[0]) != len(rows[-1]) else _altered(rows)


FAULTS = {"altered": _altered, "half_left_out": _half_left_out, "cut_short": _cut_short,
          "swapped": _swapped}
CASES = [("offline", "altered"), ("offline", "half_left_out"), ("offline", "cut_short"),
         ("offline", "swapped"), ("served", "altered"), ("served", "cut_short"),
         ("served", "swapped")]


def _run(spec, cell, log=lambda _: None):
    return run.run_cell(spec, cell, 2 ** 32 + 9, 1.5, False, "cpu", log=log)


@pytest.mark.parametrize("kind", ["offline", "served"])
def test_a_sound_run_is_correct(tiny_cells, kind):
    spec, cells = tiny_cells
    lines = []
    res = _run(spec, cells[kind], log=lines.append)
    assert res["correct"], res["checks"]
    assert res["checks"]["frames_off"]["value"] == 0
    assert res["device"]["platform"] == "cpu"
    # set-up runs to the window's opening: a served mix's lead-in is in it
    setup = [json.loads(x) for x in lines if '"setup_s"' in x][-1]
    assert res["metrics"]["setup_s"]["value"] == setup["setup_s"]
    lead = MIXES[kind].get("lead_in_s", 0.0)
    assert setup["setup"]["window_start"] >= lead
    assert setup["setup_s"] >= sum(setup["setup"].values()) - 1e-3


@pytest.mark.parametrize("kind,fault", CASES)
def test_a_broken_timed_path_is_not_correct(tiny_cells, monkeypatch, kind, fault):
    from piper_tpu_torch.engine.runtime import PiperRuntime

    spec, cells = tiny_cells
    real = PiperRuntime.fetch_batch

    def broken(self, outs, meta):
        return FAULTS[fault](real(self, outs, meta))

    monkeypatch.setattr(PiperRuntime, "fetch_batch", broken)
    res = _run(spec, cells[kind])
    assert not res["correct"], (fault, res["checks"])
