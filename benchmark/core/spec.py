"""Finding a cell's parts by name: BENCHMARK.json at the checkout's root,
and under benchmark/ one file per configuration, traffic mix, loop kind,
set of limits and per-layer metric reader. A later change adds a cell, a
mix, a loop kind or a metric by adding files; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


def load(path: Optional[Path] = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    for c in spec["workloads"]:
        if c["name"] == name:
            return c
    raise SystemExit(f"benchmark: no cell {name!r} in BENCHMARK.json "
                     f"(cells: {[c['name'] for c in spec['workloads']]})")


def _json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def mix(name: str) -> dict:
    return _json("traffic", name)


def limits(cell_name: str) -> dict:
    """The limit of each number the judge compares in this cell."""
    return _json("limits", cell_name)["limits"]


def cache_dir() -> Path:
    """Where runs keep what they make (the voice they load): a fixed path
    inside the checkout."""
    return ROOT / ".bench_cache"


def cell_metrics(spec: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of this cell reports: with trace the per-layer
    ones, else the end-to-end ones; a metric with `workloads` only in
    those cells."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if "workloads" not in m or cell_name in m["workloads"]]


def _module(kind: str, name: str):
    """benchmark/<kind>/<name>.py, loaded by path (names hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"benchmark: no {kind} file {path.relative_to(ROOT)}")
    mod_name = f"benchmark_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The per-layer metric's reader, benchmark/metrics/<metric>.py."""
    return _module("metrics", metric)


def loop(kind: str):
    """The loop kind a mix names (its `loop`), benchmark/loops/<kind>.py:
    how a window drives the program's entry point, what it records, and how
    the judge is to read its rows. It holds

    - `Loop(rt, mix, seed)`, with `prepare()` (build the serving object and
      warm the shapes the traffic uses: set-up) and `window(seconds,
      tracer)` (measure, wait for what was due, close; a Window whose
      t_open ends the set-up);
    - `planned_rows(mix, seed, seconds, batches)`: the rows a run of this
      seed is judged on, without their answers (the control's input);
    - `judged(ref, rows, runtime_seed)`: what the judge needs beside the
      rows that the reference works out again (a served row's budget);
    - `sample(rows, mix, seed)`: the rows held to audio_gap."""
    return _module("loops", kind)


@dataclass
class Context:
    """What a per-layer reader reads: the cell's configuration and mix, the
    window (rows, live phonemes and frames by group, counters) and the
    trace's reading (None where the run was not traced)."""

    config: dict
    mix: dict
    window: object
    trace: Optional[dict]
