"""BENCHMARK.json and the files it names: every cell's parts are found by
name, and the file keeps to the contract's shape."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.core import spec as specs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_cell_finds_its_config_mix_limits_and_readers():
    spec = specs.load()
    for cell in spec["workloads"]:
        config = specs.config(cell["config"])
        assert config["name"] == cell["config"]
        kind = specs.loop(specs.mix(cell["traffic"])["loop"])
        for hook in ("planned_rows", "judged", "sample"):
            assert callable(getattr(kind, hook)), hook
        assert callable(kind.Loop.prepare) and callable(kind.Loop.window)
        assert set(specs.limits(cell["name"])) == {"frames_off", "audio_gap"}
        for m in specs.cell_metrics(spec, cell["name"], trace=True):
            r = specs.reader(m["name"])
            assert (r.SOURCE, r.LAYER, r.MOVES, r.UNIT) == (
                m["source"], m["layer"], m["moves"], m["unit"]), m["name"]
            assert callable(r.read)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    spec = specs.load()
    for cell in spec["workloads"]:
        e2e = [m["name"] for m in specs.cell_metrics(spec, cell["name"], trace=False)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell["name"]
        per = specs.cell_metrics(spec, cell["name"], trace=True)
        assert per, cell["name"]
        for m in per:
            assert m["moves"] in e2e, (cell["name"], m["name"])


def test_benchmark_json_shape():
    spec = specs.load()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    assert len(set(names)) == len(names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert c["reduced"] == json.loads(open(specs.ROOT / c["file"]).read())["reduced"]
    cells = spec["workloads"]
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    for c in cells:
        assert set(c) == {"name", "config", "traffic", "chips", "why"} and c["chips"] == 1
        assert c["config"] in names and len(c["why"]) <= 200
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    layers = {m["layer"] for m in spec["per_layer"]}
    assert all("\n" not in x for x in layers)
    for m in spec["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", ["no.such.cell"])
def test_an_unknown_cell_is_refused(name):
    with pytest.raises(SystemExit):
        specs.cell(specs.load(), name)


@pytest.mark.parametrize("kind,name", [("loops", "no_such_loop"), ("metrics", "no.such.metric")])
def test_an_unknown_loop_or_reader_is_refused(kind, name):
    with pytest.raises(SystemExit):
        specs._module(kind, name)
