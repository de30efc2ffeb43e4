"""The port's operator tools on the CPU: bench_sessions, cold_start,
padding_tax and streaming_bench, each at its smallest settings on the tiny
`test` voice, print one JSON line with the JAX tool's keys (the port's
extra keys beside them). Their numbers come from the card
(`python -m piper_tpu_torch.tools.<name>`, chip_smoke.py's `tools` phase);
here only the protocol runs."""

import json
import sys

import pytest

from piper_tpu_torch.tools import bench_sessions, cold_start, padding_tax, streaming_bench


def _line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_bench_sessions_medians_fresh_processes(capsys):
    """Two sessions of a stand-in bench command (no bench is spawned): the
    forwarded arguments reach it, and the medians and spread are taken
    over the sessions' lines."""
    fake = [sys.executable, "-c",
            "import json, sys; v = float(sys.argv[-1]); "
            "print(json.dumps({'value': v, 'ms_mean_factor1': 2 * v, 'device': {'name': 'x'}}))"]
    assert bench_sessions.main(["--sessions", "2", "--", "4.5"], bench_cmd=fake) == 0
    out = _line(capsys)
    assert set(out) == {"metric", "value", "unit", "sessions", "spread", "median", "all"}
    assert (out["metric"], out["value"], out["sessions"]) == ("rtf_per_chip_median", 4.5, 2)
    assert out["spread"] == [4.5, 4.5] and out["median"]["ms_mean_factor1"] == 9.0
    assert bench_sessions.main(["--sessions", "1"], bench_cmd=[sys.executable, "-c", "1"]) == 1
    assert _line(capsys) == {"sessions": 0, "error": "no successful sessions"}


def test_cold_start_rows(capsys, tmp_path):
    """Both child rows on the CPU: the built-kernels child and the
    cold-build child, which runs from a copy of the package whose build
    directory is its own."""
    cold_start.main(["--device", "cpu", "--quality", "test", "--cold-build"])
    out = _line(capsys)
    for key in ("metric", "quality", "platform", "config", "cold_process_warm_cache",
                "cold_process_cold_cache", "warm_process_call_ms"):
        assert key in out, key
    for row in (out["cold_process_warm_cache"], out["cold_process_cold_cache"]):
        assert set(row) >= {"import_s", "runtime_load_s", "first_audio_s", "warm_call_ms",
                            "start_to_first_audio_s", "samples", "subprocess_wall_s"}
        assert row["samples"] > 0
    copy = cold_start.package_copy(tmp_path)
    assert (copy / "piper_tpu_torch" / "csrc" / "resblock1.cu").exists()
    assert not list(copy.rglob("__pycache__"))


def test_padding_tax_rows_and_expected_waste(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("PIPER_TPU_CACHE", str(tmp_path))
    padding_tax.main(["--device", "cpu", "--quality", "test", "--iters", "1",
                      "--sizes", "1,2,3,4"])
    out = _line(capsys)
    for key in ("metric", "quality", "phonemes_per_utt", "ladder", "rows", "waste"):
        assert key in out, key
    assert [(r["rows"], r["padded_to"]) for r in out["rows"]] == [(1, 1), (2, 2), (3, 4), (4, 4)]
    assert [w["rows"] for w in out["waste"]] == [3]
    assert 0.9 < out["expected"]["coverage"] <= 1.0


def test_group_size_model():
    pmf = padding_tax.group_size_pmf(100.0, 10.0, 32)
    assert sum(pmf.values()) == pytest.approx(1.0)
    assert sum(b * p for b, p in pmf.items()) == pytest.approx(2.0)
    assert padding_tax.ideal_ms(3, {2: 10.0, 4: 20.0}) == 15.0
    assert padding_tax.ideal_ms(5, {2: 10.0, 4: 20.0}) is None


def test_streaming_bench_ab_heads(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("PIPER_TPU_CACHE", str(tmp_path))
    streaming_bench.main(["--device", "cpu", "--quality", "test", "--quick", "--ab-heads"])
    out = _line(capsys)
    assert set(out) >= {"metric", "value", "unit", "ab"}
    batched, solo = out["ab"]
    assert (batched["config"], solo["config"]) == ("batched_heads", "solo_heads")
    for run in (batched, solo):
        for key in ("streams", "phonemes", "emit_frames", "prewarm_s", "ttfb_ms_p50",
                    "ttfb_ms_p95", "window_rows", "window_dispatches", "head_dispatches",
                    "head_rows", "padded_head_rows", "rows"):
            assert key in run, key
        assert len(run["rows"]) == 1 and run["rows"][0]["streams"] == 2
