"""The port's bench (mirrors tests/test_bench_driver.py): one JSON
line with the root bench's keys, its headline the best serving row, on the
CPU with the tiny test preset; the rows whose parts are not ported raise
when asked for."""

import json

import pytest
import torch

from piper_tpu_torch import bench

KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_ms_factor1", "ms_mean_factor1",
        "rtf_single_stream_factor1", "platform", "device", "precision", "output_dtype", "mode",
        "quality", "compile_count", "vocoder_precision", "flow_precision", "throughput",
        "throughput_pipelined", "batch_sweep", "pipeline", "streaming", "streaming_server",
        "multispeaker", "high", "roofline", "rows", "golden"}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread per process: each pipeline thread that drives
    torch gets its own OpenMP team, and under a parallel test run those
    teams oversubscribe the cores (tens of seconds for a one-second test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_quick_schema(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("PIPER_TPU_CACHE", str(tmp_path))
    result = bench.main(["--quick", "--device", "cpu", "--quality", "test", "--batch", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    payload = json.loads(out[-1])
    assert payload == json.loads(json.dumps(result))
    assert set(payload) == KEYS

    assert payload["metric"] == "rtf_per_chip"
    assert isinstance(payload["value"], (int, float)) and payload["value"] >= 0
    assert payload["unit"] == "x_realtime"
    assert isinstance(payload["vs_baseline"], (int, float))
    assert payload["platform"] == "cpu" and payload["device"]["name"] == "cpu"
    assert (payload["mode"], payload["output_dtype"]) == ("fused", "int16")
    assert (payload["vocoder_precision"], payload["flow_precision"]) == ("high", "high")
    for row in ("multispeaker", "streaming", "streaming_server", "roofline", "high", "golden"):
        assert payload[row] is None, row  # --quick skips high; the test voice has no golden

    assert [r["factor"] for r in payload["rows"]] == [1, 2]  # --quick trims the sweep
    for r in payload["rows"]:
        assert r["ms_mean"] > 0 and r["rtf_mean"] > 0
        assert r["kernels"] is None and r["device_busy_ms"] is None  # not measured on the CPU
    tp, tpp = payload["throughput"], payload["throughput_pipelined"]
    assert tp["batch"] == tpp["batch"] == 2 and tpp["n_batches"] == 4
    # Rates are rounded as the root bench rounds them; on a loaded CPU they
    # may round to 0, so the test reads what they are made of.
    for r in (tp, tpp):
        assert r["audio_s_total"] > 0 and r["wall_s"] > 0
    assert tp["max_memory_allocated"] is None
    assert payload["pipeline"]["requests"] == 32 and payload["pipeline"]["ms_per_utt"] > 0
    # headline = the best measured serving row
    assert payload["value"] == round(max(tp["rtf_throughput"], tpp["rtf_throughput"]), 2)


def test_bench_flags_match_the_root_bench():
    """Every flag of the port bench is the root bench's, but --device for
    --platform; the defaults agree but those of the unported rows (off)."""
    import bench as root_bench

    ours = {a.dest: a.default for a in bench._parser()._actions if a.dest != "help"}
    src = open(root_bench.__file__).read()
    for dest in ours:
        if dest != "device":
            assert f"--{dest.replace('_', '-')}" in src, dest
    assert ours["mode"] == "fused" and ours["batch"] == 32 and ours["precision"] == "highest"
    assert (ours["multi_speaker"], ours["streams"], ours["roofline"]) == (0, 0, False)


@pytest.mark.parametrize("flags,match", [
    (["--multi-speaker", "8"], "ROADMAP §1 item 5"),
    (["--streams", "2"], "ROADMAP §1 item 8"),
    (["--roofline"], "roofline"),
])
def test_unported_rows_raise(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        bench.main(["--device", "cpu", *flags])
