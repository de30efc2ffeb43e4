"""The port's bench (mirrors tests/test_bench_driver.py): one JSON
line with the root bench's keys, its headline the best serving row, on the
CPU with the tiny test preset (its multispeaker row on an 8-speaker test
voice, its streaming rows on the test voice); --roofline embeds the
per-stage report."""

import ast
import json
from pathlib import Path

import numpy as np
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
    for row in ("streaming", "streaming_server", "roofline", "high", "golden"):
        assert payload[row] is None, row  # --quick skips high; the test voice has no golden
    ms = payload["multispeaker"]  # --quick clamps the bench's 904 speakers to 8
    assert (ms["n_speakers"], ms["batch"]) == (8, 2) and ms["rtf_throughput"] >= 0
    assert ms["device_busy_ms"] is None and ms["max_memory_allocated"] is None

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
    --platform; the defaults agree (--roofline off, as the root bench's):
    --multi-speaker is the root bench's 904, --streams its 8."""
    import bench as root_bench

    ours = {a.dest: a.default for a in bench._parser()._actions if a.dest != "help"}
    src = open(root_bench.__file__).read()
    for dest in ours:
        if dest != "device":
            assert f"--{dest.replace('_', '-')}" in src, dest
    assert ours["mode"] == "fused" and ours["batch"] == 32 and ours["precision"] == "highest"
    assert (ours["multi_speaker"], ours["streams"], ours["roofline"]) == (904, 8, False)
    assert 'parser.add_argument("--multi-speaker", type=int, default=904' in src
    assert 'parser.add_argument("--streams", type=int, default=8' in src


def test_multispeaker_row_serves_speaker_ids(monkeypatch, tmp_path):
    """The row's parts on a 3-speaker test voice: get_runtime writes and
    loads the N-speaker voice (gin 512), and the pipelined throughput with
    speaker ids 0, 1, 2, 0 serves each row in its own speaker's voice: the
    audio of synthesize_batch with those ids and the same seed."""
    monkeypatch.setenv("PIPER_TPU_CACHE", str(tmp_path))
    args = bench._parser().parse_args(["--device", "cpu", "--quality", "test"])
    rt = bench.get_runtime(args, n_speakers=3, gin=512)
    assert (rt.hparams.n_speakers, rt.hparams.gin_channels) == (3, 512)
    assert rt.model_path.name == "synthetic-test-ms3.onnx"
    sids = [0, 1, 2, 0]
    served = []
    real = rt.fetch_batch
    monkeypatch.setattr(rt, "fetch_batch", lambda o, m: served.append(real(o, m)) or served[-1])
    row = bench.measure_throughput_pipelined(rt, 4, n_batches=1, sids=sids)
    assert row["batch"] == 4 and row["audio_s_total"] > 0
    want = rt.synthesize_batch([(bench.FIXTURE_IDS * 8)[:4096]] * 4, speaker_ids=sids, seed=0)
    for got, w in zip(served[-1], want):
        np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(served[-1][3], served[-1][0])
    assert not np.array_equal(served[-1][1], served[-1][0])


@pytest.mark.parametrize("flags,match", [
    (["--roofline"], "roofline"),
])
def test_unported_rows_raise(flags, match, monkeypatch, tmp_path, capsys):
    """No row of the root bench is left unported: --roofline embeds the report at B = --batch, P=128,
    T=768 (the root bench's shapes; the ceilings at a tiny size so the CPU
    run stays short), without the level rows under --quick."""
    from piper_tpu_torch.utils import roofline as rl

    assert not hasattr(bench, "UNPORTED")
    monkeypatch.setenv("PIPER_TPU_CACHE", str(tmp_path))
    real = rl.measure_ceilings
    monkeypatch.setattr(rl, "measure_ceilings",
                        lambda iters=8, n=4096, device="cuda", stream_mb=256:
                        real(iters=1, n=64, device=device, stream_mb=4))
    result = bench.main(["--device", "cpu", "--quick", "--quality", "test", "--batch", "1",
                         "--multi-speaker", "0", "--no-pipeline", *flags])
    row = result[match]
    assert (row["batch"], row["phoneme_bucket"], row["frame_bucket"]) == (1, 128, 768)
    assert [s["stage"] for s in row["stages"]] == ["encode(enc+dp)", "flow", "vocoder"]
    assert all(s["ms"] > 0 for s in row["stages"]) and row["device"] is None
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[match] == json.loads(
        json.dumps(row))


def _root_row_keys(name: str) -> set:
    """The keys of the root bench's row `name` (its largest dict literal
    assigned to that name), read from its source."""
    src = (Path(__file__).resolve().parent.parent / "bench.py").read_text()
    rows = [{k.value for k in node.value.keys} for node in ast.walk(ast.parse(src))
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
            and any(getattr(t, "id", None) == name for t in node.targets)]
    if not rows:
        raise AssertionError(f"the root bench has no {name} dict")
    return max(rows, key=len)


def _root_streaming_keys() -> set:
    """The keys of the root bench's streaming row, read from its source."""
    return _root_row_keys("streaming_row")


def test_streaming_row(capsys, monkeypatch, tmp_path):
    """Without --quick the bench measures incremental streaming on its
    runtime (here the test voice on the CPU, every other row off): the
    root bench's keys, the 224-id utterance, first audio before the last,
    and the profile keys null off the card."""
    monkeypatch.setenv("PIPER_TPU_CACHE", str(tmp_path))
    result = bench.main(["--device", "cpu", "--quality", "test", "--factors", "1",
                         "--warmup", "0", "--iters", "1", "--batch", "0", "--no-pipeline",
                         "--multi-speaker", "0", "--no-high"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["streaming"] == \
        json.loads(json.dumps(result["streaming"]))
    row = result["streaming"]
    root = _root_streaming_keys()
    assert root == {"phonemes", "utterance_s", "ttfb_ms_p50", "total_ms_p50"}
    assert set(row) == root | {"kernels", "device_busy_ms", "busy_share"}
    assert row["phonemes"] == 224 and row["utterance_s"] > 0
    assert 0 < row["ttfb_ms_p50"] <= row["total_ms_p50"]
    assert row["kernels"] is None and row["device_busy_ms"] is None


def test_streaming_server_row(capsys, monkeypatch, tmp_path):
    """`--streams 2` on the CPU: the streaming_server row carries the root
    bench's keys, and each stream of the last timed round (client i at
    seed 100 + i) is as long as the same stream run alone on the bench's
    runtime; the profile keys are null off the card."""
    monkeypatch.setenv("PIPER_TPU_CACHE", str(tmp_path))
    argv = ["--device", "cpu", "--quality", "test", "--factors", "1", "--warmup", "0",
            "--iters", "1", "--batch", "0", "--no-pipeline", "--multi-speaker", "0",
            "--no-high", "--streams", "2"]
    result = bench.main(argv)
    row = result["streaming_server"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["streaming_server"] == \
        json.loads(json.dumps(row))
    root = _root_row_keys("streaming_server_row")
    assert root == {"streams", "aggregate_rtf", "ttfb_ms_p50", "ttfb_ms_p95", "total_ms_p50"}
    assert set(row) == root | {"phonemes", "window_rows_per_dispatch", "samples", "kernels",
                               "device_busy_ms", "busy_share"}
    assert row["streams"] == 2 and row["phonemes"] == 224 and row["aggregate_rtf"] > 0
    assert 0 < row["ttfb_ms_p50"] <= row["ttfb_ms_p95"] and row["ttfb_ms_p50"] < row["total_ms_p50"]
    assert row["window_rows_per_dispatch"] >= 1 and row["kernels"] is None
    rt = bench.get_runtime(bench._parser().parse_args(argv))
    ids_long = (bench.FIXTURE_IDS * 16)[:4096]
    solo = [sum(len(c.samples) for c in rt.synthesize_stream_incremental(ids_long, seed=100 + i))
            for i in range(2)]
    assert row["samples"] == solo
