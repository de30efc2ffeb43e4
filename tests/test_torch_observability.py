"""The port's profiler, test-vector recorder and replay (utils/profiling.py,
testing.py, the CLI's --record-vectors/--verify-summary/--list-voices), on
the CPU.

- The Profiler and record/replay cases of tests/test_observability.py under
  their own names (test_debug_intermediates is held with the per-layer
  trace, tests/test_torch_debug_trace.py).
- The runtime's profiler rows where the JAX runtime records them: "fused",
  "encode"/"decode", "durations", "forced", and a split batch dispatch's
  "encode" and its fetch's "decode"; PIPER_TPU_PROFILE=1 dumps the table at
  exit.
- The cross-package replay: a vector recorded by piper_tpu.testing replays
  through the port's --verify-summary within 1e-4 with equal lengths, and
  one recorded by the port replays through the JAX package's.

Torch runs one intra-op thread in this module.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from piper_tpu_torch import cli
from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice
from piper_tpu_torch.testing import record_test_vector, replay_test_vector, write_test_summary
from piper_tpu_torch.utils.profiling import Profiler

ROOT = Path(__file__).resolve().parent.parent
REPLAY_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    return make_synthetic_voice(tmp_path_factory.mktemp("obs_voice"), quality="test", seed=5)


@pytest.fixture(scope="module")
def runtime(voice):
    return PiperRuntime(*voice, device="cpu")


def test_profiler_accumulates(runtime):
    runtime.synthesize(FIXTURE_IDS)
    runtime.synthesize(FIXTURE_IDS)
    rows = runtime.profiler.rows()
    stages = {s for s, _, _ in rows}
    assert {"encode", "decode"} <= stages
    bucket = runtime.last_run_timings.phoneme_bucket
    enc = next(st for s, b, st in rows if s == "encode" and b == bucket)
    assert enc.count >= 2
    summary = runtime.profiler.summary()
    assert "encode" in summary and "mean_ms" in summary


def test_profiler_standalone():
    p = Profiler()
    p.record("encode", 16, 5.0, compiled=True)
    p.record("encode", 16, 3.0)
    (stage, bucket, st), = p.rows()
    assert stage == "encode" and bucket == 16
    assert st.count == 2 and st.mean_ms == 4.0 and st.max_ms == 5.0 and st.compiles == 1


def test_profiler_records_every_stage_the_reference_records(voice):
    """A fresh fused-mode runtime: one fused utterance, a split batch, a
    split dispatch and its fetch, a fused group, durations and a forced
    plan each add their row (stage, bucket) with the first run compiled."""
    rt = PiperRuntime(*voice, RuntimeOptions(mode="fused"), device="cpu")
    counts = {}

    def grew(stage):
        now = sum(st.count for s, _, st in rt.profiler.rows() if s == stage)
        before, counts[stage] = counts.get(stage, 0), now
        return now - before

    rt.synthesize(FIXTURE_IDS)
    assert grew("fused") == 1
    rt.synthesize_batch([FIXTURE_IDS, FIXTURE_IDS[:6]])
    assert (grew("encode"), grew("decode")) == (1, 1)
    outs, meta = rt.dispatch_batch([FIXTURE_IDS] * 2)
    assert (grew("encode"), grew("decode")) == (1, 0)
    rt.fetch_batch(outs, meta)
    assert grew("decode") == 1
    outs, meta = rt.dispatch_batch([FIXTURE_IDS] * 2, fused=True)
    rt.fetch_batch(outs, meta)
    assert grew("fused") == 1
    plan = rt.phoneme_durations([FIXTURE_IDS])[0]
    assert grew("durations") == 1
    rt.synthesize_forced(FIXTURE_IDS, plan)
    assert grew("forced") == 1
    assert {(s, b) for s, b, _ in rt.profiler.rows()} >= {("durations", 16), ("encode", 16)}
    assert all(st.compiles >= 1 for _, _, st in rt.profiler.rows())


def test_profile_flag_dumps_the_table_at_exit(voice):
    code = ("from piper_tpu_torch.engine.runtime import PiperRuntime\n"
            "from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as ids\n"
            f"rt = PiperRuntime({str(voice[0])!r}, device='cpu')\n"
            "rt.synthesize(ids)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), PIPER_TPU_PROFILE="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[piper-tpu profile]" in out.stderr and "mean_ms" in out.stderr


def test_record_and_replay_roundtrip(runtime, tmp_path):
    vec = record_test_vector(runtime, FIXTURE_IDS, tmp_path, "t0", seed=3)
    path = write_test_summary(runtime, [vec], tmp_path / "test_summary.json")
    d = json.loads(path.read_text())
    tv = d["results"][0]
    for key in ("test_id", "phoneme_ids", "metadata", "audio_files", "audio_stats",
                "random_files", "description"):
        assert key in tv, key
    assert tv["random_files"]["dp_shape"] == [1, 2, len(FIXTURE_IDS)]
    r = replay_test_vector(runtime, path)
    assert r["length_match"]
    assert r["max_abs_err"] == 0.0


def test_cli_verify_summary(runtime, tmp_path, capsys):
    vec = record_test_vector(runtime, FIXTURE_IDS, tmp_path, "t1", seed=4)
    write_test_summary(runtime, [vec], tmp_path / "test_summary.json")
    cli.main(["--verify-summary", str(tmp_path / "test_summary.json"), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["passed"] is True
    assert out["max_abs_err_worst"] <= 1e-3


def test_cli_list_voices(capsys):
    cli.main(["--list-voices"])
    out = capsys.readouterr().out
    assert "en_GB-northern_english_male-medium" in out
    assert "149 voices" in out


def test_a_reference_vector_replays_through_the_port(voice, tmp_path, capsys):
    """piper_tpu.testing records (its noise injected); the port's
    --verify-summary replays it within 1e-4, lengths equal."""
    from piper_tpu.engine.runtime import PiperRuntime as JRuntime
    from piper_tpu.testing import record_test_vector as j_record
    from piper_tpu.testing import write_test_summary as j_write

    jrt = JRuntime(*voice)
    vecs = [j_record(jrt, ids, tmp_path, f"j{i}", seed=7 + i)
            for i, ids in enumerate((FIXTURE_IDS, FIXTURE_IDS * 3))]
    path = j_write(jrt, vecs, tmp_path / "test_summary.json")
    cli.main(["--verify-summary", str(path), "--device", "cpu", "--tolerance",
              str(REPLAY_ATOL)])
    out = json.loads(capsys.readouterr().out)
    assert out["passed"] is True and out["max_abs_err_worst"] <= REPLAY_ATOL
    assert [r["length_match"] for r in out["results"]] == [True, True]


def test_a_port_vector_replays_through_the_reference(voice, tmp_path, capsys):
    """The port records; the JAX package's CLI replays it within 1e-4,
    lengths equal."""
    from piper_tpu import cli as j_cli

    rt = PiperRuntime(*voice, device="cpu")
    vecs = [record_test_vector(rt, ids, tmp_path, f"p{i}", seed=11 + i)
            for i, ids in enumerate((FIXTURE_IDS, FIXTURE_IDS * 3))]
    path = write_test_summary(rt, vecs, tmp_path / "test_summary.json")
    j_cli.main(["--verify-summary", str(path), "--tolerance", str(REPLAY_ATOL)])
    out = json.loads(capsys.readouterr().out)
    assert out["passed"] is True and out["max_abs_err_worst"] <= REPLAY_ATOL
    assert [r["length_match"] for r in out["results"]] == [True, True]
