"""The port's command line (piper_tpu_torch.cli) on the CPU, every mode.

- The cases of tests/test_cli.py under their own names (the scale bench at
  factors 1 and 2 runs here: the port compiles nothing).
- The CLI cases of tests/test_text.py, test_phonemize.py (the REPL),
  test_ssml.py, test_speaker_names.py, test_multispeaker_paths.py and
  test_review_fixes.py, under their names.
- Both packages' one-shot --phoneme-ids on one synthetic voice at zero
  noise: the WAVs within 1e-4 + 1/32767 (one int16 step), the --alignment
  JSON equal; --text without espeak-ng raises the same error in both; the
  parser has every flag of the JAX CLI with its default, and --device.
- The port's own modes: --microbench on the CPU (no CUDA graph: null time
  with its reason), --force-durations, --profile-trace, a standalone
  --prewarm, --record-vectors then --verify-summary.

Every call passes --device cpu: the CLI asks for the card by default.
Torch runs one intra-op thread in this module.
"""

import json
import stat

import numpy as np
import pytest
import torch

from piper_tpu_torch import cli
from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
from piper_tpu_torch.engine.runtime import PiperRuntime
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice
from piper_tpu_torch.utils.wav import read_wav

FIXTURE_IDS = "1,20,0,120,0,61,0,24,0,59,0,100,0,2"
CPU = ["--device", "cpu"]
INT16_STEP = 1.0 / 32767


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(*argv):
    cli.main([*CPU, *map(str, argv)])


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_voice")
    model, config = make_synthetic_voice(d, quality="test", seed=0)
    summary = {
        "model_path": str(model),
        "config_path": str(config),
        "num_tests": 1,
        "results": [{
            "test_id": "fixture_short",
            "phoneme_ids": [int(x) for x in FIXTURE_IDS.split(",")],
            "metadata": {"sample_rate": 16000, "noise_scale": 0.667, "length_scale": 1.0,
                         "noise_w": 0.8},
        }],
    }
    summary_path = d / "test_summary.json"
    summary_path.write_text(json.dumps(summary))
    return model, config, summary_path


@pytest.fixture(scope="module")
def ms_voice(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_ms_voice")
    return make_synthetic_voice(d, quality="test", seed=6, n_speakers=4, gin_channels=32)


@pytest.fixture()
def fake_espeak(tmp_path, monkeypatch):
    """A stand-in espeak-ng (prints 'ab' for any input) patched into the
    port's find_espeak, so --text works without the real binary."""
    script = tmp_path / "espeak-ng"
    script.write_text("#!/bin/sh\necho 'ab'\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr("piper_tpu_torch.phonemize.find_espeak", lambda: str(script))
    return str(script)


# -- tests/test_cli.py -------------------------------------------------------------


def test_oneshot_phoneme_ids(voice, tmp_path, capsys):
    model, _, _ = voice
    out = tmp_path / "o.wav"
    run("--model", model, "--phoneme-ids", FIXTURE_IDS, "-o", out)
    assert "wrote" in capsys.readouterr().out
    audio, rate = read_wav(out)
    assert rate == 16000
    assert len(audio) > 0
    assert np.abs(audio).max() <= 1.0


def test_oneshot_ipa(voice, tmp_path, capsys):
    model, _, _ = voice
    out = tmp_path / "ipa.wav"
    run("--model", model, "--ipa", "ab", "-o", out)
    audio, _ = read_wav(out)
    assert len(audio) > 0


def test_bench_summary_schema(voice, capsys):
    _, _, summary_path = voice
    run("--bench-summary", summary_path, "--warmup", "1", "--iters", "2")
    out = json.loads(capsys.readouterr().out)
    for key in ("backend", "ms_mean", "ms_p50", "ms_p95", "ms_max", "sample_rate",
                "num_runs", "rtf_mean", "compile_count"):
        assert key in out, key
    assert out["backend"] == "piper-tpu" and out["mode"] == "torch-cpu-runtime"
    assert out["num_runs"] == 2
    assert out["ms_mean"] > 0


def test_scale_bench_schema(voice, capsys):
    _, _, summary_path = voice
    run("--scale-bench", "--bench-summary", summary_path, "--scale-factors", "1,2",
        "--warmup", "1", "--iters", "1")
    out = json.loads(capsys.readouterr().out)
    assert out["mode"] == "scale-bench"
    assert out["scale_factors"] == [1, 2]
    assert len(out["results"]) == 2
    row = out["results"][0]
    for key in ("factor", "phoneme_count", "ms_mean", "ms_p50", "ms_p95", "ms_max",
                "rtf_mean", "phoneme_bucket", "frame_bucket", "cpu_user_ms_mean",
                "cpu_sys_ms_mean", "max_rss_max"):
        assert key in row, key
    assert out["results"][1]["phoneme_count"] == 28


def test_microbench_schema(capsys):
    """The JAX CLI's keys; on the CPU the graph's time is null, with why."""
    run("--microbench")
    out = json.loads(capsys.readouterr().out)
    assert out["mode"] == "microbench"
    assert out["eager_chain_ms"] > 0
    assert (out["elements"], out["iters"], out["ops_per_chain"]) == (4096, 200, 16)
    assert out["jit_chain_ms"] is None and out["dispatch_overhead_ratio"] is None
    assert "CUDA graph" in out["jit_chain_note"]


def test_missing_args_errors(voice):
    with pytest.raises(SystemExit):
        run("--phoneme-ids", FIXTURE_IDS)  # no model/voice
    with pytest.raises(SystemExit):
        run("--scale-bench")  # no summary


def test_oneshot_alignment_json(voice, tmp_path, capsys):
    model, _, _ = voice
    out = tmp_path / "o.wav"
    aj = tmp_path / "align.json"
    run("--model", model, "--phoneme-ids", FIXTURE_IDS, "-o", out, "--alignment", aj)
    audio, sr = read_wav(str(out))
    doc = json.loads(aj.read_text())
    assert doc["sample_rate"] == sr
    (utt,) = doc["utterances"]
    ids = [int(x) for x in FIXTURE_IDS.split(",")]
    assert [p["id"] for p in utt["phonemes"]] == ids
    assert utt["phonemes"][-1]["end_sample"] == len(audio)
    assert utt["total_samples"] == len(audio)


def test_alignment_rejected_with_stream(voice, tmp_path):
    model, _, _ = voice
    with pytest.raises(SystemExit):
        run("--model", model, "--phoneme-ids", FIXTURE_IDS, "--stream", "-o",
            tmp_path / "o.wav", "--alignment", tmp_path / "a.json")


# -- the CLI cases of the other reference files -------------------------------------


def test_cli_multi_sentence_batch(voice, tmp_path, fake_espeak, capsys):
    model = voice[0]
    out = tmp_path / "multi.wav"
    run("--model", model, "--text", "First one. Second one!", "--sentence-silence", "0.25",
        "-o", out)
    msg = capsys.readouterr().out
    assert "2 sentences" in msg
    audio, sr = read_wav(str(out))
    assert len(audio) > int(0.25 * sr)
    out2 = tmp_path / "single.wav"
    run("--model", model, "--text", "First one. Second one!", "--no-sentence-split",
        "-o", out2)
    assert "sentences" not in capsys.readouterr().out


def test_cli_multi_sentence_stream(voice, tmp_path, fake_espeak, capsys):
    out = tmp_path / "multi_stream.wav"
    run("--model", voice[0], "--stream", "--text", "First one. Second one!",
        "--sentence-silence", "0.1", "-o", out)
    msg = capsys.readouterr().out
    assert "2 sentences" in msg and "streamed" in msg
    audio, sr = read_wav(str(out))
    assert len(audio) > int(0.1 * sr)
    assert np.isfinite(audio).all()


def test_cli_multi_sentence_speaker_id(tmp_path, fake_espeak, capsys):
    """--speaker-id reaches the batched sentence path as per-row speaker_ids."""
    model, _ = make_synthetic_voice(tmp_path / "ms", quality="test", seed=4, n_speakers=3,
                                    gin_channels=16)
    run("--model", model, "--text", "First one. Second one!", "--speaker-id", "2",
        "-o", tmp_path / "ms.wav")
    assert "2 sentences" in capsys.readouterr().out


def test_cli_negative_sentence_silence_is_usage_error(tmp_path, fake_espeak, voice):
    with pytest.raises(SystemExit):
        run("--model", voice[0], "--text", "A one. B two.", "--sentence-silence", "-0.1",
            "-o", tmp_path / "x.wav")


def test_repl_smoke(tmp_path, monkeypatch, capsys, fake_espeak, voice):
    lines = iter(["hello there", ":q"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    monkeypatch.chdir(tmp_path)
    run("--model", voice[0])
    assert "wrote" in capsys.readouterr().out
    audio, rate = read_wav(tmp_path / "repl_000.wav")
    assert rate == 16000
    assert len(audio) > 0 and np.isfinite(audio).all()


def test_cli_ssml(ms_voice, tmp_path):
    model, _ = ms_voice
    out = tmp_path / "ssml.wav"
    run("--model", model, "--ssml", '<speak><voice name="1"><phoneme ph="AB"/></voice>'
        '<break time="250ms"/><phoneme ph="BA"/></speak>', "-o", out)
    audio, sr = read_wav(out)
    assert len(audio) > int(0.25 * sr)
    doc = tmp_path / "doc.ssml"
    doc.write_text('<speak><phoneme ph="AB"/></speak>')
    out2 = tmp_path / "ssml2.wav"
    run("--model", model, "--ssml", doc, "-o", out2)
    assert read_wav(out2)[0].size > 0
    for argv in (["--ssml", "<speak>x</speak>", "--speaker-id", "1"],
                 ["--ssml", "<speak><broken"], ["--ssml", "no_such_doc.ssml"],
                 ["--ssml", '<speak><voice name="99"><phoneme ph="AB"/></voice></speak>']):
        with pytest.raises(SystemExit):
            run("--model", model, *argv, "-o", tmp_path / "x.wav")


def test_cli_speaker_by_name(ms_voice, tmp_path):
    model, _ = ms_voice
    out_name, out_id, out_mix = tmp_path / "name.wav", tmp_path / "id.wav", tmp_path / "mix.wav"
    run("--model", model, "--phoneme-ids", FIXTURE_IDS, "--speaker", "spk2", "-o", out_name)
    run("--model", model, "--phoneme-ids", FIXTURE_IDS, "--speaker-id", "2", "-o", out_id)
    assert np.array_equal(read_wav(out_name)[0], read_wav(out_id)[0])
    run("--model", model, "--phoneme-ids", FIXTURE_IDS, "--speaker-mix", "spk2:1.0",
        "-o", out_mix)
    assert np.array_equal(read_wav(out_mix)[0], read_wav(out_id)[0])
    with pytest.raises(SystemExit):
        run("--model", model, "--phoneme-ids", FIXTURE_IDS, "--speaker", "nobody",
            "-o", tmp_path / "x.wav")
    with pytest.raises(SystemExit):
        run("--model", model, "--phoneme-ids", FIXTURE_IDS, "--speaker", "spk1",
            "--speaker-id", "1", "-o", tmp_path / "y.wav")


def test_cli_empty_mix_is_an_error(ms_voice, tmp_path):
    with pytest.raises(SystemExit):
        run("--model", ms_voice[0], "--phoneme-ids", FIXTURE_IDS, "--speaker-mix", "",
            "-o", tmp_path / "e.wav")


def test_cli_speaker_id(ms_voice, tmp_path):
    model, _ = ms_voice
    out0, out2 = tmp_path / "s0.wav", tmp_path / "s2.wav"
    run("--model", model, "--phoneme-ids", FIXTURE_IDS, "--speaker-id", "0", "-o", out0)
    run("--model", model, "--phoneme-ids", FIXTURE_IDS, "--speaker-id", "2", "-o", out2)
    a0, a2 = read_wav(out0)[0], read_wav(out2)[0]
    assert len(a0) > 0 and len(a2) > 0
    if a0.shape == a2.shape:
        assert not np.allclose(a0, a2)


def test_cli_env_precision_flag(voice, tmp_path, monkeypatch):
    """PIPER_TPU_PRECISION reaches the runtime from the CLI."""
    monkeypatch.setenv("PIPER_TPU_PRECISION", "high")
    captured = {}
    orig_init = PiperRuntime.__init__

    def spy(self, *a, **k):
        orig_init(self, *a, **k)
        captured["precision"] = self.options.precision

    monkeypatch.setattr(PiperRuntime, "__init__", spy)
    run("--model", voice[0], "--phoneme-ids", "1,20,0,2", "-o", tmp_path / "o.wav")
    assert captured["precision"] == "high"


# -- against the JAX package's CLI --------------------------------------------------


def test_oneshot_matches_the_reference_cli(voice, tmp_path, capsys):
    """Both CLIs' one-shot --phoneme-ids at zero noise on one voice: the WAVs
    within 1e-4 + one int16 step, the --alignment JSON equal."""
    from piper_tpu import cli as j_cli

    model = voice[0]
    args = ["--model", str(model), "--phoneme-ids", FIXTURE_IDS,
            "--noise-scale", "0", "--noise-w", "0"]
    run(*args, "-o", tmp_path / "port.wav", "--alignment", tmp_path / "port.json")
    j_cli.main([*args, "-o", str(tmp_path / "jax.wav"), "--alignment",
                str(tmp_path / "jax.json")])
    ours, sr = read_wav(tmp_path / "port.wav")
    theirs, jsr = read_wav(tmp_path / "jax.wav")
    assert sr == jsr and len(ours) == len(theirs) > 0
    assert float(np.abs(ours - theirs).max()) <= 1e-4 + INT16_STEP
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())


def test_text_without_espeak_raises_the_reference_error(voice, monkeypatch, tmp_path):
    from piper_tpu import cli as j_cli
    from piper_tpu.phonemize import PhonemizerError as JPhonemizerError
    from piper_tpu_torch.phonemize import PhonemizerError

    monkeypatch.setattr("piper_tpu_torch.phonemize.find_espeak", lambda: None)
    monkeypatch.setattr("piper_tpu.phonemize.find_espeak", lambda: None)
    argv = ["--model", str(voice[0]), "--text", "Hi.", "-o", str(tmp_path / "x.wav")]
    with pytest.raises(PhonemizerError) as ours:
        run(*argv)
    with pytest.raises(JPhonemizerError) as theirs:
        j_cli.main(argv)
    assert str(ours.value) == str(theirs.value)


def test_parser_has_the_reference_flags_and_defaults():
    from piper_tpu import cli as j_cli

    def flags(parser):
        return {a.option_strings[0]: (a.dest, a.default, a.choices)
                for a in parser._actions if a.option_strings and a.dest != "help"}

    ours, theirs = flags(cli.build_parser()), flags(j_cli.build_parser())
    assert ours.pop("--device") == ("device", "cuda", ["cuda", "cpu"])
    assert ours == theirs


# -- the port's own modes ------------------------------------------------------------


def test_force_durations_and_alignment(voice, tmp_path, capsys):
    model = voice[0]
    plan = ",".join(["2"] * len(FIXTURE_PHONEME_IDS))
    out, aj = tmp_path / "f.wav", tmp_path / "f.json"
    run("--model", model, "--phoneme-ids", FIXTURE_IDS, "--force-durations", plan, "-o", out,
        "--alignment", aj)
    audio, _ = read_wav(out)
    rt = PiperRuntime(model, device="cpu")
    assert len(audio) == 2 * len(FIXTURE_PHONEME_IDS) * rt.hparams.hop_length
    doc = json.loads(aj.read_text())
    assert [p["frames"] for p in doc["utterances"][0]["phonemes"]] == [2] * len(
        FIXTURE_PHONEME_IDS)
    for bad in ("1,2", "x", ",".join(["0"] * len(FIXTURE_PHONEME_IDS))):
        with pytest.raises(SystemExit):
            run("--model", model, "--phoneme-ids", FIXTURE_IDS, "--force-durations", bad,
                "-o", tmp_path / "b.wav")


def test_record_and_verify_vectors(voice, tmp_path, capsys):
    model = voice[0]
    run("--model", model, "--phoneme-ids", FIXTURE_IDS, "--record-vectors", tmp_path,
        "--test-id", "v0")
    assert "recorded v0" in capsys.readouterr().out
    run("--verify-summary", tmp_path / "test_summary.json")
    out = json.loads(capsys.readouterr().out)
    assert out["passed"] is True and out["max_abs_err_worst"] == 0.0
    assert out["results"][0]["length_match"] is True


def test_profile_trace_and_standalone_prewarm(voice, tmp_path, capsys):
    run("--model", voice[0], "--phoneme-ids", "1,20,0,2", "-o", tmp_path / "o.wav",
        "--profile-trace", tmp_path / "trace")
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    capsys.readouterr()
    run("--model", voice[0], "--prewarm")
    assert capsys.readouterr().out.startswith("prewarmed ")


def test_the_card_is_the_default():
    """Without --device the runtime asks for the card (and raises where
    there is none: nothing falls back to the CPU)."""
    assert cli.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--microbench"])
