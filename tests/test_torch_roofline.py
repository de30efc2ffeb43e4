"""The port's layer split (piper_tpu_torch.utils.roofline, tools.roofline,
tools.level_probe) on the CPU.

- The cost model is the JAX package's: its functions' source unchanged,
  and the same FLOPs and bytes, stage by stage, for every preset at
  several (B, P, T).
- The four fast cases of tests/test_roofline.py on the port's copy.
- The measured report on the tiny voice at B=2, P=16, T=64: the JAX
  report's stage names and per-stage gflops/gb, every row measured, with
  the published H100 peaks as the mfu and hbm_frac denominators (the
  measured ceilings beside them).
- level_probe and tools.roofline run at --device cpu and print their JSON.
"""

import inspect
import json

import pytest
import torch

from piper_tpu.models.vits.hparams import PRESETS as J_PRESETS
from piper_tpu.utils import roofline as j_rl
from piper_tpu_torch.models.vits.hparams import PRESETS
from piper_tpu_torch.tools.timing import PEAK_BYTES_PER_S, PEAK_FLOPS, TIER_FLOPS
from piper_tpu_torch.utils import roofline as rl
from piper_tpu_torch.utils.roofline import (duration_predictor_cost, encoder_cost,
                                            flow_cost, pipeline_costs, total_cost,
                                            vocoder_level_costs)

COST_FUNCTIONS = ("_conv", "encoder_cost", "duration_predictor_cost", "flow_cost",
                  "vocoder_level_costs", "pipeline_costs", "total_cost")
SHAPES = ((1, 16, 64), (2, 128, 768), (32, 128, 192), (32, 128, 768), (3, 37, 250))
TINY_CEILINGS = dict(iters=2, n=128, stream_mb=8)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cost_model_source_is_the_reference():
    for name in COST_FUNCTIONS:
        assert inspect.getsource(getattr(rl, name)) == inspect.getsource(getattr(j_rl, name)), name
    assert {f.name for f in rl.StageCost.__dataclass_fields__.values()} >= {
        f.name for f in j_rl.StageCost.__dataclass_fields__.values()}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_cost_model_equals_the_reference(preset):
    hp, jhp = PRESETS[preset], J_PRESETS[preset]
    for b, p, t in SHAPES:
        got, want = pipeline_costs(hp, b, p, t), j_rl.pipeline_costs(jhp, b, p, t)
        assert [(s.stage, s.flops, s.bytes) for s in got] == [
            (s.stage, s.flops, s.bytes) for s in want], (preset, b, p, t)
        tot, jtot = total_cost(hp, b, p, t), j_rl.total_cost(jhp, b, p, t)
        assert (tot.flops, tot.bytes) == (jtot.flops, jtot.bytes)
        assert tot.intensity == jtot.intensity


def test_costs_positive_and_scale_with_shapes():
    hp = PRESETS["medium"]
    for s in pipeline_costs(hp, B=1, P=128, T=768):
        assert s.flops > 0 and s.bytes > 0, s.stage
    t1 = total_cost(hp, 1, 128, 768)
    t2 = total_cost(hp, 2, 128, 768)
    assert t2.flops == pytest.approx(2 * t1.flops, rel=0.05)
    f1 = flow_cost(hp, 1, 768)
    f2 = flow_cost(hp, 1, 1536)
    assert f2.flops == pytest.approx(2 * f1.flops, rel=0.01)


def test_vocoder_dominates_medium_voice():
    hp = PRESETS["medium"]
    voc = sum(s.flops for s in vocoder_level_costs(hp, 1, 768))
    assert voc / total_cost(hp, 1, 128, 768).flops > 0.7


def test_vocoder_flops_match_param_math():
    hp = PRESETS["medium"]
    T = 100
    up0 = vocoder_level_costs(hp, 1, T)[1]
    assert up0.stage == "vocoder.up0"
    ct_macs = T * 16 * 512 * 256
    res_macs = sum(T * hp.upsample_rates[0] * 256 * 256 * kj * 2 * len(dils)
                   for kj, dils in zip(hp.resblock_kernel_sizes, hp.resblock_dilation_sizes))
    assert up0.flops == pytest.approx(2 * (ct_macs + res_macs), rel=1e-6)


def test_encoder_dp_costs_reasonable():
    hp = PRESETS["medium"]
    e = encoder_cost(hp, 1, 128)
    d = duration_predictor_cost(hp, 1, 128)
    assert e.flops > d.flops
    assert e.intensity > 1.0


def test_the_medium_bench_batch_in_numbers():
    """The figures the layer split is read against: medium at B=32, P=128,
    T=192 and T=768."""
    hp = PRESETS["medium"]
    a, b = total_cost(hp, 32, 128, 192), total_cost(hp, 32, 128, 768)
    assert round(a.flops / 1e12, 2) == 3.92 and round(a.bytes / 1e9, 1) == 19.2
    assert round(b.flops / 1e12, 1) == 15.5 and round(b.bytes / 1e9, 1) == 74.9


def test_annotate_divides_by_the_published_peaks():
    peaks = rl.published_peaks()
    assert peaks["hbm_gb_s"] == PEAK_BYTES_PER_S / 1e9
    for tier, peak in (("highest", TIER_FLOPS["highest"]), (None, TIER_FLOPS["highest"]),
                       ("high", TIER_FLOPS["high"]), ("default", TIER_FLOPS["default"]),
                       ("bfloat16", PEAK_FLOPS["bf16"])):
        s = rl.annotate(rl.StageCost("x", flops=2e12, bytes=3e9), 10.0, peaks, tier)
        assert s.achieved_tf_s == pytest.approx(200.0)
        assert s.mfu == pytest.approx(200e12 / peak)
        assert s.hbm_frac == pytest.approx(300e9 / PEAK_BYTES_PER_S)
        assert s.bound == ("compute" if s.mfu >= s.hbm_frac else "memory")


def test_measure_ceilings_on_the_cpu():
    ceilings = rl.measure_ceilings(device="cpu", **TINY_CEILINGS)
    assert set(ceilings) == {"gemm_tf_s_highest", "gemm_tf_s_high", "gemm_tf_s_default",
                             "gemm_tf_s_bf16", "hbm_gb_s"}
    assert all(v > 0 for v in ceilings.values())


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """The port's and the JAX package's measured reports on one tiny voice
    at the bench's mixed tiers, B=2, P=16, T=64, every level."""
    from piper_tpu.engine.runtime import PiperRuntime as JRuntime
    from piper_tpu.engine.runtime import RuntimeOptions as JOptions
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

    model, config = make_synthetic_voice(tmp_path_factory.mktemp("rl_voice"), quality="test",
                                         seed=0)
    mixed = dict(vocoder_precision="high", flow_precision="high")
    rt = PiperRuntime(model, config, RuntimeOptions(**mixed), device="cpu")
    ceilings = rl.measure_ceilings(device="cpu", **TINY_CEILINGS)
    ours = rl.roofline_report(rt, 2, 16, 64, iters=2, per_level=True, ceilings=ceilings)
    jrt = JRuntime(model, config, JOptions(**mixed))
    theirs = j_rl.roofline_report(jrt, 2, 16, 64, iters=2, per_level=True,
                                  ceilings={"gemm_tf_s_highest": 1.0, "hbm_gb_s": 1.0})
    return ours, theirs, ceilings


def test_measured_report_matches_the_reference(reports):
    ours, theirs, _ = reports
    key = [(s["stage"], s["gflops"], s["gb"], s["intensity_flop_per_byte"])
           for s in ours["stages"]]
    assert key == [(s["stage"], s["gflops"], s["gb"], s["intensity_flop_per_byte"])
                   for s in theirs["stages"]]
    assert [s["stage"] for s in ours["stages"]] == [
        "encode(enc+dp)", "flow", "vocoder", "vocoder.up0", "vocoder.up1"]
    for k in ("batch", "phoneme_bucket", "frame_bucket", "total_gflops_per_synthesis",
              "total_gb_min_traffic"):
        assert ours[k] == theirs[k], k
    assert set(theirs) <= set(ours)
    assert set(theirs["stages"][0]) <= set(ours["stages"][0])


def test_measured_report_rows(reports):
    ours, _, ceilings = reports
    assert ours["device"] is None and ours["timing"] == "wall"
    assert ours["peaks"] == rl.published_peaks()
    assert set(ours["ceilings"]) == set(ceilings) and all(
        v > 0 for v in ours["ceilings"].values())
    tiers = {s["stage"]: s["tier"] for s in ours["stages"]}
    assert tiers == {"encode(enc+dp)": "highest", "flow": "high", "vocoder": "high",
                     "vocoder.up0": "high", "vocoder.up1": "high"}
    for s in ours["stages"]:
        assert s["ms"] > 0 and s["tf_s"] > 0 and s["gb_s"] > 0
        assert 0 < s["mfu"] < 1 and 0 < s["hbm_frac"] < 1
        assert s["bound"] in ("compute", "memory") and s["kernels"] is None
        peak = rl.published_peaks()[rl._TIER_CEILING_KEY[s["tier"]]]
        assert s["mfu"] == pytest.approx(s["tf_s"] / peak, rel=1e-4)


def test_level_rows_run_the_production_level(monkeypatch, reports):
    """Each level row calls hifigan._level with the level's input width,
    mask, bounds (all frames live) and tier, as hifigan_generator does."""
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu_torch.models.vits import hifigan

    seen = set()
    real = hifigan._level

    def spy(x, m, bounds, i, p, hp, use_rb2, precision):
        seen.add((i, tuple(x.shape), tuple(m.shape), str(bounds.tolist()), precision))
        return real(x, m, bounds, i, p, hp, use_rb2, precision)

    monkeypatch.setattr(hifigan, "_level", spy)
    _, _, ceilings = reports
    rt = PiperRuntime(*_tiny_paths(), RuntimeOptions(vocoder_precision=("high", "default")),
                      device="cpu")
    rl.roofline_report(rt, 1, 16, 8, iters=1, ceilings=ceilings)
    hp = rt.hparams
    want, t = set(), 8
    for i in range(hp.num_upsamples):
        c_in = hp.upsample_initial_channel // 2 ** i
        want.add((i, (1, c_in, t), (1, 1, t), str([[0, t]]), ("high", "default")[i]))
        t *= hp.upsample_rates[i]
    # the whole vocoder's calls and the level rows' alike
    assert seen == want


_PATHS = {}


def _tiny_paths():
    if "v" not in _PATHS:
        import tempfile

        from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

        _PATHS["v"] = make_synthetic_voice(tempfile.mkdtemp(prefix="rl_tiny_"),
                                           quality="test", seed=1)
    return _PATHS["v"]


def test_tools_roofline_on_the_cpu(monkeypatch, tmp_path, capsys):
    """python -m piper_tpu_torch.tools.roofline --device cpu: the bench's
    runtime (a synthetic test voice under PIPER_TPU_CACHE), one JSON
    document with the platform and quality (ceilings at a tiny n)."""
    from piper_tpu_torch.tools import roofline as tool

    monkeypatch.setenv("PIPER_TPU_CACHE", str(tmp_path))
    real = rl.measure_ceilings
    monkeypatch.setattr(rl, "measure_ceilings",
                        lambda iters=8, n=4096, device="cuda", stream_mb=256:
                        real(device=device, **TINY_CEILINGS))
    report = tool.main(["--device", "cpu", "--quality", "test", "--batch", "1",
                        "--phonemes", "16", "--frames", "32", "--iters", "1", "--no-levels",
                        "--compact"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == json.loads(json.dumps(report))
    assert (report["platform"], report["quality"], report["batch"]) == ("cpu", "test", 1)
    assert [s["stage"] for s in report["stages"]] == ["encode(enc+dp)", "flow", "vocoder"]
    assert (tmp_path / "synthetic" / "test").is_dir()


def test_tools_roofline_flags_match_the_reference():
    """tools/roofline.py's flags, but --device for --platform (the card by
    default)."""
    import ast
    from pathlib import Path

    from piper_tpu_torch.tools import roofline as tool

    src = (Path(__file__).resolve().parent.parent / "tools" / "roofline.py").read_text()
    theirs = {a.args[0].value for a in ast.walk(ast.parse(src))
              if isinstance(a, ast.Call) and getattr(a.func, "attr", "") == "add_argument"}
    ours = {a.option_strings[0] for a in tool._parser()._actions if a.option_strings} - {"-h"}
    assert ours == (theirs - {"--platform"}) | {"--device"}
    assert tool._parser().parse_args([]).device == "cuda"


def test_level_probe_on_the_cpu(capsys):
    from piper_tpu_torch.tools import level_probe

    rows = level_probe.main(["--device", "cpu", "--b", "1", "--frames", "4", "--level", "3",
                             "--iters", "1", "--reps", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines[0] == {"level": 3, "b": 1, "c_in": 64, "c_out": 32, "t_in": 512,
                        "n_out": 1024, "u": 2, "k": 4, "precision": "high",
                        "device": "cpu", "what": "shapes"}
    assert [r["piece"] for r in lines[1:]] == ["lrelu_only", "lrelu+conv_transpose",
                                               "mrf_fused", "whole_level"]
    assert lines[1:] == rows
    assert all(r["ms_per_call"] > 0 and r["kernels"] is None for r in rows)


def test_level_probe_prints_the_kernels_refusal(monkeypatch, capsys):
    """Where K3 refuses the level, its pieces print an error line (as the
    JAX probe's do) and nothing falls back to the plain version."""
    from piper_tpu_torch.ops.kernels import resblock
    from piper_tpu_torch.tools import level_probe

    def refuse(*a, **k):
        raise ValueError("no time tile fits")

    monkeypatch.setattr(resblock, "resblock1_mrf", refuse)
    rows = level_probe.main(["--device", "cpu", "--b", "1", "--frames", "2", "--level", "0",
                             "--iters", "1", "--reps", "1"])
    assert [("error" in r) for r in rows] == [False, False, True, True]
    assert rows[2]["error"] == "ValueError: no time tile fits"


def test_level_probe_flags_match_the_reference():
    from piper_tpu_torch.tools import level_probe

    dests = {a.dest: a.default for a in level_probe._parser()._actions if a.dest != "help"}
    assert dests == {"b": 32, "frames": 768, "level": 3, "iters": 10, "reps": 3,
                     "precision": "high", "device": "cuda"}


def test_layer_split_configs_and_the_card_only():
    """tools/layer_split.py builds its three configurations through the
    bench's parser (medium at the bench's mixed tiers, medium and x_low at
    fp32) and measures on the card only."""
    from piper_tpu_torch import bench
    from piper_tpu_torch.tools import layer_split

    tiers = {name: (a.quality, a.precision, a.vocoder_precision, a.flow_precision)
             for name, a in ((n, bench._parser().parse_args(argv))
                             for n, argv in layer_split.CONFIGS.items())}
    assert tiers == {"medium_mixed": ("medium", "highest", "high", "high"),
                     "medium_fp32": ("medium", "highest", "none", "none"),
                     "x_low_fp32": ("x_low", "highest", "none", "none")}
    assert layer_split.JAX_DEFAULTS == (128, 768)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            layer_split.main([])
