"""The port's "high" tier around the kernels, and its calibrate_precision.

At "high" the card's PyTorch convs run in fp32 (tier_scope keeps TF32
off), because the reference's "high" is the 3-pass bf16 split (mxu_dot,
about 16 mantissa bits) and TF32 keeps 10. Here that arithmetic is held
against the JAX package's own, `mxu_dot(w, cols, "high")` on an im2col of
the input, both measured from the exact (fp64) conv: the fp32 conv lands
no farther from it than the reference's "high" does, and a TF32 conv (each
operand rounded to 10 mantissa bits) more than ten times farther. On the
CPU a tier scope changes nothing, so the ops' convs are the fp32 ones.

The calibration tool keeps the JAX tool's candidate schedules
(tools/calibrate_precision.py, loaded by path: the port may not import it)
and runs on the CPU at the test preset.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from piper_tpu.ops.pallas.conv import mxu_dot
from piper_tpu_torch.ops import conv as ops_conv
from piper_tpu_torch.ops.kernels import precision
from piper_tpu_torch.ops.kernels.precision import split_tf32
from piper_tpu_torch.tools import calibrate_precision

ROOT = Path(__file__).resolve().parent.parent


def _im2col(xp: np.ndarray, k: int, d: int, t_out: int) -> np.ndarray:
    """(B, C, T_padded) -> (B, C*k, t_out): row ci*k + j holds xp[:, ci, t + j*d]."""
    cols = np.stack([xp[:, :, j * d: j * d + t_out] for j in range(k)], axis=2)
    return cols.reshape(xp.shape[0], -1, t_out)


def _high_by_mxu_dot(w2: np.ndarray, cols: np.ndarray, bias: np.ndarray) -> np.ndarray:
    return np.stack([np.asarray(mxu_dot(jnp.asarray(w2), jnp.asarray(c), "high"))
                     for c in cols]) + bias[None, :, None]


def _tf32_conv(conv, x, w, b, **kw):
    """A TF32 conv: both operands rounded to tf32, the products and sums in
    fp64."""
    return conv(split_tf32(x)[0].double(), split_tf32(w)[0].double(), b.double(), **kw).float()


def _errs_from_exact(conv, ours, x, w, b, want_high, **kw):
    """Max-abs from the fp64 conv of: the port's conv (`ours`), the
    reference's "high" (`want_high`) and a TF32 conv."""
    t = [torch.from_numpy(a) for a in (x, w, b)]
    exact = conv(*(a.double() for a in t), **kw).numpy()
    got = ours(*t, **kw).numpy()
    assert got.shape == want_high.shape == exact.shape
    tf32 = _tf32_conv(conv, *t, **kw).numpy()
    return tuple(float(np.abs(a - exact).max()) for a in (got, want_high, tf32))


@pytest.mark.parametrize("c_in,c_out,k,d", [(32, 48, 5, 3), (64, 64, 7, 1), (128, 64, 3, 5)])
def test_high_conv1d_meets_the_reference_high(c_in, c_out, k, d):
    rng = np.random.default_rng(c_in + k + d)
    x = rng.standard_normal((2, c_in, 200)).astype(np.float32)
    w = (rng.standard_normal((c_out, c_in, k)) / np.sqrt(c_in * k)).astype(np.float32)
    b = (rng.standard_normal((c_out,)) * 0.1).astype(np.float32)
    pad = (k - 1) // 2 * d
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad)))
    want = _high_by_mxu_dot(w.reshape(c_out, -1), _im2col(xp, k, d, 200), b)
    ours, ref, tf32 = _errs_from_exact(F.conv1d, ops_conv.conv1d, x, w, b, want,
                                       padding=pad, dilation=d)
    assert ours <= ref
    assert tf32 > 10 * ref


@pytest.mark.parametrize("c_in,c_out,k,s", [(64, 32, 16, 8), (32, 16, 4, 2)])
def test_high_conv_transpose1d_meets_the_reference_high(c_in, c_out, k, s):
    """The upsampling conv-transpose (HiFi-GAN's kernel k, stride s,
    padding (k - s) / 2) as the correlation of the stride-dilated input with
    the flipped kernel, through mxu_dot at "high"."""
    rng = np.random.default_rng(k * s)
    t = 40
    x = rng.standard_normal((2, c_in, t)).astype(np.float32)
    w = (rng.standard_normal((c_in, c_out, k)) / np.sqrt(c_in * k / s)).astype(np.float32)
    b = (rng.standard_normal((c_out,)) * 0.1).astype(np.float32)
    p = (k - s) // 2
    t_out = (t - 1) * s + k - 2 * p
    xd = np.zeros((2, c_in, (t - 1) * s + 1), np.float32)
    xd[:, :, ::s] = x
    xp = np.pad(xd, ((0, 0), (0, 0), (k - 1 - p, k - 1 - p)))
    w2 = np.flip(w, -1).transpose(1, 0, 2).reshape(c_out, -1)
    want = _high_by_mxu_dot(np.ascontiguousarray(w2), _im2col(xp, k, 1, t_out), b)
    ours, ref, tf32 = _errs_from_exact(F.conv_transpose1d, ops_conv.conv_transpose1d,
                                       x, w, b, want, stride=s, padding=p)
    assert ours <= ref
    assert tf32 > 10 * ref


def test_scope_tiers_names_the_generators_scopes(monkeypatch):
    """calibrate_precision.scope_tiers opens the named scopes of
    hifigan_generator at the tier given (conv_pre, each level, conv_post,
    in that order), leaves the others at their level's tier, and puts the
    generator's own tier_scope back after."""
    from piper_tpu_torch.models.vits import hifigan
    from piper_tpu_torch.models.vits.hparams import PRESETS
    from piper_tpu_torch.models.vits.params import params_to_torch
    from piper_tpu_torch.models.vits.synthetic import synthetic_params

    hp = PRESETS["test"]
    opened = []
    real = precision.tier_scope

    def recorder(tier, device):
        opened.append(tier)
        return real(tier, device)

    monkeypatch.setattr(precision, "tier_scope", recorder)
    own = hifigan.tier_scope
    params = params_to_torch(synthetic_params(hp, seed=0), "cpu")
    z = torch.randn(1, hp.inter_channels, 8, generator=torch.Generator().manual_seed(0))
    assert calibrate_precision.vocoder_scopes(hp.num_upsamples) == \
        ("conv_pre", "level0", "level1", "conv_post")
    with torch.inference_mode(), \
            calibrate_precision.scope_tiers({"conv_pre": "default", "level1": "default"}, 2):
        hifigan.hifigan_generator(z, params, hp, level_precisions=["highest", "high"])
        hifigan.hifigan_generator(z, params, hp, level_precisions=["high", "high"])
    assert opened == ["default", "highest", "default", "high"] + ["default", "high", "default",
                                                                   "high"]
    assert hifigan.tier_scope is own


def test_scope_tiers_refuses_a_count_of_scopes_off_its_levels():
    """Given the wrong number of levels, scope_tiers cannot name the
    generator's scopes: it raises after the block rather than mislabel
    them, and still puts the generator's tier_scope back."""
    from piper_tpu_torch.models.vits import hifigan
    from piper_tpu_torch.models.vits.hparams import PRESETS
    from piper_tpu_torch.models.vits.params import params_to_torch
    from piper_tpu_torch.models.vits.synthetic import synthetic_params

    hp = PRESETS["test"]  # two upsample levels: four scopes a call
    own = hifigan.tier_scope
    params = params_to_torch(synthetic_params(hp, seed=0), "cpu")
    z = torch.randn(1, hp.inter_channels, 8, generator=torch.Generator().manual_seed(0))
    with pytest.raises(AssertionError, match="opened 4 scopes"):
        with torch.inference_mode(), calibrate_precision.scope_tiers({}, 3):
            hifigan.hifigan_generator(z, params, hp, level_precisions=["highest", "high"])
    assert hifigan.tier_scope is own


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_calibrate_precision",
                                                  ROOT / "tools" / "calibrate_precision.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_levels", [3, 4, 5])
def test_candidate_schedules_are_the_jax_tools(n_levels):
    assert calibrate_precision.candidate_schedules(n_levels) == \
        _jax_tool().candidate_schedules(n_levels)


def test_calibrate_precision_runs_on_the_cpu(capsys):
    """The tool at the test preset on the CPU: one JSON line with a row per
    candidate schedule and a row per stage (the flows and each vocoder
    scope's PyTorch convs both ways, each narrow level's kernels), and the
    batch against its rows. "highest" is the reference itself; on the CPU a
    scope changes nothing, so the two ways agree, at 0."""
    result = calibrate_precision.main(["--device", "cpu", "--quality", "test", "--factor", "1",
                                       "--batch", "2", "--iters", "1", "--serving-batch", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    scheds = [tuple(r["schedule"]) for r in line["rows"]]
    assert scheds == calibrate_precision.candidate_schedules(2)
    assert line["rows"][0]["max_abs_err"] == line["rows"][0]["max_abs_err_tf32"] == 0.0
    assert all(r["ms"] > 0 for r in line["rows"])
    assert all(r["max_abs_err"] <= 1e-4 for r in line["rows"] if "default" not in r["schedule"])
    stages = {(r["stage"], r["route"]): r["max_abs_err"] for r in line["stages"]}
    convs = ["flows", "conv_pre", "level0", "level1", "conv_post"]
    assert set(stages) == {(s, w) for s in convs for w in ("fp32", "tf32")} | \
        {("level0.kernels", "kernel"), ("level1.kernels", "kernel")}
    assert all(stages[(s, "fp32")] == stages[(s, "tf32")] == 0.0 for s in convs)
    assert 0 < stages[("level0.kernels", "kernel")] <= 1e-4
    batch = line["batch_vs_rows"]
    assert (batch["rows"], batch["compared_rows"]) == (2, [0, 1])
    assert batch["max_abs_err"] <= 1e-4


def test_calibrate_precision_flow_tiers_on_the_cpu(capsys):
    """--flow-tiers: the reference's z_p through the flows at each tier,
    the vocoder at "high", one row per tier; fp32 flows are the reference's."""
    result = calibrate_precision.main(["--device", "cpu", "--quality", "test", "--factor", "1",
                                       "--batch", "2", "--flow-tiers", "highest,high,none"])
    rows = result["flow_rows"]
    assert [r["flow_tier"] for r in rows] == ["highest", "high", "none"]
    assert rows[0]["max_abs_err"] == rows[2]["max_abs_err"] <= 1e-4
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["flow_rows"] == rows


def test_chip_smoke_keeps_every_mixed_comparison_for_its_margin_line(capsys, monkeypatch):
    """chip_smoke's mixed comparisons (held to the 1e-3 gate) are kept with
    their max-abs against the 5e-4 target, fp32 ones are not; the margin
    line names the worst and those above the target, and the phase fails
    if there are any."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "MIXED_MARGINS", [])
    rows = [np.zeros(4, np.float32)]
    assert chip_smoke._rows_close("p", "fp32", rows, [rows[0] + 5e-5], chip_smoke.WAVE_ATOL) \
        == pytest.approx(5e-5)
    chip_smoke._rows_close("p", "a", rows, [rows[0] + 2e-4], chip_smoke.MIXED_ATOL)
    chip_smoke.phase_mixed_margin()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["phase"], line["target"], line["comparisons"]) == ("mixed_margin", 5e-4, 1)
    assert line["all_within_target"] and line["above_target"] == []
    chip_smoke._rows_close("p", "b", rows, [rows[0] + 7e-4], chip_smoke.MIXED_ATOL)
    assert [m["what"] for m in chip_smoke.MIXED_MARGINS] == ["a", "b"]
    with pytest.raises(AssertionError, match="above 0.0005"):
        chip_smoke.phase_mixed_margin()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["comparisons"] == 2 and line["worst"]["what"] == "b"
    assert not line["all_within_target"]
    assert [m["what"] for m in line["above_target"]] == ["b"]
