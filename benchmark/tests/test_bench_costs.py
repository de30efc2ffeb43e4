"""The frozen cost model equals the port's utils/roofline.py (at the commit
it was frozen from) and the live-work counts add up."""

from __future__ import annotations

import dataclasses

import pytest

from benchmark.core import costs
from benchmark.core import spec as specs

SHAPES = [(1, 16, 32), (4, 56, 96), (32, 128, 192), (128, 256, 384)]


def _presets():
    from piper_tpu_torch.models.vits.hparams import PRESETS

    out = {q: PRESETS[q] for q in ("test", "x_low", "medium", "high")}
    return out


@pytest.mark.parametrize("quality", ["test", "x_low", "medium", "high"])
@pytest.mark.parametrize("shape", SHAPES)
def test_frozen_cost_model_equals_the_ports(quality, shape):
    from piper_tpu_torch.utils import roofline

    hp = _presets()[quality]
    b, p, t = shape
    mine = costs.pipeline_costs(dataclasses.asdict(hp), b, p, t)
    theirs = roofline.pipeline_costs(hp, b, p, t)
    assert [(n, f, by) for n, f, by in mine] == [(s.stage, s.flops, s.bytes) for s in theirs]


@pytest.mark.parametrize("config", ["piper_high"])
def test_configs_match_the_presets_they_name(config):
    """piper_high is the port's medium preset."""
    hp = specs.config(config)["hparams"]
    assert hp == dataclasses.asdict(_presets()["medium"])


def test_live_work_is_linear_in_rows_and_kernel_specific():
    high = specs.config("piper_high")["hparams"]
    resblock2 = dataclasses.asdict(_presets()["x_low"])
    one = costs.resblock1_work(high, [[100]])
    two = costs.resblock1_work(high, [[100, 100]])
    assert two[0] == pytest.approx(2 * one[0])
    assert costs.resblock1_work(resblock2, [[100]]) == (0.0, 0.0)
    # K2/K3's levels at piper_high: 64 and 32 channels, 3 kernels x 2 x 3 dilations
    fl, _ = costs.resblock1_work(high, [[1]])
    want = sum(2 * 3 * 2.0 * c * c * k * n for c, n in ((64, 128), (32, 256)) for k in (3, 7, 11))
    assert fl == pytest.approx(want)
    assert costs.step_flops(high, [(14, 20), (28, 40)]) == pytest.approx(
        costs.total_cost(high, 1, 14, 20)[0] + costs.total_cost(high, 1, 28, 40)[0])
