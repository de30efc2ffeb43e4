"""Two faults of the port against its JAX reference, repaired, on the CPU.

1. ResBlock1 levels whose width or halo the K2/K3 kernels refuse: JAX's
   Pallas kernels take any square C and any halo, so the port routes such
   a level branch by branch through K1 (`hifigan._level`,
   `resblock.stage_takes`), each conv's input masked by the level's bounds
   and the branch's output by them, and matches JAX there: the fp32
   waveform within 1e-4, the lowered tier within the 1e-3 gate
   (BASELINE.md:40), w_ceil equal.
2. The reference's flags: PIPER_TPU_FUSE_MRF=1/0 forces whole-MRF fusion on
   or off at every fused level, and matches JAX's plain lowering either way
   (as tests/test_pallas_kernels.py::test_fuse_mrf_flag_matches_unfused
   holds JAX); PIPER_TPU_NO_PALLAS=1 runs no kernel wrapper at all.

On the CPU the wrappers run their plain versions, so the routes are seen
by spies on the wrappers the vocoder calls.
"""

from dataclasses import fields, replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piper_tpu.models.vits import model as jv
from piper_tpu.models.vits.hparams import VitsHParams as JVitsHParams
from piper_tpu.models.vits.params import params_from_arrays
from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
from piper_tpu_torch.models.vits import hifigan
from piper_tpu_torch.models.vits import model as tv
from piper_tpu_torch.models.vits.hparams import PRESETS, VitsHParams
from piper_tpu_torch.models.vits.params import params_to_torch
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice, synthetic_params
from piper_tpu_torch.ops.kernels import conv as K1
from piper_tpu_torch.ops.kernels import resblock as R
from piper_tpu_torch.utils import env

WAVE_ATOL, MIXED_ATOL = 1e-4, 1e-3
TIERS = ("highest", "high", "default")
# One upsample level of C channels with medium's branches (k 3/7/11 at
# dilations 1/3/5), so the level's width alone sets its route.
ONE_LEVEL = VitsHParams(
    n_vocab=40, inter_channels=16, hidden_channels=16, filter_channels=32,
    n_heads=2, n_layers=1, dp_filter_channels=16, dp_n_flows=2, flow_n_flows=1,
    flow_hidden_channels=16, flow_n_layers=1, resblock_kernel_sizes=[3, 7, 11],
    resblock_dilation_sizes=[[1, 3, 5]] * 3, upsample_rates=[2],
    upsample_initial_channel=64, upsample_kernel_sizes=[4],
)


def _jhp(hp):
    return JVitsHParams(**{f.name: getattr(hp, f.name) for f in fields(hp)})


class _Spies:
    """Calls of the kernel wrappers the vocoder reaches: K1 (per conv), K2
    (per branch) and K3 (per level), each passed on to the wrapper."""

    def __init__(self, monkeypatch):
        self.calls = {"conv1d_same": 0, "resblock1_branch": 0, "resblock1_mrf": 0}
        for mod, name in ((K1, "conv1d_same"), (hifigan, "resblock1_branch"),
                          (hifigan, "resblock1_mrf")):
            monkeypatch.setattr(mod, name, self._spy(name, getattr(mod, name)))

    def _spy(self, name, fn):
        def call(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)
        return call


def _one_level(hp, c, precision, seed=3):
    """The vocoder of `hp` with its one level at C channels, on z of 8
    frames with a short second row (masked, with bounds, as decode runs
    it)."""
    hp = replace(hp, upsample_initial_channel=2 * c)
    tp = params_to_torch(synthetic_params(hp, seed=seed), "cpu")
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.standard_normal((2, hp.inter_channels, 8)).astype(np.float32))
    lengths = torch.tensor([8, 5], dtype=torch.int32)
    mask = (torch.arange(8)[None, :] < lengths[:, None]).float()[:, None, :]
    with torch.inference_mode():
        return hifigan.hifigan_generator(z * mask, tp, hp, level_precisions=precision,
                                         t_mask=mask, t_bounds=lengths)


@pytest.mark.parametrize("c,precision,want", [
    (24, "highest", {"conv1d_same": 18}),   # not a multiple of 16: K1 at every tier
    (24, "high", {"conv1d_same": 18}),
    (24, "default", {"conv1d_same": 18}),
    (48, "high", {"conv1d_same": 18}),      # not a width of the bf16 tiers' stage
    (48, "default", {"conv1d_same": 18}),
    (48, "highest", {"resblock1_branch": 3}),  # "highest" takes 48
    (32, "high", {"resblock1_mrf": 1}),     # the kernels' own routes
    (64, "default", {"resblock1_branch": 3}),
])
def test_level_routes_a_refused_width_through_k1(monkeypatch, c, precision, want):
    """A ResBlock1 level whose width the K2/K3 stage refuses at its tier
    runs branch by branch through K1 (three branches of two convs at three
    dilations: 18 K1 calls) and no K2/K3 call; a width it takes runs K3 (C
    <= 32) or K2 (one call a branch) and no K1."""
    spies = _Spies(monkeypatch)
    out = _one_level(ONE_LEVEL, c, precision)
    assert bool(torch.isfinite(out).all())
    assert spies.calls == {**dict.fromkeys(spies.calls, 0), **want}


def test_level_routes_a_halo_that_fits_no_tile_through_k1(monkeypatch):
    """A branch whose halo leaves no tile in the stage's 256-lane window (k
    = 11 at dilations 1/3/25: 160 samples a side) runs through K1 (six
    convs), while the level's other branch (halo 12) keeps K2; the whole
    MRF, whose halo is the widest branch's, is refused too."""
    hp = replace(ONE_LEVEL, resblock_kernel_sizes=[3, 11],
                 resblock_dilation_sizes=[[1, 3, 5], [1, 3, 25]])
    assert R.branch_halo(11, (1, 3, 25)) == 160
    assert not R.stage_takes(32, 160, 0, mean=True)
    assert R.stage_takes(32, 12, 0)
    spies = _Spies(monkeypatch)
    _one_level(hp, 32, "highest")
    assert spies.calls == {"conv1d_same": 6, "resblock1_branch": 1, "resblock1_mrf": 0}


def test_stage_takes_what_the_wrappers_launch():
    """The predicate is the wrappers' checks: the tier's widths (16, 32, 64;
    at "highest" every multiple of 16 below 128) and a window of at most
    256 lanes (halo up to 127 at a tile of one sample, K2's widest branch
    60 at tile 136)."""
    for tier, widths in ((0, (16, 32, 48, 64, 80, 96, 112)), (1, (16, 32, 64)),
                         (2, (16, 32, 64))):
        assert [c for c in range(1, 129) if R.stage_takes(c, 60, tier)] == list(widths)
    assert R.stage_takes(64, 127, 2) and not R.stage_takes(64, 128, 2)
    assert R.stage_takes(32, 60, 1, mean=True) and not R.stage_takes(32, 200, 1, mean=True)


def _voice_96():
    """The `test` voice's shape with upsample_initial_channel 96: levels of
    48 and 24 channels, one ResBlock1 branch (k=3, dilations 1/3)."""
    return replace(PRESETS["test"], upsample_initial_channel=96)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_refused_widths_match_jax(monkeypatch, precision):
    """The voice with 48- and 24-channel levels, encode and decode with
    injected noise, against JAX with its Pallas kernels in interpret mode:
    w_ceil equal, the waveform within 1e-4 ("highest": C=48 on K2, C=24 on
    K1) or 1e-3 ("high": both levels on K1)."""
    monkeypatch.setenv("PIPER_TPU_PALLAS_INTERPRET", "1")
    hp = _voice_96()
    w = synthetic_params(hp, seed=21)
    rng = np.random.default_rng(22)
    b, p, frames = 2, 12, 32
    ids = rng.integers(1, hp.n_vocab, size=(b, p))
    lengths = np.array([p, p - 3])
    dp_noise = rng.standard_normal((b, 2, p)).astype(np.float32)
    main_noise = rng.standard_normal((b, hp.inter_channels, frames)).astype(np.float32)
    jp = params_from_arrays(w)
    j_enc = jv.encode(jp, _jhp(hp), jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(dp_noise))
    want, want_len = jv.decode(jp, _jhp(hp), j_enc, jnp.asarray(main_noise), max_frames=frames,
                               vocoder_precision=precision, use_pallas=True)
    spies = _Spies(monkeypatch)
    tp = params_to_torch(w, "cpu")
    with torch.inference_mode():
        t_enc = tv.encode(tp, hp, torch.from_numpy(ids), torch.from_numpy(lengths),
                          torch.from_numpy(dp_noise))
        got, got_len = tv.decode(tp, hp, t_enc, torch.from_numpy(main_noise), max_frames=frames,
                                 vocoder_precision=precision)
    np.testing.assert_array_equal(t_enc.w_ceil.numpy(), np.asarray(j_enc.w_ceil))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert 0 < int(got_len.min()) < frames  # a row ends inside the bucket
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=WAVE_ATOL if precision == "highest" else MIXED_ATOL)
    # "highest": C=48 one K2 branch, C=24 two K1 convs a dilation; "high": both on K1
    assert spies.calls == ({"conv1d_same": 4, "resblock1_branch": 1, "resblock1_mrf": 0}
                           if precision == "highest" else
                           {"conv1d_same": 8, "resblock1_branch": 0, "resblock1_mrf": 0})


# tests/test_pallas_kernels.py::test_fuse_mrf_flag_matches_unfused's voice:
# two fused levels, C=32 and C=16.
FLAG_HP = VitsHParams(
    n_vocab=40, inter_channels=16, hidden_channels=16, filter_channels=32,
    n_heads=2, n_layers=1, dp_filter_channels=16, dp_n_flows=2,
    flow_n_flows=1, flow_hidden_channels=16, flow_n_layers=1,
    resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[[1, 3], [1, 3]],
    upsample_rates=[4, 2], upsample_initial_channel=64,
    upsample_kernel_sizes=[8, 4],
)


@pytest.mark.parametrize("force", ["0", "1"])
def test_fuse_mrf_flag_matches_unfused(monkeypatch, force):
    """PIPER_TPU_FUSE_MRF=0 (the branch kernel at every fused level) and =1
    (the MRF kernel at every fused level) both match JAX's plain lowering
    (use_pallas=False) on decode_window within 1e-5, as the JAX test holds
    its kernels: the flag changes the kernel, never the result."""
    monkeypatch.setenv("PIPER_TPU_FUSE_MRF", force)
    hp = FLAG_HP
    w = synthetic_params(hp, seed=5)
    rng = np.random.default_rng(0)
    b, p = 2, 12
    ids = rng.integers(0, hp.n_vocab, size=(b, p))
    lengths = np.array([p, p - 3])
    dp_noise = rng.standard_normal((b, 2, p)).astype(np.float32)
    window, t_offset, total = 24, 8, 40
    noise = rng.standard_normal((b, hp.inter_channels, window)).astype(np.float32)
    jp = params_from_arrays(w)
    j_enc = jv.encode(jp, _jhp(hp), jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(dp_noise))
    plain = jv.decode_window(jp, _jhp(hp), j_enc, jnp.asarray(noise), jnp.int32(t_offset),
                             window=window, total_frames=jnp.int32(total), use_pallas=False)
    spies = _Spies(monkeypatch)
    tp = params_to_torch(w, "cpu")
    with torch.inference_mode():
        t_enc = tv.encode(tp, hp, torch.from_numpy(ids), torch.from_numpy(lengths),
                          torch.from_numpy(dp_noise))
        got = tv.decode_window(tp, hp, t_enc, torch.from_numpy(noise), t_offset, window=window,
                               total_frames=total)
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), atol=1e-5, rtol=0)
    assert spies.calls == ({"conv1d_same": 0, "resblock1_branch": 0, "resblock1_mrf": 2}
                           if force == "1" else
                           {"conv1d_same": 0, "resblock1_branch": 4, "resblock1_mrf": 0})


def test_no_pallas_flag_runs_no_kernel(monkeypatch, tmp_path):
    """PIPER_TPU_NO_PALLAS=1 is use_pallas=False, read when the runtime is
    made: a synthesize reaches no K1-K3 wrapper (their launch counters stay
    where they were) and equals the use_pallas=False runtime bit for bit;
    without the flag the same synthesize reaches K3 at both levels."""
    model, config = make_synthetic_voice(tmp_path / "v", quality="test", seed=0)
    ids = FIXTURE_PHONEME_IDS
    counters = (K1.conv1d_same, R.resblock1_branch, R.resblock1_mrf)
    spies = _Spies(monkeypatch)
    with_kernels = PiperRuntime(model, config, device="cpu").synthesize(ids, seed=1)
    assert spies.calls["resblock1_mrf"] == 2
    assert "NO_PALLAS" in env.__doc__ and "FUSE_MRF" in env.__doc__
    monkeypatch.setenv("PIPER_TPU_NO_PALLAS", "1")
    spies = _Spies(monkeypatch)
    before = [fn.launches for fn in counters]
    got = PiperRuntime(model, config, device="cpu").synthesize(ids, seed=1)
    assert spies.calls == dict.fromkeys(spies.calls, 0)
    assert [fn.launches for fn in counters] == before
    monkeypatch.delenv("PIPER_TPU_NO_PALLAS")
    plain = PiperRuntime(model, config, RuntimeOptions(use_pallas=False),
                         device="cpu").synthesize(ids, seed=1)
    assert np.array_equal(got, plain)
    assert got.shape == with_kernels.shape
