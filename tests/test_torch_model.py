"""The port's VITS modules and graph against the JAX package on the CPU.

Same weights (numpy, from synthetic_params), same injected noise, compared
at the bars tests/test_vits_parity.py holds the JAX package to: module
tensors 2e-5 max-abs, logw 5e-5, w_ceil exactly equal, waveform 1e-4.
"""

from dataclasses import fields, replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piper_tpu.models.vits import model as jv
from piper_tpu.models.vits.duration_predictor import stochastic_duration_predictor_reverse as j_sdp
from piper_tpu.models.vits.flows import flow_reverse as j_flow
from piper_tpu.models.vits.hifigan import hifigan_generator as j_hifigan
from piper_tpu.models.vits.hparams import VitsHParams as JVitsHParams
from piper_tpu.models.vits.params import params_from_arrays
from piper_tpu.models.vits.text_encoder import text_encoder as j_text_encoder
from piper_tpu.ops.masking import sequence_mask
from piper_tpu_torch.models.vits import model as tv
from piper_tpu_torch.models.vits.duration_predictor import stochastic_duration_predictor_reverse as t_sdp
from piper_tpu_torch.models.vits.flows import flow_reverse as t_flow
from piper_tpu_torch.models.vits.hifigan import hifigan_generator as t_hifigan
from piper_tpu_torch.models.vits.hparams import VitsHParams
from piper_tpu_torch.models.vits.params import params_to_torch
from piper_tpu_torch.models.vits.synthetic import synthetic_params
from piper_tpu_torch.models.vits.text_encoder import text_encoder as t_text_encoder
from piper_tpu_torch.ops.kernels import conv as K1

SMALL = VitsHParams(
    n_vocab=40, inter_channels=32, hidden_channels=32, filter_channels=64,
    n_heads=2, n_layers=2, kernel_size=3, window_size=4, dp_filter_channels=32,
    dp_n_flows=2, flow_n_flows=2, flow_hidden_channels=32, flow_n_layers=2,
    resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
    upsample_rates=[4, 4], upsample_initial_channel=64, upsample_kernel_sizes=[8, 8],
)
# Speaker conditioning at module level (the runtime tests: test_torch_speakers.py).
SMALL_G = replace(SMALL, n_speakers=4, gin_channels=16)
# A vocoder whose levels take all three routes: C=128 unfused convs, C=64
# the branch kernel, C=32 the MRF kernel (medium's kernels and dilations).
ROUTES = replace(
    SMALL, upsample_initial_channel=256, upsample_rates=[2, 2, 2],
    upsample_kernel_sizes=[4, 4, 4], resblock_kernel_sizes=[3, 7, 11],
    resblock_dilation_sizes=[[1, 3, 5]] * 3,
)
# A ResBlock2 vocoder with x_low's kernels and dilations: C=128 plain convs,
# C=64 and C=32 the conv1d_same kernel.
ROUTES2 = replace(
    ROUTES, resblock="2", resblock_kernel_sizes=[3, 5, 7],
    resblock_dilation_sizes=[[1, 2], [2, 6], [3, 12]],
)

MODULE_ATOL, LOGW_ATOL, WAVE_ATOL = 2e-5, 5e-5, 1e-4
MIXED_ATOL = 1e-3  # the lowered-precision waveform gate (BASELINE.md:40)


def _jhp(hp):
    """The JAX package's VitsHParams with the same fields as the port's hp,
    for the JAX side of a comparison."""
    return JVitsHParams(**{f.name: getattr(hp, f.name) for f in fields(hp)})


@pytest.fixture(scope="module", params=[SMALL, SMALL_G], ids=["single", "cond"])
def setup(request):
    hp = request.param
    w = synthetic_params(hp, seed=7)
    g = None
    if hp.gin_channels:
        g = np.random.default_rng(11).standard_normal((2, hp.gin_channels, 1)).astype(np.float32)
    return hp, params_from_arrays(w), params_to_torch(w, "cpu"), g


def _jg(g):
    return None if g is None else jnp.asarray(g)


def _tg(g):
    return None if g is None else torch.from_numpy(g)


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("p,valid", [(12, [12, 9]), (3, [3, 2])])
def test_text_encoder(setup, p, valid):
    hp, jp, tp, _ = setup
    ids = np.random.default_rng(0).integers(0, hp.n_vocab, size=(2, p))
    lengths = np.array(valid)
    want = j_text_encoder(jnp.asarray(ids), jnp.asarray(lengths), jp, _jhp(hp))
    with torch.inference_mode():
        got = t_text_encoder(torch.from_numpy(ids), torch.from_numpy(lengths), tp, hp)
    _close(got[3], want[3], 0)
    for gt, wt in zip(got[:3], want[:3]):
        _close(gt, wt, MODULE_ATOL)


def test_sdp_reverse(setup):
    hp, jp, tp, g = setup
    rng = np.random.default_rng(2)
    b, p = 2, 12
    x = rng.standard_normal((b, hp.hidden_channels, p)).astype(np.float32)
    mask = np.array(sequence_mask(jnp.asarray(np.array([12, 7])), p))
    noise = rng.standard_normal((b, 2, p)).astype(np.float32)
    want = j_sdp(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(noise), jp, _jhp(hp), g=_jg(g))
    with torch.inference_mode():
        got = t_sdp(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(noise),
                    tp, hp, g=_tg(g))
    _close(got, want, LOGW_ATOL)


def test_flow_reverse(setup):
    hp, jp, tp, g = setup
    rng = np.random.default_rng(3)
    z_p = rng.standard_normal((2, hp.inter_channels, 20)).astype(np.float32)
    mask = np.array(sequence_mask(jnp.asarray(np.array([20, 13])), 20))
    want = j_flow(jnp.asarray(z_p), jnp.asarray(mask), jp, _jhp(hp), g=_jg(g))
    with torch.inference_mode():
        got = t_flow(torch.from_numpy(z_p), torch.from_numpy(mask), tp, hp, g=_tg(g))
    _close(got, want, MODULE_ATOL)


def test_hifigan(setup):
    hp, jp, tp, g = setup
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, hp.inter_channels, 16)).astype(np.float32)
    mask = np.array(sequence_mask(jnp.asarray(np.array([16, 11])), 16))
    want = j_hifigan(jnp.asarray(z * mask), jp, _jhp(hp), g=_jg(g), t_mask=jnp.asarray(mask))
    with torch.inference_mode():
        got = t_hifigan(torch.from_numpy(z * mask), tp, hp, g=_tg(g),
                        t_mask=torch.from_numpy(mask))
    _close(got, want, WAVE_ATOL)


def _inputs(hp, b=2, p=12, frames=64, seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, hp.n_vocab, size=(b, p))
    lengths = np.array([p, p - 3][:b])
    dp_noise = rng.standard_normal((b, 2, p)).astype(np.float32)
    main_noise = rng.standard_normal((b, hp.inter_channels, frames)).astype(np.float32)
    return ids, lengths, dp_noise, main_noise


def _debug_infer_both(hp, w, frames=64, seed=5):
    ids, lengths, dp_noise, main_noise = _inputs(hp, frames=frames, seed=seed)
    want = jv.debug_infer(params_from_arrays(w), _jhp(hp), jnp.asarray(ids), jnp.asarray(lengths),
                          jnp.asarray(dp_noise), jnp.asarray(main_noise), max_frames=frames)
    with torch.inference_mode():
        got = tv.debug_infer(params_to_torch(w, "cpu"), hp, torch.from_numpy(ids),
                             torch.from_numpy(lengths), torch.from_numpy(dp_noise),
                             torch.from_numpy(main_noise), max_frames=frames)
    assert set(got) == set(want)
    exact = {"x_mask", "w_ceil", "y_lengths", "y_mask", "path"}
    for key in sorted(got):
        atol = (0 if key in exact else LOGW_ATOL if key == "logw"
                else WAVE_ATOL if key == "audio" else MODULE_ATOL)
        _close(got[key], want[key], atol)


def test_debug_infer_matches_reference():
    _debug_infer_both(SMALL, synthetic_params(SMALL, seed=7))


def test_debug_infer_resblock2_matches_reference():
    """A ResBlock2 vocoder, masked and without bounds: its narrow convs run
    conv1d_same on the masked input, as JAX's do."""
    _debug_infer_both(ROUTES2, synthetic_params(ROUTES2, seed=9), frames=32, seed=8)


def _decode_both(hp, w, seed):
    """Port decode against JAX decode without Pallas, one row ending inside
    the 32-frame bucket."""
    ids, lengths, dp_noise, main_noise = _inputs(hp, frames=32, seed=seed)
    jp = params_from_arrays(w)
    j_enc = jv.encode(jp, _jhp(hp), jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(dp_noise))
    want, want_len = jv.decode(jp, _jhp(hp), j_enc, jnp.asarray(main_noise), max_frames=32,
                               use_pallas=False)
    tp = params_to_torch(w, "cpu")
    with torch.inference_mode():
        t_enc = tv.encode(tp, hp, torch.from_numpy(ids), torch.from_numpy(lengths),
                          torch.from_numpy(dp_noise))
        _close(t_enc.w_ceil, j_enc.w_ceil, 0)
        got, got_len = tv.decode(tp, hp, t_enc, torch.from_numpy(main_noise), max_frames=32)
    _close(got_len, want_len, 0)
    assert 0 < int(got_len.min()) < 32  # a row ends inside the bucket: the mask matters
    _close(got, want, WAVE_ATOL)


def test_decode_takes_all_vocoder_routes():
    """Branch kernel at C=64, MRF kernel at C=32, plain convs at C=128
    (plain versions on the CPU)."""
    _decode_both(ROUTES, synthetic_params(ROUTES, seed=3), seed=6)


def test_decode_resblock2_matches_reference():
    """conv1d_same at C=64 and C=32 (x_low's kernels and dilations), plain
    convs at C=128."""
    _decode_both(ROUTES2, synthetic_params(ROUTES2, seed=4), seed=6)


def test_infer_is_encode_then_decode():
    hp = SMALL
    tp = params_to_torch(synthetic_params(hp, seed=7), "cpu")
    ids, lengths, dp_noise, main_noise = (torch.from_numpy(a) for a in _inputs(hp))
    with torch.inference_mode():
        audio, y_len = tv.infer(tp, hp, ids, lengths, dp_noise, main_noise, max_frames=64)
        enc = tv.encode(tp, hp, ids, lengths, dp_noise)
        audio2, y_len2 = tv.decode(tp, hp, enc, main_noise, max_frames=64)
    assert torch.equal(audio, audio2) and torch.equal(y_len, y_len2)


@pytest.mark.parametrize("precision", [None, "high", "default"])
def test_hifigan_resblock2_matches_pallas(monkeypatch, precision):
    """The ResBlock2 vocoder against JAX's with use_pallas=True, its
    pallas_conv1d_same calls in interpret mode; masked, with bounds, as
    decode calls it (the port's K1 takes the bounds, JAX's the masked
    input), at every level's tier: None ("highest"), "high", "default".
    "default" is held to the 1e-3 gate of the lowered tiers (BASELINE.md:40):
    where the two versions' fp32 sums differ in the last bit, the next
    conv's bf16 rounding of its input can flip, and the chain of six convs
    and two upsamplings carries the flip to the waveform (5.1e-4 here)."""
    monkeypatch.setenv("PIPER_TPU_PALLAS_INTERPRET", "1")
    hp = ROUTES2
    w = synthetic_params(hp, seed=5)
    rng = np.random.default_rng(12)
    z = rng.standard_normal((2, hp.inter_channels, 16)).astype(np.float32)
    lengths = np.array([16, 11], np.int32)
    mask = np.array(sequence_mask(jnp.asarray(lengths), 16))
    want = j_hifigan(jnp.asarray(z * mask), params_from_arrays(w), _jhp(hp),
                     level_precisions=precision, t_mask=jnp.asarray(mask), use_pallas=True,
                     t_bounds=jnp.asarray(lengths))
    before = K1.conv1d_same.launches
    with torch.inference_mode():
        got = t_hifigan(torch.from_numpy(z * mask), params_to_torch(w, "cpu"), hp,
                        level_precisions=precision, t_mask=torch.from_numpy(mask),
                        t_bounds=torch.from_numpy(lengths))
    assert K1.conv1d_same.launches == before  # CPU tensors: the plain version
    _close(got, want, MIXED_ATOL if precision == "default" else WAVE_ATOL)


def test_hifigan_level_precisions_match_pallas(monkeypatch):
    """Per-level tiers through every route of the ROUTES vocoder: level 0
    (C=128, "default") PyTorch convs, level 1 (C=64, None) K2, level 2
    (C=32, "high") K3, against JAX's with use_pallas=True, its kernels in
    interpret mode. A None entry runs the level's kernels at "highest" and
    its other convs at the outer tier, as JAX's _pallas_precision(None) and
    _prec_ctx(None) do."""
    monkeypatch.setenv("PIPER_TPU_PALLAS_INTERPRET", "1")
    lp = ("default", None, "high")
    hp = ROUTES
    w = synthetic_params(hp, seed=5)
    rng = np.random.default_rng(13)
    z = rng.standard_normal((2, hp.inter_channels, 16)).astype(np.float32)
    lengths = np.array([16, 11], np.int32)
    mask = np.array(sequence_mask(jnp.asarray(lengths), 16))
    want = j_hifigan(jnp.asarray(z * mask), params_from_arrays(w), _jhp(hp),
                     level_precisions=lp, t_mask=jnp.asarray(mask), use_pallas=True,
                     t_bounds=jnp.asarray(lengths))
    tp = params_to_torch(w, "cpu")
    with torch.inference_mode():
        got = [t_hifigan(torch.from_numpy(z * mask), tp, hp, level_precisions=levels,
                         t_mask=torch.from_numpy(mask), t_bounds=torch.from_numpy(lengths))
               for levels in (lp, tuple("highest" if t is None else t for t in lp))]
    _close(got[0], want, WAVE_ATOL)
    assert torch.equal(got[0], got[1])
    with pytest.raises(ValueError, match="2 entries for 3 upsample levels"):
        t_hifigan(torch.from_numpy(z), tp, hp, level_precisions=("high", "high"))
