"""The port's VITS modules and graph against the JAX package on the CPU.

Same weights (numpy, from synthetic_params), same injected noise, compared
at the bars tests/test_vits_parity.py holds the JAX package to: module
tensors 2e-5 max-abs, logw 5e-5, w_ceil exactly equal, waveform 1e-4.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piper_tpu.models.vits import model as jv
from piper_tpu.models.vits.duration_predictor import stochastic_duration_predictor_reverse as j_sdp
from piper_tpu.models.vits.flows import flow_reverse as j_flow
from piper_tpu.models.vits.hifigan import hifigan_generator as j_hifigan
from piper_tpu.models.vits.hparams import VitsHParams
from piper_tpu.models.vits.params import params_from_arrays
from piper_tpu.models.vits.synthetic import synthetic_params
from piper_tpu.models.vits.text_encoder import text_encoder as j_text_encoder
from piper_tpu.ops.masking import sequence_mask
from piper_tpu_torch.models.vits import model as tv
from piper_tpu_torch.models.vits.duration_predictor import stochastic_duration_predictor_reverse as t_sdp
from piper_tpu_torch.models.vits.flows import flow_reverse as t_flow
from piper_tpu_torch.models.vits.hifigan import hifigan_generator as t_hifigan
from piper_tpu_torch.models.vits.params import params_to_torch
from piper_tpu_torch.models.vits.text_encoder import text_encoder as t_text_encoder

SMALL = VitsHParams(
    n_vocab=40, inter_channels=32, hidden_channels=32, filter_channels=64,
    n_heads=2, n_layers=2, kernel_size=3, window_size=4, dp_filter_channels=32,
    dp_n_flows=2, flow_n_flows=2, flow_hidden_channels=32, flow_n_layers=2,
    resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
    upsample_rates=[4, 4], upsample_initial_channel=64, upsample_kernel_sizes=[8, 8],
)
# Speaker conditioning exercised at module level (the runtime is single-speaker).
SMALL_G = replace(SMALL, n_speakers=4, gin_channels=16)
# A vocoder whose levels take all three routes: C=128 unfused convs, C=64
# the branch kernel, C=32 the MRF kernel (medium's kernels and dilations).
ROUTES = replace(
    SMALL, upsample_initial_channel=256, upsample_rates=[2, 2, 2],
    upsample_kernel_sizes=[4, 4, 4], resblock_kernel_sizes=[3, 7, 11],
    resblock_dilation_sizes=[[1, 3, 5]] * 3,
)

MODULE_ATOL, LOGW_ATOL, WAVE_ATOL = 2e-5, 5e-5, 1e-4


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
    want = j_text_encoder(jnp.asarray(ids), jnp.asarray(lengths), jp, hp)
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
    want = j_sdp(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(noise), jp, hp, g=_jg(g))
    with torch.inference_mode():
        got = t_sdp(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(noise),
                    tp, hp, g=_tg(g))
    _close(got, want, LOGW_ATOL)


def test_flow_reverse(setup):
    hp, jp, tp, g = setup
    rng = np.random.default_rng(3)
    z_p = rng.standard_normal((2, hp.inter_channels, 20)).astype(np.float32)
    mask = np.array(sequence_mask(jnp.asarray(np.array([20, 13])), 20))
    want = j_flow(jnp.asarray(z_p), jnp.asarray(mask), jp, hp, g=_jg(g))
    with torch.inference_mode():
        got = t_flow(torch.from_numpy(z_p), torch.from_numpy(mask), tp, hp, g=_tg(g))
    _close(got, want, MODULE_ATOL)


def test_hifigan(setup):
    hp, jp, tp, g = setup
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, hp.inter_channels, 16)).astype(np.float32)
    mask = np.array(sequence_mask(jnp.asarray(np.array([16, 11])), 16))
    want = j_hifigan(jnp.asarray(z * mask), jp, hp, g=_jg(g), t_mask=jnp.asarray(mask))
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


def test_debug_infer_matches_reference():
    hp = SMALL
    w = synthetic_params(hp, seed=7)
    ids, lengths, dp_noise, main_noise = _inputs(hp)
    want = jv.debug_infer(params_from_arrays(w), hp, jnp.asarray(ids), jnp.asarray(lengths),
                          jnp.asarray(dp_noise), jnp.asarray(main_noise), max_frames=64)
    with torch.inference_mode():
        got = tv.debug_infer(params_to_torch(w, "cpu"), hp, torch.from_numpy(ids),
                             torch.from_numpy(lengths), torch.from_numpy(dp_noise),
                             torch.from_numpy(main_noise), max_frames=64)
    assert set(got) == set(want)
    exact = {"x_mask", "w_ceil", "y_lengths", "y_mask", "path"}
    for key in sorted(got):
        atol = (0 if key in exact else LOGW_ATOL if key == "logw"
                else WAVE_ATOL if key == "audio" else MODULE_ATOL)
        _close(got[key], want[key], atol)


def test_decode_takes_all_vocoder_routes():
    """Port decode (branch kernel at C=64, MRF kernel at C=32, plain convs
    at C=128; plain versions on the CPU) against JAX decode without Pallas."""
    hp = ROUTES
    w = synthetic_params(hp, seed=3)
    ids, lengths, dp_noise, main_noise = _inputs(hp, frames=32, seed=6)
    jp = params_from_arrays(w)
    j_enc = jv.encode(jp, hp, jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(dp_noise))
    want, want_len = jv.decode(jp, hp, j_enc, jnp.asarray(main_noise), max_frames=32,
                               use_pallas=False)
    tp = params_to_torch(w, "cpu")
    with torch.inference_mode():
        t_enc = tv.encode(tp, hp, torch.from_numpy(ids), torch.from_numpy(lengths),
                          torch.from_numpy(dp_noise))
        _close(t_enc.w_ceil, j_enc.w_ceil, 0)
        got, got_len = tv.decode(tp, hp, t_enc, torch.from_numpy(main_noise), max_frames=32)
    _close(got_len, want_len, 0)
    assert 0 < int(got_len.min()) < 32  # a row ends inside the bucket: the bounds matter
    _close(got, want, WAVE_ATOL)


def test_infer_is_encode_then_decode():
    hp = SMALL
    tp = params_to_torch(synthetic_params(hp, seed=7), "cpu")
    ids, lengths, dp_noise, main_noise = (torch.from_numpy(a) for a in _inputs(hp))
    with torch.inference_mode():
        audio, y_len = tv.infer(tp, hp, ids, lengths, dp_noise, main_noise, max_frames=64)
        enc = tv.encode(tp, hp, ids, lengths, dp_noise)
        audio2, y_len2 = tv.decode(tp, hp, enc, main_noise, max_frames=64)
    assert torch.equal(audio, audio2) and torch.equal(y_len, y_len2)


def test_resblock2_voice_is_refused():
    """ResBlock2 voices need K1 (pallas_conv1d_same), which is not ported."""
    hp = replace(SMALL, resblock="2")
    tp = params_to_torch(synthetic_params(hp, seed=1), "cpu")
    with pytest.raises(NotImplementedError, match="pallas_conv1d_same"):
        t_hifigan(torch.zeros(1, hp.inter_channels, 4), tp, hp)
