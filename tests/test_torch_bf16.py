"""The port's "bfloat16" capacity tier on the CPU, against the JAX package's.

The mode uploads the weights in bf16 and runs every activation in bf16; the
vocoder's kernels take bf16 activations at "default" (on the CPU their plain
versions: the fp32 plain version on the bf16 values, rounded to bf16). The
end-to-end cases are tests/test_bf16_mode.py's two, on the port. The parity
cases hold the port's bf16 against the JAX package's bf16 mode with the same
weights and injected noise, stage by stage, and each kernel's plain bf16
version against JAX's Pallas kernel in interpret mode at "default" on the
same bf16-rounded input, its output rounded to bf16.

Tolerances, with the error measured on the CPU beside each: bf16 keeps 8
mantissa bits (a relative step of 2^-8 = 3.9e-3), and the two frameworks
round at different places (PyTorch's CPU convs and matmuls accumulate in
fp32 and round once; XLA's round each op's output, and the order of the sums
differs), so the bars are in bf16 steps of the values compared.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piper_tpu.models.vits import model as j_model
from piper_tpu.models.vits.params import host_arrays_from_graph as j_host_arrays
from piper_tpu.models.vits.params import params_from_arrays
from piper_tpu.onnx.loader import load_model as j_load_model
from piper_tpu.ops.pallas.conv import pallas_conv1d_same
from piper_tpu.ops.pallas.resblock import pallas_resblock1_branch, pallas_resblock1_mrf
from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
from piper_tpu_torch.models.vits import model as vits
from piper_tpu_torch.models.vits.hparams import derive_hparams
from piper_tpu_torch.models.vits.params import host_arrays_from_graph, params_to_torch
from piper_tpu_torch.onnx.loader import load_model
from piper_tpu_torch.ops.kernels import conv as K1
from piper_tpu_torch.ops.kernels import folded as K4
from piper_tpu_torch.ops.kernels import resblock as R
from piper_tpu_torch.ops.kernels.precision import bf16_ulp

BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def bf16_runtime(tiny_voice):
    return PiperRuntime(*tiny_voice, RuntimeOptions(precision="bfloat16"), device="cpu")


def test_bf16_synthesize(bf16_runtime):
    audio = bf16_runtime.synthesize(FIXTURE_IDS)
    assert audio.dtype == np.float32  # output converts back to f32 PCM
    assert len(audio) > 0 and np.isfinite(audio).all()
    assert np.abs(audio).max() <= 1.0
    assert all(t.dtype == BF16 for t in bf16_runtime.params.values())


def test_bf16_batch_and_stream(bf16_runtime):
    audios = bf16_runtime.synthesize_batch([FIXTURE_IDS, FIXTURE_IDS[:6]])
    assert all(len(a) > 0 and np.isfinite(a).all() for a in audios)
    chunks = list(bf16_runtime.synthesize_stream(FIXTURE_IDS, incremental=True))
    assert chunks[-1].is_final
    assert np.isfinite(np.concatenate([c.samples for c in chunks])).all()


def test_bf16_fused_dispatch_and_int16(tiny_voice):
    """Fused mode, dispatch/fetch (one utterance and a fused group) and the
    int16 output run in the mode: int16 stays int16, the rest float32."""
    rt = PiperRuntime(*tiny_voice, RuntimeOptions(precision="bfloat16", mode="fused",
                                                  output_dtype="int16"), device="cpu")
    one = rt.fetch_fused(*rt.dispatch_fused(FIXTURE_IDS))
    rows = rt.fetch_batch(*rt.dispatch_batch([FIXTURE_IDS, FIXTURE_IDS[:6]], fused=True))
    assert one.dtype == np.int16 and len(one) > 0
    assert [r.dtype for r in rows] == [np.int16, np.int16] and min(map(len, rows)) > 0
    assert rt.hbm_bytes() == sum(2 * t.numel() for t in rt.params.values())


def test_bf16_mode_options():
    """precision "bfloat16" carries only the "default" tier of products:
    a vocoder or flow tier above it raises, None and "default" pass."""
    RuntimeOptions(precision="bfloat16").validate()
    RuntimeOptions(precision="bfloat16", vocoder_precision=("default", None),
                   flow_precision="bfloat16").validate()
    for bad in (dict(vocoder_precision="high"), dict(vocoder_precision=(None, "highest")),
                dict(flow_precision="high")):
        with pytest.raises(ValueError, match="under precision 'bfloat16'"):
            RuntimeOptions(precision="bfloat16", **bad).validate()


def test_params_upload_at_bf16(tiny_voice):
    arrays = host_arrays_from_graph(load_model(tiny_voice[0]).graph)
    params = params_to_torch(arrays, "cpu", BF16)
    for name, a in arrays.items():
        assert params[name].dtype == BF16
        assert torch.equal(params[name], torch.from_numpy(a.astype(np.float32)).to(BF16))


# -- parity with the JAX package's bf16 mode ------------------------------------

@pytest.fixture(scope="module")
def both(tiny_voice):
    """(port params, JAX params, hparams) of the tiny voice, both bf16."""
    arrays = j_host_arrays(j_load_model(tiny_voice[0]).graph)
    graph = load_model(tiny_voice[0]).graph
    hp = derive_hparams(graph, sample_rate=22050, n_speakers=1)
    return (params_to_torch(host_arrays_from_graph(graph), "cpu", BF16),
            params_from_arrays(arrays, dtype=jnp.bfloat16), hp)


def _steps(got: torch.Tensor, want) -> float:
    """max |got - want| in bf16 steps at the reference's magnitude, floored
    at the step of 1/8 (near zero a step is no measure of error)."""
    w = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    step = bf16_ulp(torch.maximum(w.abs(), torch.tensor(0.125)))
    return float(((got.float() - w).abs() / step).max())


def test_bf16_encode_matches_jax_bf16(both):
    """The encode stage, bf16 both sides, injected dp noise. Measured on
    this seed: 19.75 steps on enc_hidden (0.047 max-abs), 24 on m_p, 27.1
    on logs_p, 23 on logw (0.28 max-abs; 44-66 steps on other seeds, where
    the spline flows carry the encoder's difference on). Bar 32 steps: the
    two sides already differ by 2 steps after the first attention layer
    (the per-layer trace), and every later layer adds its own roundings."""
    params, jparams, hp = both
    rng = np.random.default_rng(3)
    ids = np.asarray([FIXTURE_IDS], np.int64)
    lengths = np.asarray([ids.shape[1]], np.int64)
    dp = rng.standard_normal((1, 2, ids.shape[1])).astype(np.float32)
    x, m_p, logs_p, x_mask = vits.text_encoder(torch.from_numpy(ids), torch.from_numpy(lengths),
                                               params, hp)
    logw = vits.stochastic_duration_predictor_reverse(x, x_mask, torch.from_numpy(dp).to(BF16),
                                                      params, hp, noise_scale=0.8)
    jx, jm, jl, jmask = j_model.text_encoder(jnp.asarray(ids, jnp.int32),
                                             jnp.asarray(lengths, jnp.int32), jparams, hp)
    jlogw = j_model.stochastic_duration_predictor_reverse(
        jx, jmask, jnp.asarray(dp).astype(jnp.bfloat16), jparams, hp, noise_scale=0.8)
    for name, got, want in (("enc_hidden", x, jx), ("m_p", m_p, jm), ("logs_p", logs_p, jl),
                            ("logw", logw, jlogw)):
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16, name
        assert _steps(got, want) <= 32, (name, _steps(got, want))


def test_bf16_decode_matches_jax_bf16(both):
    """The decode stage alone on the same prior, mask and forced durations
    (noise_scale 0, so z_p is the expanded prior, exact in bf16 on both
    sides): flows and vocoder in bf16, the port's kernels' plain versions
    at "default" against JAX's XLA convs. Audio bar 5e-2 max-abs; measured
    4.4e-3 (5.9e-3 at noise_scale 0.667 and on other seeds), on audio of
    peak 0.46."""
    params, jparams, hp = both
    rng = np.random.default_rng(4)
    p, frames = 12, 64
    m_p = (rng.standard_normal((1, hp.inter_channels, p)) * 0.5).astype(np.float32)
    logs_p = (rng.standard_normal((1, hp.inter_channels, p)) * 0.1 - 0.5).astype(np.float32)
    x_mask = np.ones((1, 1, p), np.float32)
    w_ceil = rng.integers(2, 7, (1, p)).astype(np.float32)
    noise = rng.standard_normal((1, hp.inter_channels, frames)).astype(np.float32)
    enc = vits.EncodeResult(
        m_p=torch.from_numpy(m_p).to(BF16), logs_p=torch.from_numpy(logs_p).to(BF16),
        x_mask=torch.from_numpy(x_mask).to(BF16), w=torch.from_numpy(w_ceil),
        w_ceil=torch.from_numpy(w_ceil), y_total=torch.from_numpy(w_ceil.sum(-1)), g=None)
    audio, y_len = vits.decode(params, hp, enc, torch.from_numpy(noise), max_frames=frames,
                               noise_scale=0.0)
    jenc = j_model.EncodeResult(
        m_p=jnp.asarray(m_p).astype(jnp.bfloat16), logs_p=jnp.asarray(logs_p).astype(jnp.bfloat16),
        x_mask=jnp.asarray(x_mask).astype(jnp.bfloat16),
        w_ceil=jnp.asarray(w_ceil).astype(jnp.bfloat16),
        y_total=jnp.asarray(w_ceil.sum(-1)).astype(jnp.bfloat16), g=None)
    jaudio, jy = j_model.decode(jparams, hp, jenc, jnp.asarray(noise), max_frames=frames,
                                noise_scale=0.0)
    assert audio.dtype == BF16 and int(y_len[0]) == int(jy[0]) == int(w_ceil.sum())
    want = np.asarray(jnp.asarray(jaudio, jnp.float32))
    err = float(np.abs(audio.float().numpy() - want).max())
    assert err <= 5e-2, err


# -- the kernels' plain bf16 versions against JAX's Pallas kernels ---------------

def _rounded(a: np.ndarray) -> np.ndarray:
    """fp32 holding a's values rounded to bf16."""
    return torch.from_numpy(a).to(BF16).float().numpy()


def _pallas_bf16(want) -> torch.Tensor:
    return torch.from_numpy(np.array(want)).to(BF16)


def _excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """max(|got - want| - one bf16 step at the larger magnitude)."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() - bf16_ulp(torch.maximum(g.abs(), w.abs()))).max())


def test_conv1d_same_plain_bf16_matches_pallas_default():
    """K1 on bf16 (x, w, b) against pallas_conv1d_same at "default" on the
    same values: one conv, the same products summed in another order, so
    within one bf16 step after rounding (measured: 1.95e-3 max-abs, none
    past one step)."""
    rng = np.random.default_rng(11)
    c, k, d, n = 32, 7, 3, 600
    x = _rounded(rng.standard_normal((2, c, n)).astype(np.float32) * 0.5)
    w = _rounded((rng.standard_normal((c, c, k)) / np.sqrt(c * k)).astype(np.float32))
    b = _rounded((rng.standard_normal(c) * 0.02).astype(np.float32))
    got = K1.conv1d_same(*[torch.from_numpy(a).to(BF16) for a in (x, w, b)], dilation=d,
                         act_slope=0.1, precision="default")
    want = pallas_conv1d_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=d,
                              act_slope=0.1, tile=256, interpret=True, precision="default")
    assert got.dtype == BF16
    assert _excess(got, _pallas_bf16(want)) <= 0.0


def _branch_arrays(rng, c, k, m):
    w1 = (rng.standard_normal((m, c, c, k)) / np.sqrt(c * k)).astype(np.float32)
    b1 = (rng.standard_normal((m, c)) * 0.02).astype(np.float32)
    w2 = (rng.standard_normal((m, c, c, k)) / np.sqrt(c * k)).astype(np.float32)
    b2 = (rng.standard_normal((m, c)) * 0.02).astype(np.float32)
    return [_rounded(a) for a in (w1, b1, w2, b2)]


def test_resblock1_branch_plain_bf16_matches_pallas_default():
    """K2 on bf16 against pallas_resblock1_branch at "default": six chained
    convs, each input rounded to bf16 on both sides, so a rounding may flip
    and carry on (the fp32 "default" bar of test_torch_kernels.py, 2e-3),
    then one bf16 step at the output (measured: 7.8e-3 max-abs, 7.3e-4
    past one step)."""
    rng = np.random.default_rng(12)
    c, k, n = 32, 11, 500
    x = _rounded(rng.standard_normal((2, c, n)).astype(np.float32) * 0.3)
    ws = _branch_arrays(rng, c, k, 3)
    bounds = np.asarray([n, 300], np.int32)
    got = R.resblock1_branch(torch.from_numpy(x).to(BF16),
                             *[torch.from_numpy(a).to(BF16) for a in ws], kernel=k,
                             dilations=(1, 3, 5), bounds=torch.from_numpy(bounds),
                             precision="default")
    want = pallas_resblock1_branch(jnp.asarray(x), *[jnp.asarray(a) for a in ws], kernel=k,
                                   dilations=(1, 3, 5), bounds=jnp.asarray(bounds), tile=128,
                                   interpret=True, precision="default")
    assert got.dtype == BF16
    assert _excess(got, _pallas_bf16(want)) <= 2e-3


def test_resblock1_mrf_plain_bf16_matches_pallas_default():
    """K3 on bf16 against pallas_resblock1_mrf at "default": K2's bar
    (measured: 3.9e-3 max-abs, 2.4e-4 past one step)."""
    rng = np.random.default_rng(13)
    c, n = 32, 500
    x = _rounded(rng.standard_normal((2, c, n)).astype(np.float32) * 0.3)
    branches = [(*_branch_arrays(rng, c, k, 3), k, (1, 3, 5)) for k in (3, 7, 11)]
    bounds = np.asarray([[20, n], [0, 280]], np.int32)
    got = R.resblock1_mrf(torch.from_numpy(x).to(BF16),
                          [(*[torch.from_numpy(a).to(BF16) for a in br[:4]], *br[4:])
                           for br in branches],
                          bounds=torch.from_numpy(bounds), precision="default")
    want = pallas_resblock1_mrf(jnp.asarray(x),
                                [(*[jnp.asarray(a) for a in br[:4]], *br[4:]) for br in branches],
                                bounds=jnp.asarray(bounds), tile=128, interpret=True,
                                precision="default")
    assert got.dtype == BF16
    assert _excess(got, _pallas_bf16(want)) <= 2e-3


def _wrapper_case(name):
    """(wrapper, bf16 args, kwargs) of K1, K2, K3 or K4 at a tiny size."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 16, 40, generator=g).to(BF16)
    w = (torch.randn(1, 16, 16, 3, generator=g) * 0.1).to(BF16)
    b = torch.zeros(1, 16, dtype=BF16)
    if name == "conv1d_same":
        return K1.conv1d_same, (x, w[0], b[0]), dict(dilation=1, act_slope=0.1)
    if name == "resblock1_branch":
        return R.resblock1_branch, (x, w, b, w, b), dict(kernel=3, dilations=(1,))
    if name == "resblock1_mrf":
        return R.resblock1_mrf, (x, [(w, b, w, b, 3, (1,))]), {}
    return K4.resblock1_mrf_folded, (x, [(w, b, w, b, 3, (1,))]), {}


@pytest.mark.parametrize("name", ["conv1d_same", "resblock1_branch", "resblock1_mrf"])
@pytest.mark.parametrize("tier", ["highest", "high", None])
def test_wrappers_refuse_bf16_at_other_tiers(name, tier):
    """bf16 activations run at "default" only: any other tier raises with
    the reason, on every device (here the CPU's plain version), and so do
    fp32 weights beside bf16 activations; "default" and "bfloat16" run."""
    fn, args, kw = _wrapper_case(name)
    with pytest.raises(ValueError, match="'default' tier only"):
        fn(*args, precision=tier, **kw)
    for ok in ("default", "bfloat16"):
        assert fn(*args, precision=ok, **kw).dtype == BF16
    if name == "conv1d_same":
        with pytest.raises(ValueError, match="activations' dtype"):
            fn(args[0], args[1].float(), None, precision="default", **kw)


def test_folded_kernel_keeps_fp32():
    """K4 runs only in the folded-kernel probe and keeps fp32 activations."""
    fn, args, kw = _wrapper_case("resblock1_mrf_folded")
    with pytest.raises(ValueError, match="float32 activations only"):
        fn(*args, precision="default", **kw)
