"""The port's per-layer debug trace against the JAX package's.

`debug_infer(per_layer=True)` records one tensor per conv, flow step and
attention layer under its checkpoint parameter path (utils/debug_trace.py,
a byte copy of the JAX package's). Here the port and `piper_tpu` run the
same weights and injected noise at the hparams of tests/test_debug_trace.py
on the CPU: the same keys in the same order, each within the module bar,
2e-5 max-abs (5e-5 on logw, which the spline flows' divisions amplify), and
w_ceil equal; then the JAX test's three injected perturbations bisect to the
same first divergent layer in the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime
from piper_tpu.models.vits.model import debug_infer as j_debug_infer
from piper_tpu.models.vits.params import params_from_arrays
from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine.runtime import PiperRuntime
from piper_tpu_torch.models.vits import hifigan
from piper_tpu_torch.models.vits.hparams import VitsHParams
from piper_tpu_torch.models.vits.model import debug_infer
from piper_tpu_torch.models.vits.synthetic import synthetic_params
from piper_tpu_torch.ops.kernels import resblock as R
from piper_tpu_torch.utils import debug_trace

HP = VitsHParams(
    n_vocab=40,
    inter_channels=16,
    hidden_channels=16,
    filter_channels=32,
    n_heads=2,
    n_layers=2,
    dp_filter_channels=16,
    dp_n_flows=2,
    flow_n_flows=2,
    flow_hidden_channels=16,
    flow_n_layers=2,
    resblock_kernel_sizes=[3],
    resblock_dilation_sizes=[[1, 2]],
    upsample_rates=[4, 2],
    upsample_initial_channel=32,
    upsample_kernel_sizes=[8, 4],
)

MODULE_KEYS = [
    "enc_hidden", "m_p", "logs_p", "x_mask", "logw", "w_ceil", "y_lengths",
    "y_mask", "path", "m_p_expanded", "logs_p_expanded", "z_p", "z", "audio",
]
ATOL = 2e-5
ATOL_LOGW = 5e-5


def _inputs(max_frames=16):
    rng = np.random.default_rng(0)
    b, p = 1, 12
    ids = rng.integers(0, HP.n_vocab, size=(b, p))
    dp = rng.standard_normal((b, 2, p)).astype(np.float32)
    mn = rng.standard_normal((b, HP.inter_channels, max_frames)).astype(np.float32)
    return ids, np.asarray([p]), dp, mn


def _port(weights, per_layer=True, max_frames=16):
    ids, lengths, dp, mn = _inputs(max_frames)
    params = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in weights.items()}
    out = debug_infer(params, HP, torch.from_numpy(ids), torch.from_numpy(lengths),
                      torch.from_numpy(dp), torch.from_numpy(mn), max_frames=max_frames,
                      per_layer=per_layer)
    return {k: v.numpy() for k, v in out.items()}


def _jax(weights, per_layer=True, max_frames=16):
    ids, lengths, dp, mn = _inputs(max_frames)
    out = j_debug_infer(params_from_arrays(weights), HP, jnp.asarray(ids, jnp.int32),
                        jnp.asarray(lengths, jnp.int32), jnp.asarray(dp), jnp.asarray(mn),
                        max_frames=max_frames, per_layer=per_layer)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_parity(got: dict, want: dict, ordered: bool = True):
    """The same keys (in the same order where `ordered`); w_ceil equal;
    every tensor within the module bar (logw's own)."""
    assert list(got) == list(want) if ordered else sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["w_ceil"], want["w_ceil"])
    worst = {}
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        worst[k] = float(np.abs(g.astype(np.float32) - w.astype(np.float32)).max())
        assert worst[k] <= (ATOL_LOGW if k == "logw" else ATOL), (k, worst[k])
    return worst


def test_per_layer_trace_matches_jax_keys_order_and_values():
    weights = synthetic_params(HP, seed=7)
    got, want = _port(weights), _jax(weights)
    _assert_parity(got, want)
    layer_keys = [k for k in got if k not in MODULE_KEYS]
    for prefix in ("enc_p.encoder.attn_layers.", "dp.flows.", "flow.flows.", "dec.resblocks.",
                   "dec.ups.", "dec.conv_pre", "dec.conv_post"):
        assert any(k.startswith(prefix) for k in layer_keys), prefix


def test_per_layer_false_keeps_exactly_the_module_keys():
    weights = synthetic_params(HP, seed=7)
    assert list(_port(weights, per_layer=False)) == MODULE_KEYS
    assert not debug_trace.tracing()


def test_collector_detaches_after_a_raise():
    """A missing parameter raises inside the traced body: the collector is
    detached all the same, so later calls trace nothing."""
    weights = synthetic_params(HP, seed=7)
    del weights["flow.flows.0.post.weight"]
    with pytest.raises(KeyError, match="flow.flows.0.post.weight"):
        _port(weights)
    assert not debug_trace.tracing()
    box = {}
    debug_trace.trace_put("x", 1)
    with debug_trace.collecting(box):
        debug_trace.trace_put("y", 2)
    assert box == {"y": 2} and not debug_trace.tracing()


@pytest.mark.parametrize(
    "weight,expected_first",
    [
        ("flow.flows.2.enc.in_layers.1.weight", "flow.flows.2.enc.in_layers.1"),
        ("enc_p.encoder.ffn_layers.1.conv_1.weight", "enc_p.encoder.ffn_layers.1"),
        ("dec.resblocks.1.convs1.0.weight", "dec.resblocks.1.convs1.0"),
    ],
)
def test_bisects_injected_perturbation(weight, expected_first):
    """tests/test_debug_trace.py's three perturbations: the first divergent
    trace entry, in execution order, is the layer that owns the weight."""
    weights = synthetic_params(HP, seed=7)
    dirty = dict(weights)
    dirty[weight] = dirty[weight] + 0.05 * np.ones_like(dirty[weight])
    clean, bad = _port(weights), _port(dirty)
    first = next((k for k in clean if k not in MODULE_KEYS
                  and not np.allclose(clean[k], bad[k])), None)
    assert first == expected_first


def test_tracing_keeps_the_per_branch_kernels(monkeypatch):
    """With bounds, a level of at most 32 channels takes the whole-MRF
    kernel; while a trace collects it takes one branch kernel per branch,
    so each branch's output is recorded (the JAX package's rule). HP's
    second level (C=8, a width the K2/K3 stage refuses) runs its two
    dilations' four convs through K1 either way."""
    weights = synthetic_params(HP, seed=7)
    params = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in weights.items()}
    z = torch.randn(1, HP.inter_channels, 10, generator=torch.Generator().manual_seed(0))
    calls = []
    monkeypatch.setattr(hifigan, "resblock1_mrf",
                        lambda *a, **k: calls.append("mrf") or R.resblock1_mrf(*a, **k))
    monkeypatch.setattr(hifigan, "resblock1_branch",
                        lambda *a, **k: calls.append("branch") or R.resblock1_branch(*a, **k))
    conv = hifigan.K1.conv1d_same
    monkeypatch.setattr(hifigan.K1, "conv1d_same",
                        lambda *a, **k: calls.append("k1") or conv(*a, **k))
    bounds = torch.tensor([10])
    plain = hifigan.hifigan_generator(z, params, HP, t_bounds=bounds)
    assert calls == ["mrf"] + ["k1"] * 4
    calls.clear()
    trace = {}
    with debug_trace.collecting(trace):
        traced = hifigan.hifigan_generator(z, params, HP, t_bounds=bounds)
    assert calls == ["branch"] + ["k1"] * 4
    assert ["dec.resblocks.0", "dec.resblocks.1"] == [k for k in trace if "resblocks" in k]
    torch.testing.assert_close(traced, plain, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def runtimes(tiny_voice):
    return PiperRuntime(*tiny_voice, device="cpu"), JaxRuntime(*tiny_voice)


def test_synthesize_debug_matches_jax(runtimes):
    """One voice, one seed: the same noise from default_rng(seed), the same
    bucket and scales, every key within the parity bars (the JAX runtime's
    jitted dict comes back with its keys sorted; the port keeps
    debug_infer's execution order, which the first test holds to JAX's);
    and test_observability.py::test_debug_intermediates' shape checks."""
    rt, jrt = runtimes
    got = rt.synthesize_debug(FIXTURE_IDS, max_frames=64, seed=3, per_layer=True)
    want = jrt.synthesize_debug(FIXTURE_IDS, max_frames=64, seed=3, per_layer=True)
    _assert_parity(got, want, ordered=False)
    out = rt.synthesize_debug(FIXTURE_IDS, max_frames=64)
    hp = rt.hparams
    p_bucket = 16
    assert list(out) == MODULE_KEYS
    assert out["enc_hidden"].shape == (1, hp.hidden_channels, p_bucket)
    assert out["m_p"].shape == (1, hp.inter_channels, p_bucket)
    assert out["logw"].shape == (1, 1, p_bucket)
    assert out["path"].shape == (1, 64, p_bucket)
    assert out["z"].shape == (1, hp.inter_channels, 64)
    assert out["audio"].shape == (1, 64 * hp.hop_length)
    assert all(np.isfinite(v).all() for v in out.values())
    valid = int(out["y_lengths"][0])
    assert (out["path"][0, :valid].sum(-1) == 1).all()


def test_synthesize_debug_runs_at_the_bf16_tier(tiny_voice):
    """The "bfloat16" mode's debug run: bf16 inside, float32 numpy out,
    the same keys."""
    from piper_tpu_torch.engine.runtime import RuntimeOptions

    rt = PiperRuntime(*tiny_voice, RuntimeOptions(precision="bfloat16"), device="cpu")
    out = rt.synthesize_debug(FIXTURE_IDS, max_frames=64, per_layer=True)
    assert list(out)[-len(MODULE_KEYS):] == MODULE_KEYS
    assert all(v.dtype == np.float32 and np.isfinite(v).all() for v in out.values())
