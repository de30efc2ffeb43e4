"""The port's weight loading and PiperRuntime against the JAX package.

Synthesis is compared with injected noise (seeded synthesis, which draws
JAX's threefry noise, is held to JAX's in tests/test_torch_prng.py) at the
fp32 waveform bar, 1e-4 max-abs; in
int16 that bar is 1e-4 * 32767 plus one truncation step, 4 LSB. The bench's
mixed-precision configuration is held to the same fp32 bar: its kernel
tiers change only the order of exact products' sums (test_torch_kernels.py).
"""

import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from piper_tpu.models.vits.params import host_arrays_from_graph as j_host_arrays
from piper_tpu.onnx.loader import load_model as j_load_model
from piper_tpu_torch.engine.runtime import (
    PiperRuntime,
    RuntimeOptions,
    parse_precision_spec,
    seeded_noise,
)
from piper_tpu_torch.models.vits.hparams import PRESETS
from piper_tpu_torch.models.vits.params import host_arrays_from_graph, params_to_torch
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice, synthetic_params
from piper_tpu_torch.onnx.loader import load_model
from piper_tpu_torch.onnx.writer import node, save_model, tensor_from_array
from piper_tpu_torch.ops.kernels import resblock as R
from piper_tpu_torch.ops.kernels.precision import fp32_exact, tier_scope

ROOT = Path(__file__).resolve().parent.parent
IDS = [1, 20, 0, 12, 0, 31, 0, 24, 0, 19, 0, 10, 0, 2]


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        got_k = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert got_k.shape == want[k].shape, k
        np.testing.assert_array_equal(got_k, np.asarray(want[k], np.float32), err_msg=k)


def test_weights_match_reference_loader(tiny_voice):
    want = j_host_arrays(j_load_model(tiny_voice[0]).graph)
    graph = load_model(tiny_voice[0]).graph
    _assert_same_arrays(host_arrays_from_graph(graph), want)
    _assert_same_arrays(params_to_torch(host_arrays_from_graph(graph), "cpu"), want)


def test_constant_node_weights_are_harvested(tmp_path):
    """Parameters a real export folds into Constant nodes are weights too;
    Constants with non-parameter names and integer tensors are not."""
    w = synthetic_params(PRESETS["test"], seed=1)
    moved = ["enc_p.encoder.norm_layers_1.0.gamma", "dp.flows.0.logs"]
    nodes = [node("Constant", [], [k], value=tensor_from_array(k, w.pop(k))) for k in moved]
    nodes.append(node("Constant", [], ["/Constant_output_0"],
                      value=tensor_from_array("/Constant_output_0", np.ones(3, np.float32))))
    w["shape_const"] = np.array([1, 2], np.int64)
    path = tmp_path / "m.onnx"
    save_model(str(path), nodes, w)
    got = host_arrays_from_graph(load_model(path).graph)
    assert set(moved) <= set(got) and "/Constant_output_0" not in got
    assert "shape_const" not in got
    _assert_same_arrays(got, j_host_arrays(j_load_model(path).graph))


@pytest.fixture(scope="module")
def port_rt(tiny_voice):
    return PiperRuntime(*tiny_voice, device="cpu")


def _noise(rt, frames=40, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, len(IDS))).astype(np.float32),
            rng.standard_normal((rt.hparams.inter_channels, frames)).astype(np.float32))


def test_synthesize_matches_reference_fp32(port_rt, tiny_runtime):
    dp_noise, main_noise = _noise(port_rt)
    got = port_rt.synthesize(IDS, dp_noise=dp_noise, main_noise=main_noise)
    want = tiny_runtime.synthesize(IDS, dp_noise=dp_noise, main_noise=main_noise)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    t = port_rt.last_run_timings
    assert t.samples == len(got) == t.frames * port_rt.hparams.hop_length
    assert t.phoneme_bucket == 16 and t.frame_bucket >= t.frames


def test_synthesize_matches_reference_int16(tiny_voice, tiny_runtime):
    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime
    from piper_tpu.engine.runtime import RuntimeOptions as JaxOptions

    rt = PiperRuntime(*tiny_voice, RuntimeOptions(output_dtype="int16"), device="cpu")
    ref = JaxRuntime(*tiny_voice, JaxOptions(output_dtype="int16"))
    dp_noise, main_noise = _noise(rt, seed=1)
    got = rt.synthesize(IDS, dp_noise=dp_noise, main_noise=main_noise)
    want = ref.synthesize(IDS, dp_noise=dp_noise, main_noise=main_noise)
    assert got.dtype == np.int16 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 4


@pytest.fixture(scope="module")
def x_low_voice(tmp_path_factory):
    """A synthetic x_low voice: ResBlock2 vocoder (256 -> 128/64/32), 16 kHz,
    hop 256; the narrow levels run conv1d_same."""
    return make_synthetic_voice(tmp_path_factory.mktemp("x_low"), quality="x_low", seed=0)


@pytest.mark.parametrize("output_dtype", ["float32", "int16"])
def test_x_low_synthesize_matches_reference(x_low_voice, output_dtype):
    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime
    from piper_tpu.engine.runtime import RuntimeOptions as JaxOptions

    rt = PiperRuntime(*x_low_voice, RuntimeOptions(output_dtype=output_dtype), device="cpu")
    ref = JaxRuntime(*x_low_voice, JaxOptions(output_dtype=output_dtype))
    dp_noise, main_noise = _noise(rt, seed=2)
    got = rt.synthesize(IDS, dp_noise=dp_noise, main_noise=main_noise)
    want = ref.synthesize(IDS, dp_noise=dp_noise, main_noise=main_noise)
    assert got.dtype == want.dtype == np.dtype(output_dtype) and got.shape == want.shape
    if output_dtype == "int16":
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 4
        return
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    hp, t = rt.hparams, rt.last_run_timings
    assert (hp.resblock, hp.hop_length, rt.sample_rate) == ("2", 256, 16000)
    assert t.samples == len(got) == t.frames * 256 and t.frame_bucket >= t.frames
    assert t.rtf == pytest.approx(t.samples / 16000 / (t.wall_ms / 1e3))


def test_seeded_synthesis_is_deterministic(port_rt):
    a = port_rt.synthesize(IDS, seed=7)
    b = port_rt.synthesize(IDS, seed=7)
    c = port_rt.synthesize(IDS, seed=8)
    assert np.array_equal(a, b)
    assert a.shape != c.shape or not np.array_equal(a, c)
    assert np.isfinite(a).all()


def test_synthesize_takes_the_reference_parameters():
    """The same parameter names, kinds and defaults in the same order as the
    JAX package's PiperRuntime.synthesize, so a positional call means the
    same in both."""
    import inspect

    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime

    def params(fn):
        return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]

    assert params(PiperRuntime.synthesize) == params(JaxRuntime.synthesize)


def test_speaker_arguments_on_a_single_speaker_voice(port_rt, tiny_runtime):
    """speaker_id (fifth) is ignored by a single-speaker voice, as in the JAX
    package; a speaker mix raises the JAX package's ValueError (it needs a
    multi-speaker voice), and so do both at once."""
    a = port_rt.synthesize(IDS, None, None, None, 3, 7)
    assert np.array_equal(a, port_rt.synthesize(IDS, seed=7))
    for rt in (port_rt, tiny_runtime):
        with pytest.raises(ValueError, match="speaker_mix requires a multi-speaker voice"):
            rt.synthesize(IDS, speaker_mix={0: 1.0})
        with pytest.raises(ValueError, match="pass speaker_id OR speaker_mix, not both"):
            rt.synthesize(IDS, speaker_id=0, speaker_mix={0: 1.0})


def test_seeded_noise_is_row_invariant():
    """Every row gets the same draw, equal to the single-row draw, and the
    two streams of one seed differ."""
    one = seeded_noise(5, 1, (4, 9), 1, "cpu")
    three = seeded_noise(5, 1, (4, 9), 3, "cpu")
    assert three.shape == (3, 4, 9)
    for r in range(3):
        assert torch.equal(three[r], one[0])
    assert not torch.equal(seeded_noise(5, 0, (4, 9), 1, "cpu"), one)


@pytest.mark.parametrize("field,value,match", [
    ("vocoder_precision", "high", "under precision 'bfloat16'"),
    ("precision", "float16", "the tiers are"),
    ("vocoder_precision", ("high", None, "high"), "3 per-level entries but this voice has 2"),
    ("flow_precision", "tensorfloat32", "flow_precision 'tensorfloat32': the tiers are"),
    ("mode", "pipelined", "the modes are"),
    ("output_dtype", "float16", "int16"),
])
def test_unported_options_raise(tiny_voice, field, value, match):
    base = {"precision": "bfloat16"} if match.startswith("under") else {}
    with pytest.raises(ValueError, match=match):
        PiperRuntime(*tiny_voice, RuntimeOptions(**base, **{field: value}), device="cpu")


def test_precision_options_accept_the_tiers():
    for opts in (dict(precision="high"), dict(precision="default"),
                 dict(vocoder_precision=("default", None)), dict(vocoder_precision="bfloat16"),
                 dict(flow_precision="high", vocoder_precision="high")):
        RuntimeOptions(**opts).validate()


@pytest.mark.parametrize("spec", [None, "", "none", "high", " high , none,default ", "a,,b"])
def test_parse_precision_spec_matches_reference(spec):
    from piper_tpu.engine.runtime import parse_precision_spec as j_parse

    assert parse_precision_spec(spec) == j_parse(spec)


def test_cuda_device_without_a_card_raises(tiny_voice):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PiperRuntime(*tiny_voice, device="cuda")


def test_default_device_is_the_card(tiny_voice):
    """With no device named the runtime runs on the card, and raises where
    there is none; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PiperRuntime(*tiny_voice)


def test_fp32_exact_restores_tf32_flags():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with fp32_exact():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == saved


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()


def test_tier_scope_sets_the_card_flags_and_restores_them():
    """On a CUDA device: TF32 for cuDNN at "default" only (fp32 convs at
    "high", as near the reference's 3-pass "high" as the card's convs
    come), the matmul precision of JAX's tier names; None inherits; on the
    CPU nothing changes. Setting the flags needs no card."""
    saved = _flags()
    with fp32_exact():
        for tier, want in (("highest", (False, "highest")), ("high", (False, "high")),
                           ("default", (True, "medium")), ("bfloat16", (True, "medium"))):
            with tier_scope(tier, "cuda"):
                assert _flags() == want
                with tier_scope(None, "cuda"), tier_scope("high", "cpu"):
                    assert _flags() == want
            assert _flags() == (False, "highest")
    assert _flags() == saved
    with pytest.raises(ValueError, match="tiers"):
        tier_scope("float32", "cpu")


@pytest.fixture(scope="module")
def k2k3_voice(tmp_path_factory):
    """The tiny test voice with a 128-channel vocoder: level 0 (C=64) runs
    the branch kernel K2, level 1 (C=32) the MRF kernel K3."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(PRESETS, "k2k3", replace(PRESETS["test"], upsample_initial_channel=128))
        return make_synthetic_voice(tmp_path_factory.mktemp("k2k3"), quality="k2k3", seed=0)


BENCH_MIX = dict(precision="highest", vocoder_precision="high", flow_precision="high")


def test_bench_mixed_precision_matches_reference(k2k3_voice, monkeypatch):
    """bench.py's default configuration (encoder at "highest", vocoder and
    flows at "high") against the JAX runtime with the same options and its
    Pallas kernels in interpret mode: w_ceil equal, waveform within 1e-4,
    and the port's K2/K3 called at the "high" tier."""
    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime
    from piper_tpu.engine.runtime import RuntimeOptions as JaxOptions
    from piper_tpu.models.vits import model as jv
    from piper_tpu.models.vits.params import params_from_arrays
    from piper_tpu_torch.models.vits import model as tv

    monkeypatch.setenv("PIPER_TPU_PALLAS_INTERPRET", "1")
    tiers = []
    for name in ("resblock1_branch_plain", "resblock1_mrf_plain"):
        def spy(*args, _fn=getattr(R, name), _name=name, **kw):
            tiers.append((_name, kw["precision"]))
            return _fn(*args, **kw)
        monkeypatch.setattr(R, name, spy)

    rt = PiperRuntime(*k2k3_voice, RuntimeOptions(**BENCH_MIX), device="cpu")
    ref = JaxRuntime(*k2k3_voice, JaxOptions(**BENCH_MIX, use_pallas=True))
    dp_noise, main_noise = _noise(rt, seed=3)
    got = rt.synthesize(IDS, dp_noise=dp_noise, main_noise=main_noise)
    want = ref.synthesize(IDS, dp_noise=dp_noise, main_noise=main_noise)
    assert set(tiers) == {("resblock1_branch_plain", "high"), ("resblock1_mrf_plain", "high")}
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    ids = np.zeros((1, 16), np.int64)
    ids[0, : len(IDS)] = IDS
    dpn = np.zeros((1, 2, 16), np.float32)
    dpn[0, :, : len(IDS)] = dp_noise
    jp = params_from_arrays(j_host_arrays(j_load_model(k2k3_voice[0]).graph))
    j_enc = jv.encode(jp, ref.hparams, ids.astype(np.int32), np.array([len(IDS)], np.int32),
                      dpn)
    with torch.inference_mode():
        t_enc = tv.encode(rt.params, rt.hparams, torch.from_numpy(ids), torch.tensor([len(IDS)]),
                          torch.from_numpy(dpn))
    np.testing.assert_array_equal(t_enc.w_ceil.numpy(), np.asarray(j_enc.w_ceil))


def test_port_never_imports_jax(tiny_voice):
    code = (
        "import sys\n"
        "import piper_tpu_torch\n"
        "from piper_tpu_torch import PiperRuntime\n"
        f"rt = PiperRuntime({str(tiny_voice[0])!r}, {str(tiny_voice[1])!r}, device='cpu')\n"
        f"pcm = rt.synthesize({IDS!r})\n"
        "assert len(pcm) > 0\n"
        "import piper_tpu_torch.bench, piper_tpu_torch.golden\n"
        "from piper_tpu_torch.engine.pipeline import ServingPipeline\n"
        f"batch = rt.synthesize_batch([{IDS!r}, {IDS[:8]!r}])\n"
        "assert len(batch) == 2 and all(len(a) > 0 for a in batch)\n"
        "with ServingPipeline(rt) as pipe:\n"
        f"    assert len(pipe.submit_batch([{IDS!r}]).result()[0]) > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'piper_tpu'))\n"
        "assert not bad, f'imported {bad}'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
