"""The port's weight loading and PiperRuntime against the JAX package.

Synthesis is compared with injected noise (the port's seeded noise differs
from JAX's threefry by design) at the fp32 waveform bar, 1e-4 max-abs; in
int16 that bar is 1e-4 * 32767 plus one truncation step, 4 LSB.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from piper_tpu.models.vits.params import host_arrays_from_graph as j_host_arrays
from piper_tpu.models.vits.synthetic import synthetic_params
from piper_tpu.models.vits.hparams import PRESETS
from piper_tpu.onnx.loader import load_model
from piper_tpu.onnx.writer import node, save_model, tensor_from_array
from piper_tpu_torch.engine.runtime import (
    PiperRuntime,
    RuntimeOptions,
    fp32_exact,
    seeded_noise,
)
from piper_tpu_torch.models.vits.params import host_arrays_from_graph, params_to_torch

ROOT = Path(__file__).resolve().parent.parent
IDS = [1, 20, 0, 12, 0, 31, 0, 24, 0, 19, 0, 10, 0, 2]


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        got_k = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert got_k.shape == want[k].shape, k
        np.testing.assert_array_equal(got_k, np.asarray(want[k], np.float32), err_msg=k)


def test_weights_match_reference_loader(tiny_voice):
    graph = load_model(tiny_voice[0]).graph
    want = j_host_arrays(graph)
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
    graph = load_model(path).graph
    got = host_arrays_from_graph(graph)
    assert set(moved) <= set(got) and "/Constant_output_0" not in got
    assert "shape_const" not in got
    _assert_same_arrays(got, j_host_arrays(graph))


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


def test_seeded_synthesis_is_deterministic(port_rt):
    a = port_rt.synthesize(IDS, seed=7)
    b = port_rt.synthesize(IDS, seed=7)
    c = port_rt.synthesize(IDS, seed=8)
    assert np.array_equal(a, b)
    assert a.shape != c.shape or not np.array_equal(a, c)
    assert np.isfinite(a).all()


def test_seeded_noise_is_row_invariant():
    """Every row gets the same draw, equal to the single-row draw, and the
    two streams of one seed differ."""
    one = seeded_noise(5, 1, (4, 9), 1, "cpu")
    three = seeded_noise(5, 1, (4, 9), 3, "cpu")
    assert three.shape == (3, 4, 9)
    for r in range(3):
        assert torch.equal(three[r], one[0])
    assert not torch.equal(seeded_noise(5, 0, (4, 9), 1, "cpu"), one)


@pytest.mark.parametrize("field,value", [
    ("precision", "high"), ("precision", "bfloat16"), ("vocoder_precision", "default"),
    ("flow_precision", "high"), ("mode", "fused"), ("output_dtype", "float16"),
])
def test_unported_options_raise(tiny_voice, field, value):
    with pytest.raises(ValueError, match="later change" if field != "output_dtype" else "int16"):
        PiperRuntime(*tiny_voice, RuntimeOptions(**{field: value}), device="cpu")


def test_cuda_device_without_a_card_raises(tiny_voice):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PiperRuntime(*tiny_voice, device="cuda")


def test_fp32_exact_restores_tf32_flags():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with fp32_exact():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == saved


def test_port_never_imports_jax(tiny_voice):
    code = (
        "import sys\n"
        "import piper_tpu_torch\n"
        "from piper_tpu_torch import PiperRuntime\n"
        f"rt = PiperRuntime({str(tiny_voice[0])!r}, {str(tiny_voice[1])!r}, device='cpu')\n"
        f"pcm = rt.synthesize({IDS!r})\n"
        "assert len(pcm) > 0\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
