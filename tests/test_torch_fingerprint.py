"""The port's fingerprint tool (piper_tpu_torch/tools/fingerprint_onnx.py)
against the JAX package's tools/fingerprint_onnx.py, on the CPU: the same
dict for a synthetic voice's .onnx, single- and multi-speaker."""

import importlib.util
import json
from pathlib import Path

import pytest

from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice
from piper_tpu_torch.tools import fingerprint_onnx

ROOT = Path(__file__).resolve().parent.parent


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_fingerprint_onnx",
                                                  ROOT / "tools" / "fingerprint_onnx.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("speakers", [{}, {"n_speakers": 3, "gin_channels": 8}],
                         ids=["single", "multi"])
def test_fingerprint_equals_the_jax_tools(tmp_path, speakers):
    model, _ = make_synthetic_voice(tmp_path / "v", quality="test", seed=2, **speakers)
    got = fingerprint_onnx.fingerprint(model)
    want = _jax_tool().fingerprint(model)
    assert got == want
    assert got["facts"]["node_count"] > 0 and got["node_histogram"]
    assert ("sid" in got["facts"]["graph_inputs"]) == bool(speakers)


def test_fingerprint_cli_prints_the_dict(tmp_path, capsys):
    model, _ = make_synthetic_voice(tmp_path / "v", quality="test", seed=3)
    fp = fingerprint_onnx.main([str(model), "--compact"])
    assert json.loads(capsys.readouterr().out) == fp
    assert fp["file"] == str(model)
