"""The port's native C++ ONNX parser and externalize_random.

Counterparts of tests/test_native_parser.py, test_parser_scale.py and
test_rewrite.py on the port's copies: piper_tpu_torch/native/onnx_parser.cpp
(byte-equal to the JAX package's), its g++ build into build/piper_tpu_torch/
and the ctypes binding onnx/native.py, against the port's pure-Python
decoder and the JAX package's loaders. Unlike the JAX package's, a build
that fails raises, and load_model passes the error on.
"""

import time
from pathlib import Path

import numpy as np
import pytest

from piper_tpu.onnx.loader import load_model as j_load_model
from piper_tpu.onnx.rewrite import externalize_random as j_externalize_random
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice
from piper_tpu_torch.native import build as nbuild
from piper_tpu_torch.onnx import native
from piper_tpu_torch.onnx.ir import OnnxValueInfo, TensorDataType
from piper_tpu_torch.onnx.loader import _load_model_python, load_model
from piper_tpu_torch.onnx.native import load_model_native, native_available
from piper_tpu_torch.onnx.rewrite import externalize_random
from piper_tpu_torch.onnx.writer import node, save_model, save_model_ir

ROOT = Path(__file__).resolve().parent.parent
N_NODES = 2755
N_INITS = 401


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_voice")
    model, _ = make_synthetic_voice(d, quality="test", seed=9)
    return model


def _same_model(m_nat, m_py):
    assert m_nat.opset_version == m_py.opset_version
    assert m_nat.ir_version == m_py.ir_version
    assert m_nat.producer_name == m_py.producer_name
    assert m_nat.graph.name == m_py.graph.name
    assert len(m_nat.graph.nodes) == len(m_py.graph.nodes)
    assert set(m_nat.graph.initializers) == set(m_py.graph.initializers)
    for name, t_py in m_py.graph.initializers.items():
        t_nat = m_nat.graph.initializers[name]
        assert t_nat.dims == t_py.dims and t_nat.data_type == t_py.data_type
        np.testing.assert_array_equal(np.asarray(t_nat.array), np.asarray(t_py.array))
    for n_nat, n_py in zip(m_nat.graph.nodes, m_py.graph.nodes):
        assert (n_nat.op_type, n_nat.inputs, n_nat.outputs, n_nat.name) == \
            (n_py.op_type, n_py.inputs, n_py.outputs, n_py.name)
        assert set(n_nat.attributes) == set(n_py.attributes)
        for k, a in n_py.attributes.items():
            if a.type == 7:  # INTS
                assert n_nat.attr_ints(k) == n_py.attr_ints(k)
    for side in ("inputs", "outputs"):
        assert [(v.name, v.shape) for v in getattr(m_nat.graph, side)] == \
            [(v.name, v.shape) for v in getattr(m_py.graph, side)]


def test_parser_source_is_the_jax_packages():
    """The C++ source is a byte-equal copy (it holds no JAX)."""
    ours = (ROOT / "piper_tpu_torch" / "native" / "onnx_parser.cpp").read_bytes()
    assert ours == (ROOT / "piper_tpu" / "native" / "onnx_parser.cpp").read_bytes()


def test_native_matches_python(voice):
    assert native_available()
    m_nat = load_model_native(voice)
    assert m_nat is not None
    _same_model(m_nat, _load_model_python(voice))
    # ...and the JAX package's loader, node for node.
    _same_model(m_nat, j_load_model(voice))


def test_native_is_default_path(voice):
    m = load_model(voice)
    # Zero-copy mapping: views into the file's bytes (read-only).
    some = next(iter(m.graph.initializers.values()))
    assert not some.array.flags.writeable
    _same_model(m, load_model(voice, prefer_native=False))


def test_native_rejects_garbage():
    assert load_model_native(b"\xff" * 64) is None


def test_native_speedup(voice):
    data = voice.read_bytes()
    t_py = min(_timed(_load_model_python, data) for _ in range(3))
    t_nat = min(_timed(load_model_native, data) for _ in range(3))
    assert t_nat <= t_py * 2.5, (t_nat, t_py)


def _timed(fn, data) -> float:
    t0 = time.perf_counter()
    fn(data)
    return time.perf_counter() - t0


def test_failed_build_raises(monkeypatch, tmp_path, voice):
    """No compiler: the build raises, native_available says False, and
    load_model passes the error on instead of decoding in Python."""
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nbuild, "COMPILER", "no-such-c++-compiler")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(nbuild.NativeBuildError, match="not found"):
        nbuild.build_library(["onnx_parser.cpp"], "libpiper_onnx")
    assert not native_available()
    with pytest.raises(nbuild.NativeBuildError):
        load_model(voice)
    monkeypatch.setenv("PIPER_TPU_NO_NATIVE", "1")
    assert load_model(voice).graph.nodes  # the kill switch takes Python alone


def test_failed_compile_raises(monkeypatch, tmp_path):
    """A compiler that fails (here: on a source that does not compile)
    raises with its output, and leaves no library behind."""
    src = tmp_path / "bad.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(nbuild, "SRC_DIR", tmp_path)
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(nbuild.NativeBuildError, match="failed"):
        nbuild.build_library(["bad.cpp"], "libbad")
    assert not list((tmp_path / "build").glob("*.so"))


# -- test_parser_scale.py -------------------------------------------------


@pytest.fixture(scope="module")
def big_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("parser_scale")
    rng = np.random.default_rng(0)
    inits = {}
    for i in range(N_INITS - 1):
        ch = int(rng.integers(16, 256))
        inits[f"layer.{i}.weight"] = rng.standard_normal((ch, 192, 3)).astype(np.float32)
    inits["sid"] = np.array([0], dtype=np.int64)
    nodes = [node("Gather", ["emb", "input"], ["n0_out"], axis=0)]
    ops = ["Conv", "Add", "Mul", "Relu", "Transpose", "Reshape", "Slice", "Concat",
           "Softmax", "MatMul"]
    for i in range(1, N_NODES):
        op = ops[i % len(ops)]
        attrs = {}
        if op == "Conv":
            attrs = dict(dilations=[1], strides=[1], pads=[1, 1], group=1, kernel_shape=[3])
        elif op == "Transpose":
            attrs = dict(perm=[0, 2, 1])
        elif op == "Softmax":
            attrs = dict(axis=-1)
        nodes.append(node(op, [f"n{i-1}_out", f"layer.{i % (N_INITS-1)}.weight"],
                          [f"n{i}_out"], name=f"node_{i}", **attrs))
    p = d / "big.onnx"
    save_model(str(p), nodes, inits,
               inputs=[OnnxValueInfo("input", TensorDataType.INT64, [1, "P"]),
                       OnnxValueInfo("input_lengths", TensorDataType.INT64, [1]),
                       OnnxValueInfo("scales", TensorDataType.FLOAT, [3])],
               outputs=[OnnxValueInfo("output", TensorDataType.FLOAT, [1, 1, 1, "T"])],
               opset=15)
    return p


def test_golden_counts_python(big_model):
    m = _load_model_python(big_model)
    assert m.opset_version == 15
    assert len(m.graph.nodes) == N_NODES and len(m.graph.initializers) == N_INITS
    assert "sid" in m.graph.initializers
    assert m.graph.nodes[0].op_type == "Gather"
    assert [v.name for v in m.graph.inputs] == ["input", "input_lengths", "scales"]
    assert m.graph.outputs[0].name == "output"


def test_golden_counts_native_and_speed(big_model):
    def best_of(f, n=3):
        best, result = float("inf"), None
        for _ in range(n):
            t0 = time.perf_counter()
            result = f()
            best = min(best, time.perf_counter() - t0)
        return result, best

    m, t_native = best_of(lambda: load_model_native(big_model))
    assert m is not None
    assert len(m.graph.nodes) == N_NODES and len(m.graph.initializers) == N_INITS
    m_py, t_py = best_of(lambda: _load_model_python(big_model))
    _same_model(m, m_py)
    assert t_native < t_py * 3.0, (t_native, t_py)


# -- test_rewrite.py ------------------------------------------------------


def test_externalize_random_roundtrip(tmp_path):
    nodes = [
        node("Gather", ["emb", "input"], ["x"], axis=0),
        node("RandomNormalLike", ["x"], ["dp_noise"], seed=1234.0),
        node("Add", ["x", "dp_noise"], ["y"]),
        node("RandomNormalLike", ["y"], ["main_noise"]),
        node("Mul", ["y", "main_noise"], ["output"]),
    ]
    inits = {"emb": np.zeros((4, 2), np.float32)}
    p = tmp_path / "m.onnx"
    save_model(str(p), nodes, inits,
               inputs=[OnnxValueInfo("input", TensorDataType.INT64, [1, "P"])],
               outputs=[OnnxValueInfo("output", TensorDataType.FLOAT, None)])
    m = load_model(p)
    rewritten, noise_names = externalize_random(m)
    assert noise_names == ["dp_noise", "main_noise"]
    assert [n.op_type for n in rewritten.graph.nodes] == ["Gather", "Add", "Mul"]
    input_names = [v.name for v in rewritten.graph.inputs]
    assert input_names == ["input", "dp_noise", "main_noise"]
    assert len(m.graph.nodes) == 5  # the original is untouched
    # The JAX package's rewrite of the same file gives the same graph.
    j_rewritten, j_names = j_externalize_random(j_load_model(p))
    assert j_names == noise_names
    assert [n.op_type for n in j_rewritten.graph.nodes] == ["Gather", "Add", "Mul"]
    assert [v.name for v in j_rewritten.graph.inputs] == input_names

    p2 = tmp_path / "m.norng.onnx"
    save_model_ir(str(p2), rewritten)
    m2 = load_model(p2)
    assert [n.op_type for n in m2.graph.nodes] == ["Gather", "Add", "Mul"]
    assert [v.name for v in m2.graph.inputs] == input_names
    np.testing.assert_array_equal(m2.graph.initializers["emb"].array, inits["emb"])
