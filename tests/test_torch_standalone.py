"""The port stands alone: it imports neither JAX nor the JAX package.

piper_tpu_torch keeps its own copies of the jax-free modules it needs
(onnx.{ir,wire,loader,writer}, core.config, core.test_vector,
models.vits.{hparams,synthetic}). These tests scan every module of the port
and chip_smoke.py for such imports, run the port in a process that refuses
them, and hold each copy equal to its original: the same synthetic voice
bytes, the same decoded graphs, hparams and configs.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from piper_tpu.core.config import VoiceConfig as JVoiceConfig
from piper_tpu.core.test_vector import FIXTURE_PHONEME_IDS as J_FIXTURE_IDS
from piper_tpu.models.vits.hparams import PRESETS as J_PRESETS
from piper_tpu.models.vits.hparams import derive_hparams as j_derive_hparams
from piper_tpu.models.vits.synthetic import make_synthetic_voice as j_make_voice
from piper_tpu.onnx.loader import load_model as j_load_model
from piper_tpu_torch.core.config import VoiceConfig
from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
from piper_tpu_torch.models.vits.hparams import PRESETS, derive_hparams
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice
from piper_tpu_torch.onnx.loader import load_model

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "piper_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FOREIGN = ("jax", "jaxlib", "piper_tpu")


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top == "piper_tpu" or top.startswith("jax")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    """No `import jax*`, `import piper_tpu[.*]` or `from ... import` of them,
    at any depth of the module (function bodies included)."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            bad += [(node.lineno, a.name) for a in node.names if _foreign(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and _foreign(node.module):
            bad.append((node.lineno, node.module))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


BLOCKER = """
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in {foreign!r}:
            raise ImportError(f'refused: {{name}}')
        return None

sys.meta_path.insert(0, Refuse())
"""


def test_port_runs_where_jax_and_the_jax_package_cannot_load(tmp_path):
    """In a process whose importer refuses jax and piper_tpu: import the
    runtime, both probes and chip_smoke, write an x_low voice with the
    port's own make_synthetic_voice and synthesize it on the CPU."""
    code = BLOCKER.format(foreign=FOREIGN) + (
        "import numpy as np\n"
        "import chip_smoke\n"
        "from piper_tpu_torch.engine.runtime import PiperRuntime\n"
        "from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS\n"
        "from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice\n"
        "from piper_tpu_torch.tools import ct_probe, folded_probe\n"
        f"model, config = make_synthetic_voice({str(tmp_path)!r}, quality='x_low', seed=0)\n"
        "pcm = PiperRuntime(model, config, device='cpu').synthesize(FIXTURE_PHONEME_IDS)\n"
        "assert len(pcm) > 0 and np.isfinite(pcm).all()\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FOREIGN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_the_blocker_refuses_the_jax_package():
    """The import blocker above does refuse what it must (else the test of
    the port under it would prove nothing)."""
    code = BLOCKER.format(foreign=FOREIGN) + "import piper_tpu.core.config\n"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and "refused: piper_tpu" in out.stderr


_VOICES = {}


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    """quality -> ((JAX model, config), (port model, config)), each written
    by its own package's make_synthetic_voice at seed 0, made on first use."""
    def get(quality):
        if quality not in _VOICES:
            d = tmp_path_factory.mktemp(f"voice_{quality}")
            _VOICES[quality] = (j_make_voice(d / "jax", quality=quality, seed=0),
                                make_synthetic_voice(d / "port", quality=quality, seed=0))
        return _VOICES[quality]
    yield get
    _VOICES.clear()


@pytest.mark.parametrize("quality", ["x_low", "medium"])
def test_synthetic_voice_files_are_byte_identical(voices, quality):
    (j_model, j_config), (model, config) = voices(quality)
    assert model.read_bytes() == j_model.read_bytes()
    assert config.read_bytes() == j_config.read_bytes()


def _tensor_key(t):
    return t.name, list(t.dims), int(t.data_type)


def _attr_value(v):
    if hasattr(v, "array"):  # a TENSOR attribute
        return _tensor_key(v), v.array.dtype.str, v.array.tobytes()
    return v


@pytest.mark.parametrize("quality", ["x_low", "medium"])
def test_loaders_decode_the_same_graph(voices, quality):
    """Both loaders on the same bytes: the same model fields, nodes,
    attributes, value infos, and bit-equal initializer tensors."""
    (_, _), (model, _) = voices(quality)
    data = model.read_bytes()
    jm, m = j_load_model(data), load_model(data)
    assert (m.ir_version, m.opset_version, m.producer_name) == (
        jm.ir_version, jm.opset_version, jm.producer_name)
    g, jg = m.graph, jm.graph
    assert g.name == jg.name

    def nodes(gr):
        return [(n.op_type, n.inputs, n.outputs, n.name,
                 {k: (a.name, int(a.type), _attr_value(a.value))
                  for k, a in n.attributes.items()}) for n in gr.nodes]

    assert nodes(g) == nodes(jg)
    for got, want in ((g.inputs, jg.inputs), (g.outputs, jg.outputs)):
        assert [(v.name, int(v.elem_type), v.shape) for v in got] == [
            (v.name, int(v.elem_type), v.shape) for v in want]
    assert list(g.initializers) == list(jg.initializers)
    for name, t in g.initializers.items():
        jt = jg.initializers[name]
        assert _tensor_key(t) == _tensor_key(jt)
        assert t.array.dtype == jt.array.dtype and t.array.shape == jt.array.shape, name
        assert t.array.tobytes() == np.ascontiguousarray(jt.array).tobytes(), name


def test_presets_are_equal():
    assert list(PRESETS) == list(J_PRESETS)
    for q in PRESETS:
        assert dataclasses.asdict(PRESETS[q]) == dataclasses.asdict(J_PRESETS[q]), q


@pytest.mark.parametrize("quality", ["test", "x_low", "low", "medium", "high"])
def test_derive_hparams_is_equal(voices, quality):
    """Each package derives the hparams from its own voice file with its own
    loader: equal fields, equal to the preset."""
    (j_model, j_config), (model, config) = voices(quality)
    sr = PRESETS[quality].sample_rate
    hp = derive_hparams(load_model(model).graph, sample_rate=sr)
    jhp = j_derive_hparams(j_load_model(j_model).graph, sample_rate=sr)
    assert dataclasses.asdict(hp) == dataclasses.asdict(jhp)
    assert (hp.hop_length, hp.num_upsamples) == (jhp.hop_length, jhp.num_upsamples)
    assert hp == PRESETS[quality]


@pytest.mark.parametrize("quality", ["x_low", "medium"])
def test_voice_config_load_is_equal(voices, quality):
    (_, j_config), (_, config) = voices(quality)
    assert dataclasses.asdict(VoiceConfig.load(config)) == dataclasses.asdict(
        JVoiceConfig.load(j_config))


def test_fixture_phoneme_ids_are_equal():
    assert FIXTURE_PHONEME_IDS == J_FIXTURE_IDS
