"""The port stands alone: it imports neither JAX nor the JAX package.

piper_tpu_torch keeps its own copies of the jax-free modules it needs
(onnx.{ir,wire,loader,writer}, core.{config,test_vector,alignment,audio,
phonemes,text,ssml,voices}, phonemize, utils.{env,wav,profiling,playback},
models.vits.{hparams,synthetic}, client, testing, version, the roofline
cost model, and engine.runtime's speaker and scale helpers). These tests scan every module of the port
and chip_smoke.py for such imports, run the port in a process that refuses
them, and hold each copy equal to its original: the same synthetic voice
bytes, the same decoded graphs, hparams and configs.
"""

import ast
import dataclasses
import json
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
    runtime, both probes, the HTTP server, VoiceServer, the CLI, the text
    front end and chip_smoke, write an x_low voice with the port's own
    make_synthetic_voice and synthesize it on the CPU."""
    code = BLOCKER.format(foreign=FOREIGN) + (
        "import numpy as np\n"
        "import chip_smoke\n"
        "from piper_tpu_torch.engine.runtime import PiperRuntime\n"
        "from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS\n"
        "from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice\n"
        "from piper_tpu_torch.tools import ct_probe, folded_probe, serving_sim\n"
        "from piper_tpu_torch.engine import batcher, http_server, server\n"
        "from piper_tpu_torch import cli, phonemize\n"
        "from piper_tpu_torch.core import phonemes, ssml, text, voices\n"
        "from piper_tpu_torch.utils import wav\n"
        "from piper_tpu_torch.utils import env\n"
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


def test_env_module_is_a_copy(monkeypatch):
    """utils/env.py holds the JAX package's jax-free flag readers, their
    source unchanged (apply_platform_override, which imports jax, stays
    behind), and they read the same environment the same way."""
    import inspect

    from piper_tpu.utils import env as j_env
    from piper_tpu_torch.utils import env

    names = ("flag", "flag_bool", "cache_root", "profile_enabled", "trace_enabled")
    assert sorted(n for n, v in vars(env).items() if inspect.isfunction(v)) == sorted(names)
    for name in names:
        assert inspect.getsource(getattr(env, name)) == inspect.getsource(getattr(j_env, name))
    for value in (None, "", "1", "0", "/some/dir"):
        for var in ("PIPER_TPU_PROFILE", "PIPER_TPU_TRACE", "PIPER_TPU_CACHE"):
            if value is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, value)
        for name in ("cache_root", "profile_enabled", "trace_enabled"):
            assert getattr(env, name)() == getattr(j_env, name)(), (name, value)
        assert env.flag("PIPER_TPU_CACHE", "d") == j_env.flag("PIPER_TPU_CACHE", "d")
        assert env.flag_bool("PIPER_TPU_TRACE") == j_env.flag_bool("PIPER_TPU_TRACE")


def test_fixture_phoneme_ids_are_equal():
    assert FIXTURE_PHONEME_IDS == J_FIXTURE_IDS


SPEAKER_MAP = {"92": 0, "3922": 1, "2": 3, "alba": 2}
RESOLVE_CASES = [(2, 4, None), (np.int64(3), 4, None), ("3", 4, None), (" 2 ", 4, SPEAKER_MAP),
                 ("3922", 4, SPEAKER_MAP), ("alba", 4, SPEAKER_MAP), ("bob", 4, SPEAKER_MAP),
                 ("bob", 4, None), (True, 4, None), (1.0, 4, None), (None, 4, None),
                 (4, 4, None), (-1, 4, None), (0, 1, None), (1, 1, None), ("x1", 0, None)]
MIX_SPECS = ["0:0.6,3:0.4", "alba:1", " 2 : 0.5 , spk1:-0.2", "0:1,0:2", "0", ":1", "0:x",
             "a:b:c", "", "1:1e3"]
SCALES = [(0.667, 1.0, 0.8), (0.0, 0.5, 0.0), (0.5, 0.0, 0.5), (0.5, -1.0, 0.5),
          (float("nan"), 1.0, 0.8), (0.5, float("inf"), 0.8), (0.5, 1.0, -0.1),
          (0.5, 1.0, float("inf"))]
MIXES = [({0: 0.6, 3: 0.4}, 4, None), ({0: 1.2, 1: -0.2}, 4, None), ({2: 1.0}, 4, 1),
         ({0: 1.0}, 1, None), ({}, 4, None), ({1.5: 1.0}, 4, None), ({True: 1.0}, 4, None),
         ({2.0: 1.0}, 4, None), ({np.int64(3): 1.0}, 4, None), ({"2": 1.0}, 4, None),
         ({4: 1.0}, 4, None), ({-1: 1.0}, 4, None), ({0: float("nan")}, 4, None),
         ({0: 0.0, 1: 0.0}, 4, None), ({2: 0.5, np.int32(2): 0.5, 1: 1.0}, 4, None)]


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 — the type and message are what is compared
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name,cases", [
    ("resolve_speaker", RESOLVE_CASES), ("parse_mix_spec", [(s,) for s in MIX_SPECS]),
    ("validate_scales", SCALES), ("validate_speaker_mix", MIXES)])
def test_speaker_helpers_match_the_reference(name, cases):
    """The port's copies of the JAX package's speaker and scale helpers
    give the same results, and raise the same errors with the same
    messages, over one table of inputs."""
    from piper_tpu.engine import runtime as j_runtime
    from piper_tpu_torch.engine import runtime as t_runtime

    for args in cases:
        got = _outcome(getattr(t_runtime, name), *args)
        want = _outcome(getattr(j_runtime, name), *args)
        assert got == want, (name, args)
        assert type(got[1]) is type(want[1]), (name, args)


def test_multispeaker_voice_files_are_byte_identical(tmp_path):
    """The bench's 904-speaker voice (gin 512), written by each package."""
    j_model, j_config = j_make_voice(tmp_path / "jax", quality="medium", seed=0,
                                     n_speakers=904, gin_channels=512)
    model, config = make_synthetic_voice(tmp_path / "port", quality="medium", seed=0,
                                         n_speakers=904, gin_channels=512)
    assert model.read_bytes() == j_model.read_bytes()
    assert config.read_bytes() == j_config.read_bytes()
    assert json.loads(config.read_text())["num_speakers"] == 904


def test_alignment_json_matches_reference():
    """The copy of core/alignment.py gives the JAX package's dict and JSON
    for the same plan, truncated or not, shifted or not."""
    from piper_tpu.core import alignment as j_al
    from piper_tpu_torch.core.alignment import alignments_to_json, make_alignment

    durs = np.array([3, 0, 5, 2, 7], np.int64)
    ids = [1, 20, 0, 12, 2]
    for total in (17 * 256, 10 * 256):
        kw = dict(hop_length=256, sample_rate=22050, total_samples=total)
        al, jal = make_alignment(ids, durs, **kw), j_al.make_alignment(ids, durs, **kw)
        assert al.to_dict() == jal.to_dict()
        assert al.to_dict(offset_samples=1000) == jal.to_dict(offset_samples=1000)
        assert json.dumps(alignments_to_json([al, al], [0, total + 50])) == json.dumps(
            j_al.alignments_to_json([jal, jal], [0, total + 50]))
    with pytest.raises(ValueError):
        make_alignment([1, 2, 3], np.array([1, 2]), hop_length=32, sample_rate=16000,
                       total_samples=96)
    with pytest.raises(ValueError):
        alignments_to_json([], [0])


def test_audio_module_is_a_copy():
    """core/audio.py is the JAX package's, byte for byte, and its helpers
    give the same results: chunks, int16 conversion, joins."""
    from piper_tpu.core import audio as j_audio
    from piper_tpu_torch.core import audio

    assert (ROOT / "piper_tpu_torch/core/audio.py").read_bytes() == (
        ROOT / "piper_tpu/core/audio.py").read_bytes()
    x = np.array([-1.5, -1.0, -0.25, 0.0, 0.5, 1.0, 2.0], np.float32)
    i16 = audio.float_to_int16(x)
    np.testing.assert_array_equal(i16, j_audio.float_to_int16(x))
    np.testing.assert_array_equal(audio.pcm_to_float32(i16), j_audio.pcm_to_float32(i16))
    np.testing.assert_array_equal(audio.join_with_silence([x, i16], 3),
                                  j_audio.join_with_silence([x, i16], 3))
    fmt = audio.AudioFormat(sample_rate=16000)
    chunk = audio.AudioChunk(format=fmt, start_sample_index=5, samples=x, is_final=True)
    assert dataclasses.asdict(fmt) == dataclasses.asdict(j_audio.AudioFormat(sample_rate=16000))
    assert chunk.duration_seconds == 7 / 16000


@pytest.mark.parametrize("rel", ["core/test_vector.py", "utils/profiling.py",
                                 "utils/playback.py", "version.py", "utils/debug_trace.py"])
def test_jax_free_module_is_a_byte_copy(rel):
    """The JAX package's jax-free modules the CLI and the package surface
    need, copied byte for byte. utils/profiling.py has since grown the
    port's timeline (spans, the ring, CUDA events) around the copy: its
    StageStats is still the JAX package's byte for byte, and its Profiler
    books the same records into the same rows."""
    ours = (ROOT / "piper_tpu_torch" / rel).read_bytes()
    theirs = (ROOT / "piper_tpu" / rel).read_bytes()
    if rel != "utils/profiling.py":
        assert ours == theirs
        return
    assert theirs[theirs.index(b"@dataclass\nclass StageStats"):
                  theirs.index(b"class Profiler")].rstrip() in ours
    from piper_tpu.utils.profiling import Profiler as JaxProfiler
    from piper_tpu_torch.utils.profiling import Profiler

    rows = []
    for prof in (Profiler(), JaxProfiler()):
        for stage, bucket, ms, compiled in (("encode", 16, 5.0, True), ("encode", 16, 3.0, False),
                                            ("decode", 128, 9.5, False)):
            prof.record(stage, bucket, ms, compiled)
        rows.append([(s, b, dataclasses.asdict(st)) for s, b, st in prof.rows()])
    assert rows[0] == rows[1]


@pytest.mark.parametrize("rel", ["client.py", "testing.py"])
def test_module_is_a_copy_but_for_the_package_name(rel):
    """client.py (stdlib and numpy) and testing.py (over the runtime) are the
    JAX package's with each `piper_tpu.` import pointed at the port."""
    ours = (ROOT / "piper_tpu_torch" / rel).read_text()
    theirs = (ROOT / "piper_tpu" / rel).read_text()
    assert ours.replace("piper_tpu_torch.", "piper_tpu.") == theirs
    assert "piper_tpu." not in ours.replace("piper_tpu_torch.", "")


def test_package_exports_the_reference_names():
    """piper_tpu_torch exports piper_tpu's 17 names (and RunTimings), each
    loaded on first access from the port's own module."""
    import piper_tpu
    import piper_tpu_torch

    assert set(piper_tpu.__all__) <= set(piper_tpu_torch.__all__)
    assert set(piper_tpu_torch.__all__) - set(piper_tpu.__all__) == {"RunTimings"}
    assert len(piper_tpu.__all__) == 17
    for name in piper_tpu_torch.__all__ + ["MultiVoiceBatchingServer"]:
        value = getattr(piper_tpu_torch, name)
        if name == "__version__":
            assert value == piper_tpu.__version__
        else:
            assert value.__module__.startswith("piper_tpu_torch."), name
            assert value.__name__ == name
    with pytest.raises(AttributeError):
        piper_tpu_torch.no_such_name


def test_cli_client_testing_and_roofline_import_no_jax():
    """In a fresh process: the CLI, the client, testing.py, the roofline
    module and tools and the package's names load, and neither jax nor
    piper_tpu is in sys.modules after."""
    code = (
        "import sys\n"
        "import piper_tpu_torch\n"
        "from piper_tpu_torch import cli, client, testing\n"
        "from piper_tpu_torch.utils import roofline, profiling, playback\n"
        "from piper_tpu_torch.tools import roofline as rl_tool, level_probe\n"
        "names = [getattr(piper_tpu_torch, n) for n in piper_tpu_torch.__all__]\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FOREIGN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
