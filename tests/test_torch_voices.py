"""The port's voice assets and multi-voice serving: core/voices.py's
VoiceManager behind PiperRuntime.load_voice, and engine/server.py's
VoiceServer, on the CPU.

The cases of tests/test_voice_download.py (offline: the synthetic voice is
"hosted" at file:// URLs with real sha256 sums, so load_voice really
fetches, verifies and loads it) and of tests/test_server.py, on the port
with device="cpu". Then the device rule: load_voice, VoiceServer and the
serving CLI go to the card unless asked for the CPU, and raise where there
is no card, before anything is fetched.
"""

import hashlib

import numpy as np
import pytest
import torch

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.core.voices import (VoiceDownloadError, VoiceEntry, VoiceIndex,
                                         VoiceManager)
from piper_tpu_torch.engine.runtime import PiperRuntime
from piper_tpu_torch.engine.server import VoiceServer
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

no_card = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="checks what happens where there is no card")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hosted_voice(tmp_path_factory):
    """A synthetic voice 'hosted' at file:// URLs with real sha256 sums."""
    d = tmp_path_factory.mktemp("hosted")
    model, config = make_synthetic_voice(d, quality="test", seed=5,
                                         voice_name="xx_XX-test-x_low")

    def sha(p):
        return hashlib.sha256(p.read_bytes()).hexdigest()

    return VoiceEntry(
        id="xx_XX-test-x_low",
        language="xx_XX",
        quality="test",
        model_url=model.as_uri(),
        config_url=config.as_uri(),
        model_sha256=sha(model),
        config_sha256=sha(config),
    )


# -- tests/test_voice_download.py on the port ---------------------------------


def test_ensure_voice_downloads_and_caches(hosted_voice, tmp_path):
    vm = VoiceManager(cache_root=tmp_path, index=VoiceIndex([hosted_voice]))
    model_path, config_path = vm.ensure_voice("xx_XX-test-x_low")
    assert model_path.exists() and config_path.exists()
    assert "voices/xx_XX-test-x_low" in str(model_path)
    # Second call reuses the cache (mtimes unchanged).
    m1 = model_path.stat().st_mtime_ns
    vm.ensure_voice("xx_XX-test-x_low")
    assert model_path.stat().st_mtime_ns == m1
    # No .partial leftovers.
    assert not list(tmp_path.rglob("*.partial"))


def test_sha_mismatch_rejected(hosted_voice, tmp_path):
    bad = VoiceEntry(**{**hosted_voice.__dict__, "model_sha256": "0" * 64})
    vm = VoiceManager(cache_root=tmp_path, index=VoiceIndex([bad]))
    with pytest.raises(VoiceDownloadError, match="validation"):
        vm.ensure_voice("xx_XX-test-x_low")
    assert not list(tmp_path.rglob("*.partial"))


def test_poisoned_cache_redownloaded(hosted_voice, tmp_path):
    vm = VoiceManager(cache_root=tmp_path, index=VoiceIndex([hosted_voice]))
    model_path, _ = vm.ensure_voice("xx_XX-test-x_low")
    # Poison the cached model with an HTML error page.
    model_path.write_bytes(b"<html>502 Bad Gateway</html>")
    model_path2, _ = vm.ensure_voice("xx_XX-test-x_low")
    assert model_path2.read_bytes()[:1] != b"<"


def test_load_voice_end_to_end(hosted_voice, tmp_path):
    vm = VoiceManager(cache_root=tmp_path, index=VoiceIndex([hosted_voice]))
    rt = PiperRuntime.load_voice("xx_XX-test-x_low", manager=vm, device="cpu")
    audio = rt.synthesize(FIXTURE_IDS)
    assert len(audio) > 0 and np.isfinite(audio).all()
    assert rt.sample_rate == 16000
    assert rt.device.type == "cpu"


def test_manager_paths_match_the_reference(hosted_voice, tmp_path, monkeypatch):
    """The cache layout and its root (PIPER_TPU_CACHE, else the home
    directory's) are the JAX package's, so both packages share a cache."""
    from piper_tpu.core import voices as j_voices

    monkeypatch.setenv("PIPER_TPU_CACHE", str(tmp_path / "root"))
    vm, jvm = VoiceManager(index=VoiceIndex([])), j_voices.VoiceManager(
        index=j_voices.VoiceIndex([]))
    assert vm.cache_root == jvm.cache_root == tmp_path / "root"
    assert vm.cached_paths("a_B-c-low") == jvm.cached_paths("a_B-c-low")
    monkeypatch.delenv("PIPER_TPU_CACHE")
    assert VoiceManager(index=VoiceIndex([])).cache_root == j_voices.VoiceManager(
        index=j_voices.VoiceIndex([])).cache_root


# -- tests/test_server.py on the port ------------------------------------------


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    d = tmp_path_factory.mktemp("server_voices")
    v1, _ = make_synthetic_voice(d / "a", quality="test", seed=1, voice_name="voice-a")
    v2, _ = make_synthetic_voice(d / "b", quality="test", seed=2, voice_name="voice-b")
    v3, _ = make_synthetic_voice(
        d / "c", quality="test", seed=3, n_speakers=4, gin_channels=16,
        voice_name="voice-multispeaker",
    )
    return v1, v2, v3


def test_multi_voice_loading_and_synthesis(voices):
    v1, v2, v3 = voices
    with VoiceServer(device="cpu") as server:
        k1 = server.load(v1)
        k2 = server.load(v2)
        assert server.loaded_voices == ["voice-a", "voice-b"]
        a1 = server.synthesize(k1, FIXTURE_IDS)
        a2 = server.synthesize(k2, FIXTURE_IDS)
        assert len(a1) > 0 and len(a2) > 0
        # Different weights => different audio.
        if a1.shape == a2.shape:
            assert not np.allclose(a1, a2)
        # Loading again is a no-op (same runtime object).
        rt = server.runtime(k1)
        server.load(v1)
        assert server.runtime(k1) is rt
        assert rt.device.type == "cpu"


def test_multispeaker_voice_via_server(voices):
    _, _, v3 = voices
    with VoiceServer(device="cpu") as server:
        k = server.load(v3)
        a0 = server.synthesize(k, FIXTURE_IDS, speaker_id=0)
        a2 = server.synthesize(k, FIXTURE_IDS, speaker_id=2)
        assert len(a0) > 0 and len(a2) > 0
        if a0.shape == a2.shape:
            assert not np.allclose(a0, a2)


def test_lru_eviction(voices):
    v1, v2, v3 = voices
    with VoiceServer(max_voices=2, device="cpu") as server:
        server.load(v1)
        server.load(v2)
        server.load(v3)
        assert len(server.loaded_voices) == 2
        assert "voice-a" not in server.loaded_voices
        # Touch voice-b, then load voice-a again: voice-multispeaker evicts.
        server.synthesize("voice-b", FIXTURE_IDS)
        server.load(v1)
        assert set(server.loaded_voices) == {"voice-b", "voice-a"}


def test_server_pipeline(voices):
    v1, _, _ = voices
    with VoiceServer(device="cpu") as server:
        k = server.load(v1)
        pipe = server.pipeline(k)
        futs = [pipe.submit(FIXTURE_IDS, seed=i) for i in range(3)]
        audios = [f.result(timeout=300) for f in futs]
        assert all(len(a) > 0 for a in audios)
        assert server.pipeline(k) is pipe


def test_multivoice_batching_server_real_voices(voices):
    """Continuous batching across two resident voices on one worker: mixed
    per-voice traffic resolves with finite audio and per-voice metrics
    (built through VoiceServer.batching_server)."""
    v1, v2, _ = voices
    with VoiceServer(device="cpu") as server:
        a, b = server.load(v1, key="a"), server.load(v2, key="b")
        with server.batching_server([a, b], max_batch=4, max_wait_ms=30) as srv:
            futs = []
            for i in range(4):
                futs.append(("a", srv.submit("a", FIXTURE_IDS)))
                futs.append(("b", srv.submit("b", FIXTURE_IDS[: 6 + i])))
            audios = [(v, f.result(timeout=600)) for v, f in futs]
        m = srv.metrics()
    for _, audio in audios:
        assert len(audio) > 0 and np.isfinite(audio).all()
    assert m["a"]["rows"] == 4 and m["b"]["rows"] == 4
    assert m["a"]["completed"] == 4 and m["b"]["completed"] == 4


# -- the card by default ---------------------------------------------------------


@no_card
def test_load_voice_and_voice_server_default_to_the_card(hosted_voice, voices, tmp_path):
    """Without a card, load_voice and VoiceServer raise at their default
    device (nothing falls back to the CPU), and load_voice raises before it
    fetches anything."""
    vm = VoiceManager(cache_root=tmp_path, index=VoiceIndex([hosted_voice]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PiperRuntime.load_voice("xx_XX-test-x_low", manager=vm)
    assert not (tmp_path / "voices").exists()
    with VoiceServer() as server:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            server.load(voices[0])
        assert server.loaded_voices == []


def test_entry_points_take_device_cuda_by_default():
    import inspect

    from piper_tpu_torch import cli

    assert inspect.signature(PiperRuntime.load_voice).parameters["device"].default == "cuda"
    assert inspect.signature(VoiceServer).parameters["device"].default == "cuda"
    assert cli.build_parser().parse_args(["--serve"]).device == "cuda"
