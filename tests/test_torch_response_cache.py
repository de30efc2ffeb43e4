"""The port's response cache: identical requests served from memory (every
case of tests/test_response_cache.py, on the port's runtime at
device="cpu").

Synthesis is deterministic (seeded noise, one draw per row), so the batcher
can cache results — the canned-phrase traffic of real TTS deployments. Off
by default (cache_mb=0)."""

import numpy as np
import pytest
import torch

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine.batcher import BatchingServer
from piper_tpu_torch.engine.runtime import PiperRuntime
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread (see tests/test_torch_batcher.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runtime(tiny_voice):
    return PiperRuntime(*tiny_voice, device="cpu")


def test_cache_hit_is_identical_and_counted(runtime):
    with BatchingServer(runtime, max_batch=4, max_wait_ms=10, cache_mb=8) as server:
        a1 = server.submit(FIXTURE_IDS).result(timeout=300)
        a2 = server.submit(FIXTURE_IDS).result(timeout=300)
        m = server.metrics()
    np.testing.assert_array_equal(a1, a2)
    assert m["cache_hits"] == 1
    assert m["cache_bytes"] > 0
    assert m["completed"] == 2
    with pytest.raises(ValueError):  # cached results are read-only (shared across hits)
        a2[0] = 0.0


def test_cache_keys_separate_conditioning(tmp_path_factory):
    d = tmp_path_factory.mktemp("cache_ms_voice")
    rt = PiperRuntime(*make_synthetic_voice(d, quality="test", seed=6, n_speakers=4,
                                            gin_channels=32), device="cpu")
    with BatchingServer(rt, max_batch=4, max_wait_ms=10, cache_mb=8) as server:
        a0 = server.submit(FIXTURE_IDS, speaker_id=0).result(timeout=300)
        a1 = server.submit(FIXTURE_IDS, speaker_id=1).result(timeout=300)
        a_mix = server.submit(FIXTURE_IDS, speaker_mix={0: 0.5, 1: 0.5}).result(timeout=300)
        a_ls = server.submit(FIXTURE_IDS, length_scale=1.3).result(timeout=300)
        assert server.metrics()["cache_hits"] == 0  # four distinct keys
        b0 = server.submit(FIXTURE_IDS, speaker_id=0).result(timeout=300)
        b_mix = server.submit(FIXTURE_IDS, speaker_mix={0: 0.5, 1: 0.5}).result(timeout=300)
        assert server.metrics()["cache_hits"] == 2
    np.testing.assert_array_equal(a0, b0)
    np.testing.assert_array_equal(a_mix, b_mix)
    if a0.shape == a1.shape:
        assert not np.array_equal(a0, a1)
    assert np.isfinite(a_ls).all()


def test_cache_durations_and_forced(runtime):
    with BatchingServer(runtime, max_batch=4, max_wait_ms=10, cache_mb=8) as server:
        d1 = server.submit_durations(FIXTURE_IDS).result(timeout=300)
        d2 = server.submit_durations(FIXTURE_IDS).result(timeout=300)
        np.testing.assert_array_equal(d1, d2)
        f1 = server.submit_forced(FIXTURE_IDS, list(d1)).result(timeout=300)
        f2 = server.submit_forced(FIXTURE_IDS, list(d1)).result(timeout=300)
        np.testing.assert_array_equal(f1, f2)
        m = server.metrics()
    assert m["cache_hits"] == 2
    # The kind is part of the key: a durations hit never answers a synth.
    with BatchingServer(runtime, max_batch=4, max_wait_ms=10, cache_mb=8) as server:
        server.submit_durations(FIXTURE_IDS).result(timeout=300)
        server.submit(FIXTURE_IDS).result(timeout=300)
        assert server.metrics()["cache_hits"] == 0


def test_cache_evicts_lru(runtime):
    with BatchingServer(runtime, max_batch=4, max_wait_ms=10, cache_mb=8) as server:
        nbytes = np.asarray(server.submit(FIXTURE_IDS).result(timeout=300)).nbytes
    # A budget that fits ONE entry: a second same-length request evicts the
    # first, so repeating the first recomputes (no hit).
    other = list(reversed(FIXTURE_IDS))
    budget_mb = (nbytes + nbytes // 2) / (1 << 20)
    with BatchingServer(runtime, max_batch=4, max_wait_ms=10, cache_mb=budget_mb) as server:
        server.submit(FIXTURE_IDS).result(timeout=300)
        server.submit(other).result(timeout=300)  # evicts the first
        server.submit(FIXTURE_IDS).result(timeout=300)  # -> miss
        m = server.metrics()
        assert m["cache_hits"] == 0
        assert 0 < m["cache_bytes"] <= budget_mb * (1 << 20)


def test_cache_disabled_by_default(runtime):
    with BatchingServer(runtime, max_batch=4, max_wait_ms=10) as server:
        server.submit(FIXTURE_IDS).result(timeout=300)
        server.submit(FIXTURE_IDS).result(timeout=300)
        m = server.metrics()
    assert m["cache_hits"] == 0 and m["cache_bytes"] == 0
