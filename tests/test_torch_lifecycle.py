"""The port runtime's serving contracts and edge cases, on the CPU.

The runtime cases of tests/test_voice_lifecycle.py: `close()` releases the
weights (here: no reference to a weight tensor survives it), `hbm_bytes()`
counts them (equal to the JAX runtime's count for the same voice) and is 0
once closed, and every entry point raises RuntimeError after it. Its
program-set eviction case (`evict_program_sets`, `program_set_count`) has no
counterpart: the port compiles no programs, so there is no shared set to
evict. Its UnifiedServer cases wait for UnifiedServer's port. Then
`prewarm()`, the `params` setter, and every case of tests/test_edge_cases.py:
frame overflow truncates with a warning, extreme scales, one phoneme,
repeated calls stable.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIX
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions


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


def test_runtime_close_releases_weights(tiny_voice):
    rt = PiperRuntime(*tiny_voice, device="cpu")
    assert rt.hbm_bytes() > 0 and not rt.closed
    audio = rt.synthesize(FIX, seed=1)
    assert np.isfinite(audio).all()
    outs, meta = rt.dispatch_batch([FIX, FIX[:6]], fused=True, pad_rows_to=2)
    rt.fetch_batch(outs, meta)
    refs = [weakref.ref(t) for t in rt.params.values()]
    del outs, meta
    rt.close()
    gc.collect()
    assert rt.closed and rt.hbm_bytes() == 0
    assert all(r() is None for r in refs), "a weight tensor outlived close()"
    with pytest.raises(RuntimeError, match="closed"):
        rt.synthesize(FIX, seed=1)
    rt.close()  # idempotent


@pytest.mark.parametrize("call", [
    lambda rt: rt.synthesize(FIX),
    lambda rt: rt.synthesize_batch([FIX, FIX[:6]]),
    lambda rt: rt.dispatch_batch([FIX, FIX[:6]], fused=True, pad_rows_to=2),
    lambda rt: rt.dispatch_fused(FIX),
    lambda rt: rt.phoneme_durations([FIX]),
    lambda rt: rt.synthesize_forced(FIX, [2] * len(FIX)),
    lambda rt: next(rt.synthesize_stream(FIX, incremental=True)),
    lambda rt: rt.prewarm(phoneme_lengths=(14,)),
], ids=["synthesize", "synthesize_batch", "dispatch_batch_fused", "dispatch_fused",
        "phoneme_durations", "synthesize_forced", "stream", "prewarm"])
def test_every_entry_point_raises_after_close(tiny_voice, call):
    rt = PiperRuntime(*tiny_voice, device="cpu")
    rt.close()
    with pytest.raises(RuntimeError, match=r"close\(\)"):
        call(rt)


def test_hbm_bytes_equal_the_reference(tiny_voice, tiny_runtime):
    """The same weights, the same bytes: the port's fp32 tensors against
    the JAX runtime's device arrays."""
    rt = PiperRuntime(*tiny_voice, device="cpu")
    assert rt.hbm_bytes() == tiny_runtime.hbm_bytes()
    assert rt.hbm_bytes() == sum(t.numel() * t.element_size() for t in rt.params.values())


def test_params_setter(tiny_voice, runtime):
    """Assigning params swaps the weights (and their byte count); a closed
    runtime's params raise."""
    rt = PiperRuntime(*tiny_voice, device="cpu")
    rt.params = {k: v * 0.5 if k.startswith("dec.conv_post") else v
                 for k, v in runtime.params.items()}
    assert rt.hbm_bytes() == runtime.hbm_bytes()
    a = rt.synthesize(FIX, seed=3)
    b = runtime.synthesize(FIX, seed=3)
    assert a.shape == b.shape and not np.array_equal(a, b)
    rt.close()
    with pytest.raises(RuntimeError):
        rt.params  # noqa: B018


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_prewarm_runs_the_sweep_ahead_of_traffic(tiny_voice, mode):
    """prewarm() returns {"programs", "seconds"} counted by the runtime's
    first-run keys; the same calls afterwards run none for the first
    time."""
    rt = PiperRuntime(*tiny_voice, RuntimeOptions(mode=mode), device="cpu")
    stats = rt.prewarm(phoneme_lengths=(14, 28), batch_sizes=(1, 2))
    assert set(stats) == {"programs", "seconds"}
    assert stats["programs"] == len(rt._compiled_keys) > 0 and stats["seconds"] > 0
    assert rt.prewarm(phoneme_lengths=(14, 28), batch_sizes=(1, 2))["programs"] == 0
    rt.synthesize(FIX)
    assert not rt.last_run_timings.compiled


# -- tests/test_edge_cases.py --------------------------------------------------


def test_frame_overflow_truncates_with_warning(tiny_voice, capsys):
    rt = PiperRuntime(*tiny_voice, RuntimeOptions(frame_buckets=(32, 64)), device="cpu")
    audio = rt.synthesize(FIX, length_scale=10.0)
    # Clamped to the largest bucket instead of raising — and says so.
    assert len(audio) == 64 * rt.hparams.hop_length
    assert np.isfinite(audio).all()
    assert "truncated" in capsys.readouterr().err


def test_extreme_scales(runtime):
    a_fast = runtime.synthesize(FIX, length_scale=0.1)
    a_slow = runtime.synthesize(FIX, length_scale=2.5)
    assert 0 < len(a_fast) < len(a_slow)
    for a in (a_fast, a_slow):
        assert np.isfinite(a).all()
    a_noisy = runtime.synthesize(FIX, noise_scale=5.0, noise_w=5.0)
    assert np.isfinite(a_noisy).all()
    assert np.abs(a_noisy).max() <= 1.0  # tanh-bounded even at silly noise
    a_silent = runtime.synthesize(FIX, noise_scale=0.0, noise_w=0.0)
    assert np.isfinite(a_silent).all()


def test_single_phoneme(runtime):
    audio = runtime.synthesize([1])
    assert len(audio) >= runtime.hparams.hop_length
    assert np.isfinite(audio).all()


def test_repeated_synthesize_stable(runtime):
    """No state leaks across calls: interleaved shapes stay deterministic."""
    a1 = runtime.synthesize(FIX)
    runtime.synthesize(FIX * 3)
    runtime.synthesize(FIX[:4])
    a2 = runtime.synthesize(FIX)
    np.testing.assert_array_equal(a1, a2)
