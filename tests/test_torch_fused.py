"""Fused mode on the port (mirrors tests/test_fused_mode.py).

Fused mode runs one utterance's encode and decode with no host read between
them, at the frame budget max(32, len * fused_frames_per_phoneme) rounded to
a frame bucket; a run whose durations overflow the budget is redone
exactly in split mode. The tiny test voice needs ~7 frames per phoneme, so
fused_frames_per_phoneme=12 keeps the fixture phrase inside the budget and
1 (with length_scale 3) overflows it.
"""

import numpy as np
import pytest
import torch

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fused(voice, fpp=12, **kw):
    return PiperRuntime(*voice, RuntimeOptions(mode="fused", fused_frames_per_phoneme=fpp, **kw),
                        device="cpu")


def _kinds(rt):
    return {kind for kind, _ in rt._compiled_keys}


def test_fused_basic(tiny_voice):
    rt = _fused(tiny_voice)
    audio = rt.synthesize(FIXTURE_IDS)
    assert len(audio) > 0 and np.isfinite(audio).all()
    t = rt.last_run_timings
    assert t.frame_bucket >= 32 and t.frames * rt.hparams.hop_length == len(audio)
    assert _kinds(rt) == {"fused"} and t.compiled and t.decode_ms == 0.0
    np.testing.assert_array_equal(audio, rt.synthesize(FIXTURE_IDS))  # deterministic
    assert not rt.last_run_timings.compiled


def test_fused_matches_split_when_bucket_aligns(tiny_voice):
    """A budget that lands on split's frame bucket draws the same noise, so
    the audio is identical."""
    rt_split = PiperRuntime(*tiny_voice, device="cpu")
    a_split = rt_split.synthesize(FIXTURE_IDS)
    split_bucket = rt_split.last_run_timings.frame_bucket
    rt_fused = _fused(tiny_voice, fpp=split_bucket // len(FIXTURE_IDS))
    a_fused = rt_fused.synthesize(FIXTURE_IDS)
    assert rt_fused.last_run_timings.frame_bucket == split_bucket
    assert _kinds(rt_fused) == {"fused"}
    np.testing.assert_array_equal(a_fused, a_split)


def test_fused_overflow_falls_back_to_split(tiny_voice):
    rt = _fused(tiny_voice, fpp=1)
    audio = rt.synthesize(FIXTURE_IDS, length_scale=3.0)  # long durations
    assert _kinds(rt) == {"fused", "enc_key", "dec_key"}
    rt_split = PiperRuntime(*tiny_voice, device="cpu")
    np.testing.assert_array_equal(audio, rt_split.synthesize(FIXTURE_IDS, length_scale=3.0))
    assert rt.last_run_timings.frame_bucket == rt_split.last_run_timings.frame_bucket


def test_fused_mode_batches_take_the_split_path(tiny_voice):
    rows = [FIXTURE_IDS, FIXTURE_IDS[:8]]
    got = _fused(tiny_voice).synthesize_batch(rows, seed=6)
    want = PiperRuntime(*tiny_voice, device="cpu").synthesize_batch(rows, seed=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_injected_noise_runs_split_in_fused_mode(tiny_voice):
    rng = np.random.default_rng(1)
    rt = _fused(tiny_voice)
    noise = dict(dp_noise=rng.standard_normal((2, len(FIXTURE_IDS))).astype(np.float32),
                 main_noise=rng.standard_normal((rt.hparams.inter_channels, 50))
                 .astype(np.float32))
    got = rt.synthesize(FIXTURE_IDS, **noise)
    assert _kinds(rt) == {"enc_inj", "dec_inj"}
    np.testing.assert_array_equal(
        got, PiperRuntime(*tiny_voice, device="cpu").synthesize(FIXTURE_IDS, **noise))


@pytest.mark.parametrize("fpp,length_scale", [(12, None), (1, 3.0)])
def test_dispatch_fetch_fused_equals_synthesize(tiny_voice, fpp, length_scale):
    """dispatch_fused queues the whole run with no host read; fetch_fused
    equals the fused synthesize, its overflow redo included."""
    rt = _fused(tiny_voice, fpp=fpp)
    want = rt.synthesize(FIXTURE_IDS, length_scale=length_scale, seed=4)
    outs, meta = rt.dispatch_fused(FIXTURE_IDS, length_scale=length_scale, seed=4)
    assert len(outs) == 3 and meta["f_bucket"] == rt._budget_bucket(len(FIXTURE_IDS))
    np.testing.assert_array_equal(rt.fetch_fused(outs, meta), want)


def test_fused_int16(tiny_voice):
    got = _fused(tiny_voice, output_dtype="int16").synthesize(FIXTURE_IDS)
    want = _fused(tiny_voice).synthesize(FIXTURE_IDS)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, (np.clip(want, -1.0, 1.0) * 32767.0).astype(np.int16))


def test_fused_options_match_reference():
    """The option names and defaults the JAX package has for fused mode and
    the batch ladder."""
    from piper_tpu.engine.runtime import RuntimeOptions as JaxOptions

    for name in ("mode", "fused_frames_per_phoneme", "batch_buckets"):
        assert getattr(RuntimeOptions(), name) == getattr(JaxOptions(), name), name
    RuntimeOptions(mode="fused").validate()
