"""Forced durations and alignment on the port (mirrors the JAX package's
tests/test_forced_durations.py and tests/test_alignment.py), on the CPU.

Forcing the plan phoneme_durations() returned, at the same seed, reproduces
split mode's synthesize() bit for bit: the same encoder, the same w_ceil
values, the prior's noise drawn at the same frame bucket. A forced plan's
audio is exactly sum(durations) * hop samples long. The alignment's spans
are those of the waveform it comes with (tests/test_torch_standalone.py
holds the copy of core/alignment.py to the JAX package's).
"""

import numpy as np
import pytest
import torch

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIX
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rt(tiny_voice):
    return PiperRuntime(*tiny_voice, RuntimeOptions(mode="split"), device="cpu")


@pytest.fixture(scope="module")
def ms_rt(tmp_path_factory):
    voice = make_synthetic_voice(tmp_path_factory.mktemp("forced_ms"), quality="test", seed=6,
                                 n_speakers=4, gin_channels=32)
    return PiperRuntime(*voice, RuntimeOptions(mode="split"), device="cpu")


def test_forcing_the_predicted_plan_reproduces_synthesize(rt):
    durs = rt.phoneme_durations([FIX], seed=9)[0]
    ref = rt.synthesize(FIX, seed=9)
    forced = rt.synthesize_forced(FIX, [int(d) for d in durs], seed=9)
    assert forced.shape == ref.shape
    np.testing.assert_array_equal(forced, ref)
    t = rt.last_run_timings
    assert t.frames == int(durs.sum()) and t.samples == len(forced) and t.encode_ms == 0.0
    assert ("forced", (1, 16, t.frame_bucket, None)) in rt._compiled_keys


@pytest.mark.parametrize("spk", [{"speaker_id": 1}, {"speaker_mix": {0: 0.4, 2: 0.6}}],
                         ids=["id", "mix"])
def test_forcing_the_predicted_plan_with_speakers(ms_rt, spk):
    lists = ({"speaker_ids": [spk["speaker_id"]]} if "speaker_id" in spk
             else {"speaker_mixes": [spk["speaker_mix"]]})
    durs = ms_rt.phoneme_durations([FIX], seed=4, **lists)[0]
    ref = ms_rt.synthesize(FIX, seed=4, **spk)
    forced = ms_rt.synthesize_forced(FIX, [int(d) for d in durs], seed=4, **spk)
    np.testing.assert_array_equal(forced, ref)


def test_one_hot_mix_durations_and_forced_equal_the_id(ms_rt):
    durs_mix = ms_rt.phoneme_durations([FIX], speaker_mixes=[{1: 1.0}])[0]
    durs_id = ms_rt.phoneme_durations([FIX], speaker_ids=[1])[0]
    assert list(durs_mix) == list(durs_id)
    np.testing.assert_array_equal(
        ms_rt.synthesize_forced(FIX, durs_mix, speaker_mix={1: 1.0}),
        ms_rt.synthesize_forced(FIX, durs_id, speaker_id=1))


def test_forced_lengths_are_exact(rt):
    hop = rt.hparams.hop_length
    durs = [2] * len(FIX)
    audio = rt.synthesize_forced(FIX, durs, seed=3)
    assert len(audio) == sum(durs) * hop
    durs2 = list(durs)
    durs2[4] += 5
    assert len(rt.synthesize_forced(FIX, durs2, seed=3)) == len(audio) + 5 * hop


def test_zero_duration_skips_a_phoneme(rt):
    durs = [2] * len(FIX)
    durs[3] = 0
    audio = rt.synthesize_forced(FIX, durs, seed=3)
    assert len(audio) == sum(durs) * rt.hparams.hop_length
    assert np.isfinite(audio).all()


def test_forced_batch_matches_solo(ms_rt):
    """Row-invariant noise: a forced row equals its solo run where their
    frame buckets agree (row 0 is the longest), within 1e-5; every row is
    exactly its plan long; dummy rows copy row 0's plan and speaker."""
    durs_a, durs_b, durs_c = [2] * len(FIX), [3] * 6, [1] * 8
    solo = ms_rt.synthesize_forced(FIX, durs_a, speaker_id=2, seed=5)
    batch = ms_rt.synthesize_batch_forced([FIX, FIX[:6], FIX[:8]], [durs_a, durs_b, durs_c],
                                          speaker_ids=[2, 0, 3], seed=5)
    assert len(batch) == 3
    np.testing.assert_allclose(batch[0], solo, atol=1e-5, rtol=0)
    hop = ms_rt.hparams.hop_length
    assert [len(a) for a in batch] == [sum(d) * hop for d in (durs_a, durs_b, durs_c)]
    assert ms_rt.last_run_timings.frames == sum(durs_a + durs_b + durs_c)
    pinned = ms_rt.synthesize_batch_forced([FIX], [durs_a], speaker_mixes=[{2: 1.0}], seed=5,
                                           pad_rows_to=3)
    np.testing.assert_allclose(pinned[0], solo, atol=1e-5, rtol=0)
    assert ("forced", (3, 16, 32, "mix")) in ms_rt._compiled_keys


def test_forced_validation_errors(rt):
    with pytest.raises(ValueError, match="durations length"):
        rt.synthesize_forced(FIX, [1, 2, 3])
    with pytest.raises(ValueError, match="non-negative"):
        rt.synthesize_forced(FIX, [-1] + [1] * (len(FIX) - 1))
    with pytest.raises(ValueError, match="non-zero"):
        rt.synthesize_forced(FIX, [0] * len(FIX))
    with pytest.raises(ValueError, match="non-zero"):
        rt.synthesize_batch_forced([FIX, FIX], [[2] * len(FIX), [0] * len(FIX)])
    with pytest.raises(ValueError, match="duration rows"):
        rt.synthesize_batch_forced([FIX, FIX], [[1] * len(FIX)])
    with pytest.raises(ValueError, match="pad_rows_to 1 < batch size 2"):
        rt.synthesize_batch_forced([FIX, FIX], [[1] * len(FIX)] * 2, pad_rows_to=1)


def test_forced_truncates_at_the_largest_bucket(rt):
    cap = rt.options.frame_buckets[-1]
    durs = [0] * len(FIX)
    durs[0] = cap + 50
    audio = rt.synthesize_forced(FIX, durs)
    assert len(audio) == cap * rt.hparams.hop_length


def test_phoneme_durations_pad_rows_to(rt):
    """A pinned row count (row-0 copies) leaves every real row's plan as
    it is: the draw is per row."""
    rows = [FIX, FIX[:6]]
    free = rt.phoneme_durations(rows, seed=2)
    pinned = rt.phoneme_durations(rows, seed=2, pad_rows_to=8)
    for a, b in zip(free, pinned):
        np.testing.assert_array_equal(a, b)
    assert [len(d) for d in pinned] == [14, 6]
    with pytest.raises(ValueError, match="pad_rows_to 1 < batch size 2"):
        rt.phoneme_durations(rows, pad_rows_to=1)


def test_alignment_spans_sum_to_the_audio(rt):
    audio, al = rt.synthesize_with_alignment(FIX, seed=5)
    np.testing.assert_array_equal(audio, rt.synthesize(FIX, seed=5))
    hop = rt.hparams.hop_length
    assert al.total_samples == len(audio) == al.total_frames * hop and not al.truncated
    assert al.start_samples[0] == 0 and al.end_samples[-1] == len(audio)
    assert int(np.sum(al.end_samples - al.start_samples)) == len(audio)
    np.testing.assert_array_equal(al.start_samples[1:], al.end_samples[:-1])


def test_alignment_with_speakers(ms_rt):
    for spk in ({"speaker_id": 3}, {"speaker_mix": {2: 0.5, 3: 0.5}}):
        audio, al = ms_rt.synthesize_with_alignment(FIX, seed=9, **spk)
        assert al.total_samples == len(audio) == al.total_frames * ms_rt.hparams.hop_length


def test_alignment_truncation_clips_spans(tiny_voice):
    rt = PiperRuntime(*tiny_voice, RuntimeOptions(frame_buckets=(8,)), device="cpu")
    audio, al = rt.synthesize_with_alignment(FIX, seed=5)
    assert len(audio) == 8 * rt.hparams.hop_length
    assert al.truncated and al.total_frames > 8
    assert al.end_samples[-1] == len(audio) and (al.end_samples <= len(audio)).all()

