"""Incremental streaming on the port against the JAX package, on the CPU.

decode_window is held to JAX's decode_window(use_pallas=True), its Pallas
kernels in interpret mode, on two small vocoders that route their levels
through the kernels' plain versions: K2 and K3 (ResBlock1 at C=64 and C=32)
and K1 (ResBlock2, ROUTES2). The runtime's synthesize_stream_incremental is
held to the JAX runtime's with the same injected noise, on the tiny test
voice and a 4-speaker one. Bars: 1e-4 max-abs at fp32, 1e-3 at "high"
(BASELINE.md's gate for the lowered tiers). The rest ports the JAX
package's tests/test_streaming.py to the port, and checks the per-frame
noise, the batched dispatch methods, the lock and the kernel counters.
"""

import threading
from dataclasses import replace
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from piper_tpu.models.vits import model as jv
from piper_tpu.models.vits.params import params_from_arrays
from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIX
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
from piper_tpu_torch.models.vits import model as tv
from piper_tpu_torch.models.vits.hparams import receptive_field_frames
from piper_tpu_torch.models.vits.params import params_to_torch
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice, synthetic_params
from piper_tpu_torch.ops.kernels import conv as K1
from piper_tpu_torch.ops.kernels import folded as K4
from piper_tpu_torch.ops.kernels import interleave as K5
from piper_tpu_torch.ops.kernels import resblock as R
from test_torch_model import ROUTES, ROUTES2, _jhp

WAVE_ATOL, MIXED_ATOL = 1e-4, 1e-3
# ROUTES' kernel routes with two branches of two dilations, which keeps
# the interpret-mode compile of JAX's kernels short: level 0 (C=64) runs
# the branch kernel K2, level 1 (C=32) the MRF kernel K3.
K23 = replace(ROUTES, upsample_initial_channel=128, upsample_rates=[2, 2],
              upsample_kernel_sizes=[4, 4], resblock_kernel_sizes=[3, 5],
              resblock_dilation_sizes=[[1, 3]] * 2)
WINDOW = 24
# A batch row against its solo run on the CPU: the same fp32 sums, which
# PyTorch's CPU convs order by the batch's shape.
ROW_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- per-frame noise -----------------------------------------------------------


def test_per_frame_noise_overlapping_windows_agree():
    a = tv.per_frame_noise(7, torch.arange(-5, 20), 2, 16)
    b = tv.per_frame_noise(torch.tensor(7), torch.arange(10, 40), 2, 16)
    assert a.shape == (2, 16, 25) and b.shape == (2, 16, 30)
    assert torch.equal(a[..., 15:], b[..., :10])  # frames 10..19
    assert not torch.equal(a[0], a[1])  # the rows of one draw differ
    assert not torch.equal(a, tv.per_frame_noise(8, torch.arange(-5, 20), 2, 16))


def test_per_row_frame_noise_equals_each_solo_draw():
    seeds = [3, 2 ** 32 + 3, 99, -1]  # seeds wrap mod 2^32, as the runtime's
    t_idx = torch.tensor([[-4, -3, -2, -1, 0, 1], [0, 1, 2, 3, 4, 5],
                          [100, 101, 102, 103, 104, 105], [7, 8, 9, 10, 11, 12]])
    rows = tv.per_row_frame_noise(seeds, t_idx, 24)
    assert rows.shape == (4, 24, 6)
    for r, s in enumerate(seeds):
        assert torch.equal(rows[r], tv.per_frame_noise(s, t_idx[r], 1, 24)[0])
    assert torch.equal(rows[0, :, 4:], rows[1, :, :2])  # one seed, frames 0 and 1
    assert torch.equal(rows, tv.per_row_frame_noise(torch.tensor(seeds) & 0xFFFFFFFF,
                                                    t_idx, 24))


def test_per_frame_noise_is_standard_normal():
    z = tv.per_frame_noise(1234, torch.arange(1000), 1, 100).flatten()
    assert z.numel() == 10 ** 5 and torch.isfinite(z).all()
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01


# -- decode_window against JAX ---------------------------------------------------


def _encoders(hp, seed):
    """JAX's and the port's EncodeResult of the same 4 rows (w_ceil equal)
    and the parameters of both."""
    w = synthetic_params(hp, seed=seed)
    jp, tp = params_from_arrays(w), params_to_torch(w, "cpu")
    rng = np.random.default_rng(seed)
    b, p = 4, 12
    ids = rng.integers(0, hp.n_vocab, size=(b, p))
    lengths = np.array([12, 9, 12, 7])
    dp = rng.standard_normal((b, 2, p)).astype(np.float32)
    j_enc = jax.jit(partial(jv.encode, hp=_jhp(hp)))(
        jp, phoneme_ids=jnp.asarray(ids), lengths=jnp.asarray(lengths), dp_noise=jnp.asarray(dp))
    with torch.inference_mode():
        t_enc = tv.encode(tp, hp, torch.from_numpy(ids), torch.from_numpy(lengths),
                          torch.from_numpy(dp))
    np.testing.assert_array_equal(t_enc.w_ceil.numpy(), np.asarray(j_enc.w_ceil))
    return jp, tp, j_enc, t_enc


def _windows_both(hp, jp, tp, j_enc, t_enc, noise, t_offset, total, precision):
    j_fn = jax.jit(partial(jv.decode_window, hp=_jhp(hp), window=WINDOW,
                           vocoder_precision=precision, flow_precision=precision,
                           use_pallas=True))
    want = j_fn(jp, enc=j_enc, main_noise_win=jnp.asarray(noise),
                t_offset=jnp.asarray(t_offset, jnp.int32),
                total_frames=jnp.asarray(total, jnp.int32))
    with torch.inference_mode():
        got = tv.decode_window(tp, hp, t_enc, torch.from_numpy(noise),
                               torch.as_tensor(t_offset), window=WINDOW,
                               total_frames=torch.as_tensor(total),
                               vocoder_precision=precision, flow_precision=precision)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("precision", [None, "high"])
@pytest.mark.parametrize("hp", [K23, ROUTES2], ids=["k2k3", "k1"])
def test_decode_window_matches_pallas_per_row(monkeypatch, hp, precision):
    """One window per row at independent offsets: the first window (left
    halo masked), a middle one, one crossing y_len and one wholly past it,
    each row at its own total."""
    monkeypatch.setenv("PIPER_TPU_PALLAS_INTERPRET", "1")
    jp, tp, j_enc, t_enc = _encoders(hp, seed=3)
    y_len = np.asarray(j_enc.y_total).astype(np.int64)
    halo = receptive_field_frames(hp)
    t_off = np.array([-halo, 4, y_len[2] - WINDOW // 2, y_len[3] + 3])
    assert y_len[1] >= 4 + WINDOW  # the middle row's window lies inside its sequence
    noise = np.random.default_rng(4).standard_normal(
        (4, hp.inter_channels, WINDOW)).astype(np.float32)
    before = (R.resblock1_branch.launches, R.resblock1_mrf.launches, K1.conv1d_same.launches)
    got, want = _windows_both(hp, jp, tp, j_enc, t_enc, noise, t_off, y_len, precision)
    assert (R.resblock1_branch.launches, R.resblock1_mrf.launches,
            K1.conv1d_same.launches) == before  # CPU tensors: the plain versions
    assert got.shape == want.shape == (4, WINDOW * hp.hop_length)
    np.testing.assert_allclose(got, want, atol=MIXED_ATOL if precision else WAVE_ATOL, rtol=0)
    assert not got[3].any()  # the window past y_len is silent
    assert not got[0, : halo * hp.hop_length].any()  # the left halo lies before frame 0


def test_decode_window_scalar_offset_matches_pallas(monkeypatch):
    """A scalar offset and total (one stream at B rows) against JAX, and the
    same window given as per-row tensors."""
    monkeypatch.setenv("PIPER_TPU_PALLAS_INTERPRET", "1")
    hp = ROUTES2
    jp, tp, j_enc, t_enc = _encoders(hp, seed=3)
    noise = np.random.default_rng(5).standard_normal(
        (4, hp.inter_channels, WINDOW)).astype(np.float32)
    got, want = _windows_both(hp, jp, tp, j_enc, t_enc, noise, 10, 30, None)
    np.testing.assert_allclose(got, want, atol=WAVE_ATOL, rtol=0)
    with torch.inference_mode():
        rows = tv.decode_window(tp, hp, t_enc, torch.from_numpy(noise), torch.full((4,), 10),
                                window=WINDOW, total_frames=torch.full((4,), 30))
    np.testing.assert_array_equal(rows.numpy(), got)


# -- the runtime against the JAX runtime -------------------------------------------


@pytest.fixture(scope="module")
def rt(tiny_voice):
    return PiperRuntime(*tiny_voice, device="cpu")


def _injected(rt, ids, seed, frames=None):
    """dp_noise (1, 2, P), the frame bucket of a run with it, and main_noise
    (1, C, bucket)."""
    rng = np.random.default_rng(seed)
    dp = rng.standard_normal((1, 2, len(ids))).astype(np.float32)
    rt.synthesize(ids, dp_noise=dp)
    fb = frames or rt.last_run_timings.frame_bucket
    mn = rng.standard_normal((1, rt.hparams.inter_channels, fb)).astype(np.float32)
    return dp, fb, mn


def _chunks_equal(got, want, atol=WAVE_ATOL):
    assert [c.start_sample_index for c in got] == [c.start_sample_index for c in want]
    assert [len(c.samples) for c in got] == [len(c.samples) for c in want]
    assert [c.is_final for c in got] == [c.is_final for c in want]
    assert all(c.samples.dtype == w.samples.dtype for c, w in zip(got, want))
    np.testing.assert_allclose(np.concatenate([c.samples for c in got]),
                               np.concatenate([c.samples for c in want]), atol=atol, rtol=0)


@pytest.mark.parametrize("kw", [{"chunk_frames": 16}, {}], ids=["fixed16", "growing"])
def test_incremental_matches_reference_runtime(rt, tiny_runtime, kw):
    """The same injected dp_noise, main_noise and total_frames through both
    runtimes: the same chunks, offsets, sizes and finality, the audio
    within 1e-4."""
    ids = FIX * 4
    dp, fb, mn = _injected(rt, ids, seed=21)
    noise = dict(dp_noise=dp, main_noise=mn, total_frames=fb)
    got = list(rt.synthesize_stream_incremental(ids, **kw, **noise))
    want = list(tiny_runtime.synthesize_stream_incremental(ids, **kw, **noise))
    assert len(got) > 1
    _chunks_equal(got, want)


@pytest.fixture(scope="module")
def ms_voice(tmp_path_factory):
    return make_synthetic_voice(tmp_path_factory.mktemp("ms_stream"), quality="test", seed=6,
                                n_speakers=4, gin_channels=32)


@pytest.mark.parametrize("spk", [{"speaker_id": 2}, {"speaker_mix": {0: 0.6, 3: 0.4}}],
                         ids=["id", "mix"])
def test_incremental_speakers_match_reference_runtime(ms_voice, spk):
    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime

    port, ref = PiperRuntime(*ms_voice, device="cpu"), JaxRuntime(*ms_voice)
    dp, fb, mn = _injected(port, FIX, seed=22)
    noise = dict(dp_noise=dp, main_noise=mn, total_frames=fb, chunk_frames=16)
    got = list(port.synthesize_stream_incremental(FIX, **spk, **noise))
    _chunks_equal(got, list(ref.synthesize_stream_incremental(FIX, **spk, **noise)))
    # Another speaker is another stream.
    other = list(port.synthesize_stream_incremental(FIX, speaker_id=1, **noise))
    a, b = (np.concatenate([c.samples for c in s]) for s in (got, other))
    assert a.shape != b.shape or not np.allclose(a, b)


# -- tests/test_streaming.py on the port ------------------------------------------


def test_receptive_field_of_the_presets():
    from piper_tpu_torch.models.vits.hparams import PRESETS

    assert [receptive_field_frames(PRESETS[q]) for q in ("test", "x_low", "medium")] == [
        15, 45, 47]


def test_incremental_matches_full_decode(rt):
    ids = FIX * 3
    dp, fb, mn = _injected(rt, ids, seed=11)
    full = rt.synthesize(ids, dp_noise=dp, main_noise=mn)
    chunks = list(rt.synthesize_stream_incremental(ids, chunk_frames=16, dp_noise=dp,
                                                   main_noise=mn, total_frames=fb))
    assert chunks[-1].is_final and not any(c.is_final for c in chunks[:-1])
    streamed = np.concatenate([c.samples for c in chunks])
    assert len(streamed) == len(full)
    np.testing.assert_allclose(streamed, full, atol=1e-5, rtol=0)
    sizes = [len(c.samples) for c in chunks]
    assert [c.start_sample_index for c in chunks] == [sum(sizes[:i]) for i in range(len(sizes))]
    assert chunks[0].format.sample_rate == rt.sample_rate


def test_incremental_seeded_deterministic(rt):
    a1, a2 = (np.concatenate([c.samples for c in rt.synthesize_stream(FIX, incremental=True)])
              for _ in range(2))
    np.testing.assert_array_equal(a1, a2)
    assert len(a1) > 0 and np.isfinite(a1).all()


def test_incremental_chunk_boundaries_consistent(rt):
    dp, fb, mn = _injected(rt, FIX, seed=12)
    kw = dict(dp_noise=dp, main_noise=mn, total_frames=fb)
    a16, a8 = (np.concatenate([c.samples for c in rt.synthesize_stream_incremental(
        FIX, chunk_frames=n, **kw)]) for n in (16, 8))
    assert len(a16) == len(a8)
    np.testing.assert_allclose(a16, a8, atol=1e-5, rtol=0)


def test_insufficient_halo_detectable(rt):
    """A halo far below the receptive field must not reproduce the full
    decode: the exactness tests have teeth."""
    ids = FIX * 3
    dp, fb, mn = _injected(rt, ids, seed=13)
    full = rt.synthesize(ids, dp_noise=dp, main_noise=mn)
    streamed = np.concatenate([c.samples for c in rt.synthesize_stream_incremental(
        ids, chunk_frames=16, halo_frames=1, dp_noise=dp, main_noise=mn, total_frames=fb)])
    assert np.abs(streamed - full).max() > 1e-4


def test_growing_schedule_matches_fixed(rt):
    ids = FIX * 4
    dp, fb, mn = _injected(rt, ids, seed=14)
    kw = dict(dp_noise=dp, main_noise=mn, total_frames=fb)
    fixed = np.concatenate([c.samples for c in rt.synthesize_stream_incremental(
        ids, chunk_frames=16, **kw)])
    grown = list(rt.synthesize_stream_incremental(ids, chunk_schedule=(8, 16, 32), **kw))
    hop = rt.hparams.hop_length
    sizes = [len(c.samples) for c in grown]
    assert sizes[0] == 8 * hop and sizes[1] == 16 * hop and len(sizes) > 3
    assert all(s == 32 * hop for s in sizes[2:-1])
    streamed = np.concatenate([c.samples for c in grown])
    assert len(streamed) == len(fixed)
    np.testing.assert_allclose(streamed, fixed, atol=1e-5, rtol=0)
    assert [c.start_sample_index for c in grown] == [sum(sizes[:i]) for i in range(len(sizes))]
    assert grown[-1].is_final


def test_fused_head_matches_split_seeded(rt):
    """The fused head (encode and window 0 with no host read, window 1
    queued on the device-held frame count) and the split path give the same
    stream, bit for bit on the CPU."""
    ids = FIX * 4
    fused = list(rt.synthesize_stream_incremental(ids, chunk_schedule=(8, 16, 32), seed=7))
    split = list(rt.synthesize_stream_incremental(ids, chunk_schedule=(8, 16, 32), seed=7,
                                                  fused_head=False))
    assert len(fused) > 2
    _chunks_equal(fused, split, atol=0)
    assert ("stream_head", (64, 8, 15, None)) in rt._compiled_keys


def test_fused_head_single_window_stream(rt):
    ref = rt.synthesize(FIX, seed=3)
    chunks = list(rt.synthesize_stream_incremental(FIX, chunk_frames=4096, seed=3))
    assert len(chunks) == 1 and chunks[0].is_final and chunks[0].start_sample_index == 0
    assert len(chunks[0].samples) == len(ref)


def test_fused_head_rejects_injected_noise(rt):
    dp = np.zeros((1, 2, len(FIX)), np.float32)
    with pytest.raises(ValueError, match="seeded-only"):
        list(rt.synthesize_stream_incremental(FIX, dp_noise=dp, fused_head=True))


def test_request_errors(rt):
    with pytest.raises(ValueError, match="empty phoneme sequence"):
        next(rt.synthesize_stream_incremental([]))
    with pytest.raises(ValueError, match="out of range"):
        next(rt.synthesize_stream(FIX + [10 ** 6], incremental=True))
    with pytest.raises(ValueError, match="out of range"):
        rt.dispatch_stream_head([1, -1, 2], c0=8, halo=15)


@pytest.mark.parametrize("incremental", [True, False])
def test_int16_chunks(tiny_voice, incremental):
    rt16 = PiperRuntime(*tiny_voice, RuntimeOptions(output_dtype="int16"), device="cpu")
    chunks = list(rt16.synthesize_stream(FIX * 2, incremental=incremental, seed=2))
    assert rt16.np_output_dtype is np.int16
    assert all(c.samples.dtype == np.int16 for c in chunks) and chunks[-1].is_final
    if incremental:
        f32 = np.concatenate([c.samples for c in PiperRuntime(*tiny_voice, device="cpu")
                              .synthesize_stream(FIX * 2, incremental=True, seed=2)])
        want = (np.clip(f32, -1.0, 1.0) * 32767.0).astype(np.int16)
        np.testing.assert_array_equal(np.concatenate([c.samples for c in chunks]), want)


def test_synthesize_stream_chunks_the_full_synthesis(rt):
    audio = rt.synthesize(FIX, seed=4)
    chunks = list(rt.synthesize_stream(FIX, chunk_size=1000, seed=4))
    assert [c.start_sample_index for c in chunks] == list(range(0, len(audio), 1000))
    np.testing.assert_array_equal(np.concatenate([c.samples for c in chunks]), audio)
    assert chunks[-1].is_final and not chunks[0].is_final


# -- batched dispatch ---------------------------------------------------------------


def test_batched_head_rows_equal_solo_heads(rt):
    """Four streams in one phoneme bucket at their own seeds and scales:
    row r of the batched head is the solo head's emitted region."""
    hop, halo, c0 = rt.hparams.hop_length, 15, 8
    rows = [FIX, FIX[:10], FIX[3:], FIX[1:13]]  # each alone in the same bucket, 16
    seeds = [1, 2, 3, 4]
    scales = [0.667, 0.5, 0.8, 0.3]
    enc, audio0, totals, seed_vals, ns_vals = rt.dispatch_stream_head_batch(
        rows, c0=c0, halo=halo, seeds=seeds, noise_scales=scales)
    assert (seed_vals, ns_vals) == (seeds, scales)
    assert audio0.shape == (4, c0 * hop)
    for r, ids in enumerate(rows):
        e1, a1, t1, s1, ns1 = rt.dispatch_stream_head(ids, c0=c0, halo=halo, seed=seeds[r],
                                                      noise_scale=scales[r])
        assert a1.shape == (1, (c0 + 2 * halo) * hop) and (int(s1), ns1) == (seeds[r], scales[r])
        assert int(t1) == int(totals[r])
        np.testing.assert_allclose(audio0[r].numpy(),
                                   a1[0, halo * hop: (halo + c0) * hop].numpy(), atol=ROW_ATOL,
                                   rtol=0)


def test_window_batch_rows_equal_solo_windows(rt):
    """dispatch_window_batch with rows at different offsets, one past its
    end: each row equals decode_window of its stream alone with its own
    per-frame noise, the row past its end is exactly zero."""
    hp, halo, c = rt.hparams, 15, 16
    hop, window = hp.hop_length, c + 2 * halo
    rows = [FIX, FIX[:10], (FIX * 2)[:20]]
    enc, _, totals, seed_vals, ns_vals = rt.dispatch_stream_head_batch(
        rows, c0=8, halo=halo, seeds=[5, 6, 7])
    y_len = totals.numpy()
    t_off = np.array([8 - halo, 3, int(y_len[2]) + 1 - halo])  # row 2 starts past its end
    audio = rt.dispatch_window_batch(enc, seed_vals, t_off, y_len, ns_vals, emit_frames=c,
                                     halo=halo)
    assert audio.shape == (3, c * hop)
    assert not audio[2].any()
    with torch.inference_mode():
        for r in range(2):
            enc_r = tv.EncodeResult(*(None if v is None else v[r:r + 1] for v in (
                enc.m_p, enc.logs_p, enc.x_mask, enc.w, enc.w_ceil, enc.y_total, enc.g)))
            t_idx = int(t_off[r]) + torch.arange(window)
            noise = tv.per_frame_noise(seed_vals[r], t_idx, 1, hp.inter_channels)
            solo = tv.decode_window(rt.params, hp, enc_r, noise, int(t_off[r]), window=window,
                                    total_frames=int(y_len[r]), noise_scale=ns_vals[r])
            np.testing.assert_allclose(audio[r].numpy(),
                                       solo[0, halo * hop: (halo + c) * hop].numpy(),
                                       atol=ROW_ATOL, rtol=0)


# -- the lock and the counters --------------------------------------------------------


def test_abandoned_stream_does_not_hold_the_lock(rt):
    it = rt.synthesize_stream_incremental(FIX * 3, chunk_frames=16, seed=1)
    next(it)  # window 1 is in flight; the generator is suspended at its yield
    out = {}

    def other():
        out["acquired"] = rt._lock.acquire(timeout=10)
        if out["acquired"]:
            rt._lock.release()
            out["audio"] = rt.synthesize(FIX, seed=1)

    t = threading.Thread(target=other, name="piper-test-lock")
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and out["acquired"] and len(out["audio"]) > 0
    it.close()


def test_cpu_streams_launch_no_kernel(rt):
    counters = (R.resblock1_branch, R.resblock1_mrf, K1.conv1d_same,
                K4.resblock1_mrf_folded, K5.interleave)
    before = [c.launches for c in counters]
    list(rt.synthesize_stream(FIX * 2, incremental=True, seed=9))
    enc, _, totals, seeds, ns = rt.dispatch_stream_head_batch([FIX, FIX], c0=8, halo=15)
    rt.dispatch_window_batch(enc, seeds, [0, 5], totals, ns, emit_frames=8, halo=15)
    assert [c.launches for c in counters] == before
