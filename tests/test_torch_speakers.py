"""Multi-speaker voices on the port against the JAX package, on the CPU.

The voice is the test preset with 4 speakers and gin 32 (the JAX package's
tests/test_speaker_mix.py voice), written by the port's
make_synthetic_voice (byte-identical to the JAX package's) and loaded by
both runtimes. Bars: `speaker_embedding` within 1e-6 and a one-hot mix
bit-equal to its id; module tensors within 2e-5 (logw 5e-5) and `w_ceil`
equal; the waveform within 1e-4 with injected noise. The rest holds the
JAX package's rules in the port: names, mixes, validation before any
device work, batches, dispatch/fetch, the fused overflow redo and the
serving pipeline.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIX
from piper_tpu_torch.engine.pipeline import ServingPipeline
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
from piper_tpu_torch.models.vits import model as tv
from piper_tpu_torch.models.vits.params import params_to_torch
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice, synthetic_params

MODULE_ATOL, LOGW_ATOL, WAVE_ATOL, EMB_ATOL = 2e-5, 5e-5, 1e-4, 1e-6
ROWS = [FIX, FIX[:8], FIX * 2]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ms_voice(tmp_path_factory):
    return make_synthetic_voice(tmp_path_factory.mktemp("ms_voice"), quality="test", seed=6,
                                n_speakers=4, gin_channels=32)


@pytest.fixture(scope="module")
def rt(ms_voice):
    return PiperRuntime(*ms_voice, device="cpu")


@pytest.fixture(scope="module")
def jrt(ms_voice):
    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime

    return JaxRuntime(*ms_voice)


def _noise(rt, rows, frames=60, seed=0):
    rng = np.random.default_rng(seed)
    width = max(len(r) for r in rows)
    dp = rng.standard_normal((len(rows), 2, width)).astype(np.float32)
    for i, r in enumerate(rows):
        dp[i, :, len(r):] = 0.0
    return dp, rng.standard_normal((len(rows), rt.hparams.inter_channels, frames)).astype(
        np.float32)


# -- the model: speaker_embedding, encode/decode with sid, encode_forced -------------


@pytest.fixture(scope="module")
def model_pair(rt, jrt):
    """(hparams, JAX params, port params) of the voice."""
    from piper_tpu.models.vits.params import params_from_arrays

    arrays = synthetic_params(rt.hparams, seed=6)
    return rt.hparams, jrt.hparams, params_from_arrays(arrays), params_to_torch(arrays, "cpu")


SIDS = [np.array([0, 3, 1]), np.array([[1.2, -0.2, 0, 0], [0, 0, 0.3, 0.7], [0, 1.0, 0, 0]],
                                      np.float32)]


@pytest.mark.parametrize("sid", SIDS, ids=["ids", "mixes"])
def test_speaker_embedding_matches_reference(model_pair, sid):
    from piper_tpu.models.vits.model import speaker_embedding as j_emb

    hp, jhp, jp, tp = model_pair
    want = np.asarray(j_emb(jp, jhp, jnp.asarray(sid)))
    got = tv.speaker_embedding(tp, hp, torch.from_numpy(sid))
    assert got.shape == want.shape == (3, hp.gin_channels, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=EMB_ATOL, rtol=0)


def test_one_hot_embedding_equals_the_lookup(model_pair):
    """A one-hot row adds exact zeros to its speaker's row: bit-equal."""
    hp, _, _, tp = model_pair
    ids = torch.arange(hp.n_speakers)
    onehot = torch.eye(hp.n_speakers)
    assert torch.equal(tv.speaker_embedding(tp, hp, onehot),
                       tv.speaker_embedding(tp, hp, ids))
    assert tv.speaker_embedding(tp, hp, ids).dtype == torch.float32
    with pytest.raises(ValueError, match="requires a speaker id"):
        tv.speaker_embedding(tp, hp, None)


def _inputs(hp, b=2, p=12, frames=48, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, hp.n_vocab, size=(b, p))
    lengths = np.array([p, p - 4][:b])
    return (ids, lengths, rng.standard_normal((b, 2, p)).astype(np.float32),
            rng.standard_normal((b, hp.inter_channels, frames)).astype(np.float32))


@pytest.mark.parametrize("sid", [np.array([2, 0]), np.array([[0.5, 0, 0, 0.5],
                                                             [0, 1.2, -0.2, 0]], np.float32)],
                         ids=["ids", "mixes"])
def test_encode_decode_with_sid_match_reference(model_pair, sid):
    """debug_infer's module tensors (logw at 5e-5, w_ceil equal), encode's
    g, and decode's waveform (bounds: the kernels' routes)."""
    from piper_tpu.models.vits import model as jv

    hp, jhp, jp, tp = model_pair
    ids, lengths, dpn, mn = _inputs(hp)
    j_sid, t_sid = jnp.asarray(sid), torch.from_numpy(sid)
    want = jv.debug_infer(jp, jhp, jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(dpn),
                          jnp.asarray(mn), max_frames=48, sid=j_sid)
    j_enc = jv.encode(jp, jhp, jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(dpn),
                      sid=j_sid)
    j_audio, j_len = jv.decode(jp, jhp, j_enc, jnp.asarray(mn), max_frames=48)
    with torch.inference_mode():
        got = tv.debug_infer(tp, hp, torch.from_numpy(ids), torch.from_numpy(lengths),
                             torch.from_numpy(dpn), torch.from_numpy(mn), max_frames=48,
                             sid=t_sid)
        t_enc = tv.encode(tp, hp, torch.from_numpy(ids), torch.from_numpy(lengths),
                          torch.from_numpy(dpn), sid=t_sid)
        t_audio, t_len = tv.decode(tp, hp, t_enc, torch.from_numpy(mn), max_frames=48)
    for key, w in want.items():
        if key not in got:
            continue
        atol = (0 if key in ("w_ceil", "y_lengths", "x_mask", "y_mask", "path")
                else LOGW_ATOL if key == "logw" else WAVE_ATOL if key == "audio"
                else MODULE_ATOL)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w), atol=atol, rtol=0,
                                   err_msg=key)
    np.testing.assert_allclose(t_enc.g.numpy(), np.asarray(j_enc.g), atol=EMB_ATOL, rtol=0)
    np.testing.assert_array_equal(t_enc.w_ceil.numpy(), np.asarray(j_enc.w_ceil))
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    np.testing.assert_allclose(t_audio.numpy(), np.asarray(j_audio), atol=WAVE_ATOL, rtol=0)


def test_encode_forced_matches_reference(model_pair):
    """The caller's plan, masked past each row's length: w_ceil and y_total
    equal, the prior within 2e-5, the decoded waveform within 1e-4."""
    from piper_tpu.models.vits import model as jv

    hp, jhp, jp, tp = model_pair
    ids, lengths, _, mn = _inputs(hp, seed=1)
    durs = np.random.default_rng(2).integers(0, 4, size=ids.shape)
    sid = np.array([3, 1])
    j_enc = jv.encode_forced(jp, jhp, jnp.asarray(ids), jnp.asarray(lengths),
                             jnp.asarray(durs), sid=jnp.asarray(sid))
    j_audio, _ = jv.decode(jp, jhp, j_enc, jnp.asarray(mn), max_frames=48)
    with torch.inference_mode():
        t_enc = tv.encode_forced(tp, hp, torch.from_numpy(ids), torch.from_numpy(lengths),
                                 torch.from_numpy(durs), sid=torch.from_numpy(sid))
        t_audio, _ = tv.decode(tp, hp, t_enc, torch.from_numpy(mn), max_frames=48)
    np.testing.assert_array_equal(t_enc.w_ceil.numpy(), np.asarray(j_enc.w_ceil))
    np.testing.assert_array_equal(t_enc.y_total.numpy(), np.asarray(j_enc.y_total))
    assert float(t_enc.w_ceil[1, lengths[1]:].abs().sum()) == 0.0
    for name in ("m_p", "logs_p"):
        np.testing.assert_allclose(getattr(t_enc, name).numpy(),
                                   np.asarray(getattr(j_enc, name)), atol=MODULE_ATOL, rtol=0)
    np.testing.assert_allclose(t_audio.numpy(), np.asarray(j_audio), atol=WAVE_ATOL, rtol=0)


# -- the runtime against the JAX runtime -------------------------------------------


@pytest.mark.parametrize("speaker", [{"speaker_id": 3}, {"name": "spk2"},
                                     {"speaker_mix": {0: 0.6, 3: 0.4}},
                                     {"speaker_mix": {"spk1": 1.2, 2: -0.2}}],
                         ids=["id", "name", "mix", "named_mix"])
def test_synthesize_speakers_match_reference(rt, jrt, speaker):
    """A speaker id, a name (resolved by speaker_index) and mixes (named
    keys through resolve_speaker_mix), with injected noise: equal lengths,
    within 1e-4 of the JAX runtime."""
    if "name" in speaker:
        assert rt.speaker_index(speaker["name"]) == jrt.speaker_index(speaker["name"])
        speaker = {"speaker_id": rt.speaker_index(speaker["name"])}
    if "speaker_mix" in speaker:
        mix = rt.resolve_speaker_mix(speaker["speaker_mix"])
        assert mix == jrt.resolve_speaker_mix(speaker["speaker_mix"])
        speaker = {"speaker_mix": mix}
    dp, mn = _noise(rt, [FIX])
    got = rt.synthesize(FIX, dp_noise=dp[0], main_noise=mn[0], **speaker)
    want = jrt.synthesize(FIX, dp_noise=dp[0], main_noise=mn[0], **speaker)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=WAVE_ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["ids", "mixes"])
def test_injected_speaker_batch_matches_reference(rt, jrt, kind):
    """Rows of 14, 8 and 28 ids, each its own speaker, in one batch: each
    row within 1e-4 of the JAX runtime's batch."""
    dp, mn = _noise(rt, ROWS, frames=80)
    spk = (dict(speaker_ids=[3, 0, 2]) if kind == "ids" else
           dict(speaker_ids=None, speaker_mixes=[{1: 1.0}, {0: 0.5, 2: 0.5}, {3: 1.2, 0: -0.2}]))
    kw = dict(noise_scale=None, length_scale=None, noise_w=None, dp_noise=dp, main_noise=mn,
              **spk)
    got, _ = rt._synthesize_batch_impl(ROWS, **kw)
    want, _ = jrt._synthesize_batch_impl(ROWS, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=WAVE_ATOL, rtol=0)


def test_phoneme_durations_match_reference(rt, jrt, monkeypatch):
    """Both runtimes' public phoneme_durations, with the seeded duration
    noise replaced by one injected draw, for speaker ids and for mixes, at
    the ladder's padded rows: equal plans."""
    import piper_tpu_torch.engine.runtime as port_runtime

    rows = [FIX, FIX[:6], FIX]
    dpn = np.random.default_rng(5).standard_normal((2, 16)).astype(np.float32)

    def injected(seed, stream, shape, b, device):
        assert stream == 0 and shape == (2, 16)
        return torch.from_numpy(dpn).expand(b, 2, 16)

    monkeypatch.setattr(port_runtime, "seeded_noise", injected)
    j_inj = jrt._encode_injected

    def j_keyed(params, ids, lengths, seed, ls, nw, sid):
        return j_inj(params, ids, lengths, jnp.broadcast_to(jnp.asarray(dpn), (ids.shape[0], 2, 16)),
                     ls, nw, sid)

    monkeypatch.setattr(jrt, "_encode_keyed", j_keyed)
    for spk in (dict(speaker_ids=[3, 1, 0]),
                dict(speaker_mixes=[{0: 0.5, 1: 0.5}, {2: 1.0}, {3: 0.9, 0: 0.1}])):
        got = rt.phoneme_durations(rows, length_scale=1.3, noise_w=0.5, seed=1, **spk)
        want = jrt.phoneme_durations(rows, length_scale=1.3, noise_w=0.5, seed=1, **spk)
        assert [len(d) for d in got] == [len(r) for r in rows]
        for g, w in zip(got, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, np.asarray(w))


# -- the runtime's own rules -------------------------------------------------------


def test_one_hot_mix_bit_identical_to_id(rt):
    for k in range(4):
        a = rt.synthesize(FIX, speaker_id=k, seed=2)
        assert np.array_equal(a, rt.synthesize(FIX, speaker_mix={k: 1.0}, seed=2))
    blend = rt.synthesize(FIX, speaker_mix={0: 0.5, 2: 0.5}, seed=2)
    assert np.isfinite(blend).all() and len(blend) > 0
    assert len(rt.synthesize(FIX, speaker_mix={0: 1.2, 1: -0.2})) > 0  # extrapolation


@pytest.mark.parametrize("kind", ["ids", "mixes"])
def test_batch_equals_its_rows(rt, kind):
    """synthesize_batch with a speaker per row equals each row run alone
    (injected noise: a row's frame bucket then carries no noise of its
    own), within 1e-4; seeded identical rows equal their single run."""
    dp, mn = _noise(rt, ROWS, frames=80, seed=3)
    spk = ([{"speaker_ids": [s]} for s in (2, 3, 0)] if kind == "ids" else
           [{"speaker_ids": None, "speaker_mixes": [m]}
            for m in ({0: 1.0}, {2: 0.3, 3: 0.7}, {1: 0.5, 0: 0.5})])
    batch_kw = ({"speaker_ids": [2, 3, 0]} if kind == "ids" else
                {"speaker_ids": None, "speaker_mixes": [s["speaker_mixes"][0] for s in spk]})
    kw = dict(noise_scale=None, length_scale=None, noise_w=None)
    got, _ = rt._synthesize_batch_impl(ROWS, dp_noise=dp, main_noise=mn, **batch_kw, **kw)
    for i, r in enumerate(ROWS):
        (one,), _ = rt._synthesize_batch_impl([r], dp_noise=dp[i:i + 1, :, :len(r)],
                                              main_noise=mn[i:i + 1], **spk[i], **kw)
        assert got[i].shape == one.shape
        np.testing.assert_allclose(got[i], one, atol=WAVE_ATOL, rtol=0)
    single = rt.synthesize(FIX, speaker_id=1, seed=11)
    for row in rt.synthesize_batch([FIX] * 3, speaker_ids=[1, 1, 1], seed=11):
        np.testing.assert_allclose(row, single, atol=WAVE_ATOL, rtol=0)


def test_ladder_dummy_rows_copy_row_0(ms_voice):
    """Three rows pad to the 4-row rung with row 0's ids and speaker (or
    mix): equal, row for row, to a 4-row call that repeats row 0; the keys
    carry the speaker kind."""
    rt = PiperRuntime(*ms_voice, device="cpu")
    rows = [FIX, FIX[:8], FIX[:6]]
    three = rt.synthesize_batch(rows, speaker_ids=[2, 1, 3], seed=3)
    four = rt.synthesize_batch(rows + [FIX], speaker_ids=[2, 1, 3, 2], seed=3)
    for a, b in zip(three, four):
        np.testing.assert_array_equal(a, b)
    mixes = [{0: 0.5, 3: 0.5}, {1: 1.0}, {2: 1.0}]
    three = rt.synthesize_batch(rows, speaker_mixes=mixes, seed=3)
    four = rt.synthesize_batch(rows + [FIX], speaker_mixes=mixes + [mixes[0]], seed=3)
    for a, b in zip(three, four):
        np.testing.assert_array_equal(a, b)
    assert {k[1] for k in rt._compiled_keys if k[0] == "enc_key"} == {(4, 16, "id"),
                                                                      (4, 16, "mix")}


def test_numeric_names_map_wins(tmp_path):
    """libritts-style voices use numeric reader ids as names ("3922" -> 1):
    the map wins over integer parsing, as in the JAX package."""
    model, config = make_synthetic_voice(tmp_path, quality="test", seed=6, n_speakers=4,
                                         gin_channels=16)
    cfg = json.loads(config.read_text())
    cfg["speaker_id_map"] = {"92": 0, "3922": 1, "116": 2, "2": 3}
    config.write_text(json.dumps(cfg))
    rt = PiperRuntime(model, config, device="cpu")
    assert rt.speaker_index("3922") == 1
    assert rt.speaker_index("2") == 3
    assert rt.speaker_index(2) == 2
    assert rt.speaker_index("1") == 1
    assert rt.resolve_speaker_mix({"2": 0.5, 2: 0.5}) == {3: 0.5, 2: 0.5}
    with pytest.raises(ValueError, match="unknown speaker 'nobody'"):
        rt.speaker_index("nobody")
    with pytest.raises(ValueError, match=r"out of range \[0, 4\)"):
        rt.speaker_index(4)


def test_resolve_mix_rejects_bool_and_float_keys(rt):
    for bad in ({True: 1.0}, {}, {1.5: 1.0}, {"spk1": 0.5, 1: 0.5}):
        with pytest.raises(ValueError):
            rt.resolve_speaker_mix(bad)
    with pytest.raises(ValueError, match="is not an id or name"):
        rt.speaker_index(True)


def test_single_speaker_voice_rejects_a_mix(tiny_voice):
    single = PiperRuntime(*tiny_voice, device="cpu")
    with pytest.raises(ValueError, match="requires a multi-speaker voice"):
        single.synthesize(FIX, speaker_mix={0: 1.0})
    with pytest.raises(ValueError, match="requires a multi-speaker voice"):
        single.phoneme_durations([FIX], speaker_mixes=[{0: 1.0}])
    assert single._sid_array([7], 1) is None  # ids are ignored, as in the JAX package


def test_validation_errors(rt):
    """The JAX package's messages, raised on the host before any device
    work."""
    cases = [
        (dict(speaker_ids=[1], speaker_mixes=[{0: 1.0}]), "not both"),
        (dict(speaker_mixes=[{9: 1.0}]), r"speaker_mix id 9 out of range \[0, 4\)"),
        (dict(speaker_mixes=[{}]), "must not be empty"),
        (dict(speaker_mixes=[{0: float("nan")}]), "must be finite"),
        (dict(speaker_mixes=[{0: 0.0}]), "at least one non-zero weight"),
        (dict(speaker_mixes=[{1.5: 1.0}]), "is not an integer speaker id"),
        (dict(speaker_mixes=[{True: 1.0}]), "is not an integer speaker id"),
        (dict(speaker_mixes=[{"2": 0.5}]), "is not an integer speaker id"),
        (dict(speaker_ids=[4]), r"speaker_id 4 out of range \[0, 4\)"),
        (dict(speaker_ids=[-1]), r"speaker_id -1 out of range"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            rt.synthesize_batch([FIX], **kw)
    with pytest.raises(ValueError, match="speaker_mixes length 1 != batch size 2"):
        rt.synthesize_batch([FIX, FIX], speaker_mixes=[{0: 1.0}])
    with pytest.raises(ValueError, match="speaker_mixes length 0 != batch size 1"):
        rt.synthesize_batch([FIX], speaker_mixes=[])
    with pytest.raises(ValueError, match="speaker_ids length 1 != batch size 2"):
        rt.synthesize_batch([FIX, FIX], speaker_ids=[1])


def test_a_bad_id_leaves_the_runtime_usable(ms_voice, monkeypatch):
    """A bad id or mix raises before the runtime touches the device (on a
    card an out-of-range index would be a device-side assert): no encode
    runs, and the next request is served as before."""
    rt = PiperRuntime(*ms_voice, device="cpu")
    before = rt.synthesize(FIX, speaker_id=1, seed=4)
    calls = []
    encode = tv.encode
    monkeypatch.setattr(tv, "encode", lambda *a, **k: calls.append(1) or encode(*a, **k))
    for kw in (dict(speaker_id=4), dict(speaker_id=-2), dict(speaker_mix={4: 1.0})):
        with pytest.raises(ValueError):
            rt.synthesize(FIX, seed=4, **kw)
        with pytest.raises(ValueError):
            rt.dispatch_fused(FIX, seed=4, **kw)
    assert not calls
    np.testing.assert_array_equal(rt.synthesize(FIX, speaker_id=1, seed=4), before)


def test_dispatch_fetch_with_speakers(ms_voice, rt):
    want = rt.synthesize_batch(ROWS, speaker_mixes=[{0: 1.0}, {1: 0.5, 2: 0.5}, {3: 1.0}],
                               seed=5)
    outs, meta = rt.dispatch_batch(ROWS, speaker_mixes=[{0: 1.0}, {1: 0.5, 2: 0.5}, {3: 1.0}],
                                   seed=5)
    for g, w in zip(rt.fetch_batch(outs, meta), want):
        np.testing.assert_array_equal(g, w)
    fused = PiperRuntime(*ms_voice, RuntimeOptions(mode="fused", fused_frames_per_phoneme=12),
                         device="cpu")
    for spk in ({"speaker_id": 2}, {"speaker_mix": {1: 0.3, 3: 0.7}}):
        want = fused.synthesize(FIX, seed=6, **spk)
        np.testing.assert_array_equal(fused.fetch_fused(*fused.dispatch_fused(FIX, seed=6, **spk)),
                                      want)
    assert {k[1][-1] for k in fused._compiled_keys} == {"id", "mix"}


def test_fused_overflow_redo_keeps_the_mix(ms_voice):
    """A fused budget that overflows (1 frame a phoneme, length_scale 3) is
    redone in split mode in the request's voice: the mix, copied at
    dispatch, so a caller's later change to the dict does not reach it."""
    fused = PiperRuntime(*ms_voice, RuntimeOptions(mode="fused", fused_frames_per_phoneme=1),
                         device="cpu")
    split = PiperRuntime(*ms_voice, device="cpu")
    mix = {0: 0.2, 3: 0.8}
    want = split.synthesize(FIX, length_scale=3.0, seed=9, speaker_mix=dict(mix))
    outs, meta = fused.dispatch_fused(FIX, length_scale=3.0, seed=9, speaker_mix=mix)
    mix.clear()
    got = fused.fetch_fused(outs, meta)
    assert int(meta["copy"].wait()[2].max()) > meta["f_bucket"]  # it did overflow
    np.testing.assert_array_equal(got, want)
    speaker0 = split.synthesize(FIX, length_scale=3.0, seed=9)
    assert got.shape != speaker0.shape or not np.array_equal(got, speaker0)
    np.testing.assert_array_equal(
        fused.synthesize(FIX, length_scale=3.0, seed=9, speaker_id=3),
        split.synthesize(FIX, length_scale=3.0, seed=9, speaker_id=3))


def test_pipeline_carries_speakers(ms_voice, rt):
    """ServingPipeline.submit takes a speaker id and submit_batch speaker
    ids (neither takes a mix, as in the JAX package): each equals the
    runtime's own call."""
    fused = PiperRuntime(*ms_voice, RuntimeOptions(mode="fused"), device="cpu")
    with ServingPipeline(fused, max_inflight=4, num_fetchers=2) as pipe:
        futs = [pipe.submit(FIX, speaker_id=k, seed=k) for k in range(4)]
        got = [f.result(timeout=120) for f in futs]
    for k, g in enumerate(got):
        np.testing.assert_array_equal(g, fused.synthesize(FIX, speaker_id=k, seed=k))
    with ServingPipeline(rt) as pipe:
        batch = pipe.submit_batch(ROWS, speaker_ids=[3, 2, 1], seed=2).result(timeout=120)
    for g, w in zip(batch, rt.synthesize_batch(ROWS, speaker_ids=[3, 2, 1], seed=2)):
        np.testing.assert_array_equal(g, w)


def test_speaker_entry_points_take_the_reference_parameters():
    import inspect

    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime

    def params(fn):
        return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]

    for name in ("phoneme_durations", "synthesize_with_alignment", "synthesize_forced",
                 "synthesize_batch_forced", "speaker_index", "resolve_speaker_mix"):
        assert params(getattr(PiperRuntime, name)) == params(getattr(JaxRuntime, name)), name


def test_speaker_probe_refuses_to_run_without_a_card():
    """tools/speaker_probe.py measures the card and has no CPU path."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from piper_tpu_torch.tools import speaker_probe

    with pytest.raises(SystemExit, match="no CUDA device"):
        speaker_probe.main(["--speakers", "4", "--batch", "2"])
