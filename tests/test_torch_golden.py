"""The committed full-width JAX goldens (piper_tpu_torch/golden/*.npz).

Each golden is one utterance of the fixture phrase repeated f times on a
full-width synthetic voice (`make_synthetic_voice(quality, seed=0)`),
computed by the JAX package's PiperRuntime on the CPU at "highest" in split
mode with injected noise from `np.random.default_rng(0)`: first `dp_noise`
(2, n), then `main_noise` (C, y_total) once the durations are known. The port
never imports the code that made them; `make_golden` below regenerates one,
and these tests recompute each with the JAX package and compare it with the
committed file: ids, noise and `w_ceil` exactly, the audio within 1e-6
(XLA's CPU code may order fp32 sums differently on another host; the card
is held to 1e-4). The port on the CPU is held to every golden at the fp32
bar, 1e-4, `w_ceil` equal. The speaker goldens are made the same way on the
bench's 904-speaker voice (gin 512), for speaker id 903 and for the mix
{0: 0.6, 903: 0.4}. The seeded goldens draw no injected noise: the JAX
package's runtime (split mode, "highest") at `seed=golden.SEEDED_SEED`, its
threefry noise; `make_seeded_golden` regenerates one (synthesize, or
synthesize_stream_incremental at the stream golden's chunk_frames), held
the same way, and the port on the CPU, drawing its own threefry noise at
that seed, is held to each at 1e-4 with `w_ceil` equal.

    JAX_PLATFORMS=cpu python -c "import tests.test_torch_golden as g; g.write_all()"
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from piper_tpu_torch import golden

ROOT = Path(__file__).resolve().parent.parent
AUDIO_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_golden(quality: str, factor: int, voice_dir, speaker=None) -> dict:
    """One golden's arrays, computed by the JAX package on the CPU; with
    `speaker` (a key of golden.SPEAKERS) on the multi-speaker voice."""
    import jax.numpy as jnp

    from piper_tpu.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu.engine.bucketing import bucket_for, pad_to
    from piper_tpu.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu.models.vits.synthetic import make_synthetic_voice

    ms = {} if speaker is None else dict(n_speakers=golden.N_SPEAKERS,
                                         gin_channels=golden.GIN_CHANNELS)
    model, config = make_synthetic_voice(voice_dir, quality=quality, seed=0, **ms)
    rt = PiperRuntime(model, config, RuntimeOptions(precision="highest", mode="split"))
    spk = {} if speaker is None else golden.SPEAKERS[speaker]
    sid = rt._sid_array([spk["speaker_id"]] if "speaker_id" in spk else None, 1,
                        mixes=[spk["speaker_mix"]] if "speaker_mix" in spk else None)
    ids = np.asarray(FIXTURE_PHONEME_IDS * factor, np.int32)
    rng = np.random.default_rng(golden.SEED)
    dp_noise = rng.standard_normal((2, len(ids))).astype(np.float32)
    p = bucket_for(len(ids), rt.options.phoneme_buckets, "phoneme")
    dpn = np.zeros((1, 2, p), np.float32)
    dpn[0, :, : len(ids)] = dp_noise
    inf = rt.config.inference
    enc = rt._encode_injected(rt.params, jnp.asarray(pad_to(ids, p)[None]),
                              jnp.asarray([len(ids)], jnp.int32), jnp.asarray(dpn),
                              inf.length_scale, inf.noise_w, sid)
    w_ceil = np.asarray(enc.w_ceil)[0, : len(ids)].astype(np.int32)
    main_noise = rng.standard_normal(
        (rt.hparams.inter_channels, int(w_ceil.sum()))).astype(np.float32)
    audio = rt.synthesize(ids.tolist(), dp_noise=dp_noise, main_noise=main_noise, **spk)
    return {"ids": ids, "dp_noise": dp_noise, "main_noise": main_noise, "w_ceil": w_ceil,
            "audio": np.asarray(audio, np.float32), "seed": np.int64(golden.SEED),
            **({} if speaker is None else golden.speaker_arrays(speaker))}


def make_seeded_golden(quality: str, factor: int, voice_dir, stream: bool = False) -> dict:
    """One seeded golden's arrays, computed by the JAX package on the CPU
    from its own threefry noise at golden.SEEDED_SEED."""
    from piper_tpu.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu.models.vits.synthetic import make_synthetic_voice

    model, config = make_synthetic_voice(voice_dir, quality=quality, seed=0)
    rt = PiperRuntime(model, config, RuntimeOptions(precision="highest", mode="split"))
    ids, seed = FIXTURE_PHONEME_IDS * factor, golden.SEEDED_SEED
    out = {"ids": np.asarray(ids, np.int32), "seed": np.int64(seed),
           "w_ceil": np.asarray(rt.phoneme_durations([ids], seed=seed)[0], np.int32)}
    if stream:
        chunk_frames = golden.STREAM_GOLDEN[2]
        chunks = list(rt.synthesize_stream_incremental(ids, seed=seed, chunk_frames=chunk_frames))
        return {**out, "chunk_frames": np.int64(chunk_frames),
                "starts": np.asarray([c.start_sample_index for c in chunks], np.int64),
                "audio": np.concatenate([c.samples for c in chunks]).astype(np.float32)}
    return {**out, "audio": np.asarray(rt.synthesize(ids, seed=seed), np.float32)}


def write_all(voice_root=ROOT / "build" / "golden_voices") -> None:
    """Regenerate every committed golden."""
    for quality, factor, speaker in ALL:
        voice_dir = Path(voice_root) / (quality if speaker is None else f"{quality}_ms")
        arrays = make_golden(quality, factor, voice_dir, speaker)
        np.savez_compressed(golden.path(quality, factor, speaker), **arrays)
        print(quality, factor, speaker, {k: v.shape for k, v in arrays.items()})
    for quality, factor, stream in SEEDED:
        arrays = make_seeded_golden(quality, factor, Path(voice_root) / quality, stream)
        np.savez_compressed(golden.seeded_path(quality, factor, stream), **arrays)
        print(quality, factor, "seeded", stream, {k: v.shape for k, v in arrays.items()})


ALL = [(q, f, None) for q, f in golden.GOLDENS] + list(golden.SPEAKER_GOLDENS)
IDS = [f"{q}_f{f}" + (f"_{s}" if s else "") for q, f, s in ALL]
SEEDED = [(q, f, False) for q, f in golden.SEEDED_GOLDENS] + [(*golden.STREAM_GOLDEN[:2], True)]
SEEDED_IDS = [f"{q}_f{f}" + ("_stream" if st else "") for q, f, st in SEEDED]


@pytest.mark.parametrize("quality,factor,speaker", ALL, ids=IDS)
def test_committed_golden_is_what_jax_computes(quality, factor, speaker, tmp_path):
    want = golden.load(quality, factor, speaker)
    got = make_golden(quality, factor, tmp_path, speaker)
    assert sorted(got) == sorted(want)
    for key in set(want) - {"audio"}:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["audio"].shape == want["audio"].shape
    np.testing.assert_allclose(got["audio"], want["audio"], atol=AUDIO_ATOL, rtol=0)


@pytest.fixture(scope="module")
def port_voices(tmp_path_factory):
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

    root = tmp_path_factory.mktemp("golden_voices")
    voices = {q: make_synthetic_voice(root / q, quality=q, seed=0) for q in ("medium", "x_low")}
    voices["medium_ms"] = make_synthetic_voice(
        root / "medium_ms", quality="medium", seed=0, n_speakers=golden.N_SPEAKERS,
        gin_channels=golden.GIN_CHANNELS)
    return voices


@pytest.mark.parametrize("quality,factor,speaker", ALL, ids=IDS)
def test_port_matches_golden_on_the_cpu(quality, factor, speaker, port_voices):
    from piper_tpu_torch.engine.runtime import PiperRuntime

    rt = PiperRuntime(*port_voices[quality if speaker is None else f"{quality}_ms"],
                      device="cpu")
    row = golden.check(rt, quality, factor, speaker)
    assert row["w_ceil_equal"] and row["max_abs_err"] <= golden.FP32_ATOL == row["atol"]


@pytest.mark.parametrize("quality,factor,stream", SEEDED, ids=SEEDED_IDS)
def test_committed_seeded_golden_is_what_jax_computes(quality, factor, stream, tmp_path):
    want = golden.load(quality, factor, file=golden.seeded_path(quality, factor, stream))
    got = make_seeded_golden(quality, factor, tmp_path, stream)
    assert sorted(got) == sorted(want)
    for key in set(want) - {"audio"}:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["audio"].shape == want["audio"].shape
    np.testing.assert_allclose(got["audio"], want["audio"], atol=AUDIO_ATOL, rtol=0)


@pytest.mark.parametrize("quality,factor,stream", SEEDED, ids=SEEDED_IDS)
def test_port_matches_seeded_golden_on_the_cpu(quality, factor, stream, port_voices):
    """The port's own seeded draws (JAX's threefry) reproduce JAX's
    durations and audio at the golden's seed."""
    from piper_tpu_torch.engine.runtime import PiperRuntime

    rt = PiperRuntime(*port_voices[quality], device="cpu")
    row = golden.check_seeded(rt, quality, factor, stream)
    assert row["w_ceil_equal"] and row["max_abs_err"] <= golden.FP32_ATOL == row["atol"]


def test_speaker_goldens_hold_their_speakers():
    """The id golden stores id 903 and the mix golden its two weights, and
    compare() passes them to the runtime as synthesize's arguments."""
    assert golden.speaker_kwargs(golden.load("medium", 1, "id903")) == {"speaker_id": 903}
    mix = golden.speaker_kwargs(golden.load("medium", 1, "mix0_903"))["speaker_mix"]
    assert list(mix) == [0, 903]
    np.testing.assert_array_equal(np.float32(list(mix.values())), np.float32([0.6, 0.4]))
    assert golden.speaker_kwargs(golden.load("medium", 1)) == {}


def test_goldens_stay_small():
    assert (sum(golden.path(*key).stat().st_size for key in ALL)
            + sum(golden.seeded_path(*key).stat().st_size for key in SEEDED)) < 2 * 2**20


def test_atol_follows_the_tiers():
    from piper_tpu_torch.engine.runtime import RuntimeOptions

    assert golden.atol_for(RuntimeOptions()) == golden.FP32_ATOL
    for kw in (dict(vocoder_precision="high"), dict(flow_precision="high"),
               dict(vocoder_precision=(None, "default", None, None)), dict(precision="high")):
        assert golden.atol_for(RuntimeOptions(**kw)) == golden.LOWERED_ATOL, kw
