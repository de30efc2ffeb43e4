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
bar, 1e-4, `w_ceil` equal.

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


def make_golden(quality: str, factor: int, voice_dir) -> dict:
    """One golden's arrays, computed by the JAX package on the CPU."""
    import jax.numpy as jnp

    from piper_tpu.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu.engine.bucketing import bucket_for, pad_to
    from piper_tpu.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu.models.vits.synthetic import make_synthetic_voice

    model, config = make_synthetic_voice(voice_dir, quality=quality, seed=0)
    rt = PiperRuntime(model, config, RuntimeOptions(precision="highest", mode="split"))
    ids = np.asarray(FIXTURE_PHONEME_IDS * factor, np.int32)
    rng = np.random.default_rng(golden.SEED)
    dp_noise = rng.standard_normal((2, len(ids))).astype(np.float32)
    p = bucket_for(len(ids), rt.options.phoneme_buckets, "phoneme")
    dpn = np.zeros((1, 2, p), np.float32)
    dpn[0, :, : len(ids)] = dp_noise
    inf = rt.config.inference
    enc = rt._encode_injected(rt.params, jnp.asarray(pad_to(ids, p)[None]),
                              jnp.asarray([len(ids)], jnp.int32), jnp.asarray(dpn),
                              inf.length_scale, inf.noise_w, None)
    w_ceil = np.asarray(enc.w_ceil)[0, : len(ids)].astype(np.int32)
    main_noise = rng.standard_normal(
        (rt.hparams.inter_channels, int(w_ceil.sum()))).astype(np.float32)
    audio = rt.synthesize(ids.tolist(), dp_noise=dp_noise, main_noise=main_noise)
    return {"ids": ids, "dp_noise": dp_noise, "main_noise": main_noise, "w_ceil": w_ceil,
            "audio": np.asarray(audio, np.float32), "seed": np.int64(golden.SEED)}


def write_all(voice_root=ROOT / "build" / "golden_voices") -> None:
    """Regenerate every committed golden."""
    for quality, factor in golden.GOLDENS:
        arrays = make_golden(quality, factor, Path(voice_root) / quality)
        np.savez_compressed(golden.path(quality, factor), **arrays)
        print(quality, factor, {k: v.shape for k, v in arrays.items()})


@pytest.mark.parametrize("quality,factor", golden.GOLDENS)
def test_committed_golden_is_what_jax_computes(quality, factor, tmp_path):
    want = golden.load(quality, factor)
    got = make_golden(quality, factor, tmp_path)
    assert sorted(got) == sorted(want)
    for key in ("ids", "dp_noise", "main_noise", "w_ceil", "seed"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["audio"].shape == want["audio"].shape
    np.testing.assert_allclose(got["audio"], want["audio"], atol=AUDIO_ATOL, rtol=0)


@pytest.fixture(scope="module")
def port_voices(tmp_path_factory):
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

    root = tmp_path_factory.mktemp("golden_voices")
    return {q: make_synthetic_voice(root / q, quality=q, seed=0) for q in ("medium", "x_low")}


@pytest.mark.parametrize("quality,factor", golden.GOLDENS)
def test_port_matches_golden_on_the_cpu(quality, factor, port_voices):
    from piper_tpu_torch.engine.runtime import PiperRuntime

    rt = PiperRuntime(*port_voices[quality], device="cpu")
    row = golden.check(rt, quality, factor)
    assert row["w_ceil_equal"] and row["max_abs_err"] <= golden.FP32_ATOL == row["atol"]


def test_goldens_stay_small():
    assert sum(golden.path(q, f).stat().st_size for q, f in golden.GOLDENS) < 2 * 2**20


def test_atol_follows_the_tiers():
    from piper_tpu_torch.engine.runtime import RuntimeOptions

    assert golden.atol_for(RuntimeOptions()) == golden.FP32_ATOL
    for kw in (dict(vocoder_precision="high"), dict(flow_precision="high"),
               dict(vocoder_precision=(None, "default", None, None)), dict(precision="high")):
        assert golden.atol_for(RuntimeOptions(**kw)) == golden.LOWERED_ATOL, kw
