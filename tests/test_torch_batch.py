"""The port's batched synthesis against the JAX package's, on the CPU.

`_synthesize_batch_impl` with injected noise and rows of different lengths
is held to the JAX runtime's at the fp32 waveform bar, 1e-4 max-abs, with
`w_ceil` equal; the rest checks the batch axis itself: padding to the
`batch_buckets` ladder, identical rows against single utterances (1e-4:
a batched conv may sum in another order), dispatch/fetch against the
blocking call, and int16 output.
"""

import numpy as np
import pytest
import torch

from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions

IDS = [1, 20, 0, 12, 0, 31, 0, 24, 0, 19, 0, 10, 0, 2]
ROWS = [IDS, IDS[:8], IDS * 2]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_rt(tiny_voice):
    return PiperRuntime(*tiny_voice, device="cpu")


def _injected(rt, rows, frames=80, seed=0):
    rng = np.random.default_rng(seed)
    width = max(len(r) for r in rows)
    return (rng.standard_normal((len(rows), 2, width)).astype(np.float32),
            rng.standard_normal((len(rows), rt.hparams.inter_channels, frames)).astype(np.float32))


def _jax_w_ceil(ref, rows, dp_noise):
    import jax.numpy as jnp

    lengths, p, ids = ref._validate_and_pad(rows, pad_batch=False)
    dpn = np.zeros((len(rows), 2, p), np.float32)
    dpn[:, :, : dp_noise.shape[-1]] = dp_noise
    inf = ref.config.inference
    enc = ref._encode_injected(ref.params, jnp.asarray(ids), jnp.asarray(lengths),
                               jnp.asarray(dpn), inf.length_scale, inf.noise_w, None)
    return np.asarray(enc.w_ceil)


def test_injected_batch_matches_reference(port_rt, tiny_runtime):
    """Three rows of 14, 8 and 28 ids: per-row bounds and masks at B>1."""
    dp_noise, main_noise = _injected(port_rt, ROWS)
    kw = dict(noise_scale=None, length_scale=None, noise_w=None, speaker_ids=None,
              dp_noise=dp_noise, main_noise=main_noise)
    got, t = port_rt._synthesize_batch_impl(ROWS, **kw)
    want, t_ref = tiny_runtime._synthesize_batch_impl(ROWS, **kw)
    _, w_ceil = port_rt._durations(ROWS, dp_noise=dp_noise)
    np.testing.assert_array_equal(w_ceil, _jax_w_ceil(tiny_runtime, ROWS, dp_noise))
    assert len(got) == len(want) == 3
    assert len({len(a) for a in got}) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    assert (t.frame_bucket, t.frames, t.samples) == (t_ref.frame_bucket, t_ref.frames,
                                                     t_ref.samples)


def test_batch_axis_bucketing(tiny_voice):
    """Batched calls pad the row axis to the ladder (dummy rows copy row 0,
    outputs sliced to the real count): b=4 reuses b=3's keys, and a padded
    b=3 call equals the b=4 call row for row (the same shapes, the same
    per-row noise)."""
    rt = PiperRuntime(*tiny_voice, device="cpu")
    assert rt.batch_ladder == (1, 2, 4, 8, 16, 32, 48, 64, 96, 128)
    out3 = rt.synthesize_batch([IDS, IDS[:8], IDS[:6]], seed=3)
    assert len(out3) == 3 and all(len(a) > 0 for a in out3)
    assert rt.last_run_timings.compiled
    keys = set(rt._compiled_keys)
    assert {k[1][0] for k in keys} == {4}  # every key at 4 rows
    out4 = rt.synthesize_batch([IDS] * 4, seed=3)
    assert len(out4) == 4 and not rt.last_run_timings.compiled
    assert rt._compiled_keys == keys
    out3b = rt.synthesize_batch([IDS] * 3, seed=3)
    for a, r in zip(out3b, out4[:3]):
        np.testing.assert_array_equal(a, r)
    assert rt.last_run_timings.compile_count == len(keys)


def test_identical_rows_equal_synthesize(port_rt):
    """Seeded noise is one draw per row: each of the identical rows equals
    the single utterance with the same seed (same buckets)."""
    one = port_rt.synthesize(IDS, seed=11)
    for row in port_rt.synthesize_batch([IDS] * 3, seed=11):
        assert row.shape == one.shape
        np.testing.assert_allclose(row, one, atol=1e-4, rtol=0)


def test_dispatch_fetch_equals_synthesize_batch(port_rt):
    want = port_rt.synthesize_batch(ROWS, seed=5)
    outs, meta = port_rt.dispatch_batch(ROWS, seed=5)
    assert meta["b"] == 3 and outs.shape[0] == 4  # padded on the device
    got = port_rt.fetch_batch(outs, meta)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_int16_output(tiny_voice, port_rt):
    """int16 is clip * 32767 cast on the device, row for row."""
    rt = PiperRuntime(*tiny_voice, RuntimeOptions(output_dtype="int16"), device="cpu")
    got = rt.synthesize_batch(ROWS, seed=2)
    want = port_rt.synthesize_batch(ROWS, seed=2)
    for g, w in zip(got, want):
        assert g.dtype == np.int16
        np.testing.assert_array_equal(g, (np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16))


def test_batch_speaker_arguments(port_rt):
    """As synthesize: speaker ids are ignored by a single-speaker voice,
    and speaker mixes raise the JAX package's ValueError there (they need
    a multi-speaker voice; tests/test_torch_speakers.py runs them)."""
    a = port_rt.synthesize_batch([IDS, IDS[:8]], seed=4)
    b = port_rt.synthesize_batch([IDS, IDS[:8]], speaker_ids=[2, 5], seed=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="speaker_mix requires a multi-speaker voice"):
        port_rt.synthesize_batch([IDS], speaker_mixes=[{0: 1.0}])
    with pytest.raises(ValueError, match="speaker_mix requires a multi-speaker voice"):
        port_rt.dispatch_batch([IDS, IDS], speaker_mixes=[{0: 1.0}, {0: 1.0}])
    with pytest.raises(ValueError, match="pass speaker_id OR speaker_mix, not both"):
        port_rt.dispatch_batch([IDS, IDS], speaker_ids=[0, 0],
                               speaker_mixes=[{0: 1.0}, {0: 1.0}])


def test_batch_parameters_match_reference():
    """synthesize_batch, dispatch_batch and dispatch_fused take the JAX
    package's parameters in its order."""
    import inspect

    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime

    def params(fn):
        return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]

    for name in ("synthesize_batch", "dispatch_batch", "dispatch_fused", "fetch_batch",
                 "fetch_fused"):
        assert params(getattr(PiperRuntime, name)) == params(getattr(JaxRuntime, name)), name
