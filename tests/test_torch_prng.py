"""JAX's threefry-2x32 noise in the port, against jax.random, on the CPU.

The plain generator (piper_tpu_torch/ops/kernels/prng.py) against
jax.random at the seeds {0, 1, 7, 2^31, 2^32 - 1, -1 wrapped}: keys, fold_in
and bits bit-equal, uniforms bit-equal, normals within 1e-6 max-abs (XLA's
CPU log1p and fused Horner steps against PyTorch's: an ulp at |z| ~ 4,
4.8e-7). The port's per_frame_noise and per_row_frame_noise against the JAX
package's (piper_tpu/models/vits/model.py), negative frames included, at the
same bar. Then every seeded entry point of the port against the JAX
package's at the same seed on the tiny `test` voice: `w_ceil` equal, the
fp32 waveform within 1e-4 (WAVE_ATOL), the mixed tiers within 1e-3: split,
fused and forced synthesize, synthesize_batch, the incremental stream
(fused head and split), batched stream heads and windows, and the mesh's
sequence-parallel synthesize_long.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from piper_tpu.models.vits import model as jv
from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIX
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions, seeded_noise
from piper_tpu_torch.models.vits import model as tv
from piper_tpu_torch.ops.kernels import prng

NORMAL_ATOL = 1e-6
WAVE_ATOL, MIXED_ATOL = 1e-4, 1e-3
SEEDS = [0, 1, 7, 2 ** 31, 2 ** 32 - 1, -1]
SHAPES = [(2, 13), (192, 1000), (1, 4097)]


def _jkey(seed):
    return jax.random.PRNGKey(np.uint32(seed & 0xFFFFFFFF))


def _key_data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the generator -------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_are_jaxs(seed):
    key = prng.prng_key(seed)
    np.testing.assert_array_equal(key.numpy(), _key_data(_jkey(seed)))
    for data in (0, 1, 5, 2 ** 31 + 5, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(key, data).numpy(),
                                      _key_data(jax.random.fold_in(_jkey(seed), data)))
    # A negative frame (a stream's -halo) folds as a JAX int32 does: mod 2^32.
    frames = np.arange(-47, 20, dtype=np.int32)
    want = jax.vmap(lambda t: jax.random.fold_in(_jkey(seed), t))(jnp.asarray(frames))
    np.testing.assert_array_equal(prng.fold_in(key, torch.from_numpy(frames).long()).numpy(),
                                  _key_data(want))


@pytest.mark.parametrize("shape", SHAPES, ids=["2x13", "192x1000", "odd4097"])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniforms_and_normals_are_jaxs(seed, shape):
    key, jkey = prng.prng_key(seed), _jkey(seed)
    n = int(np.prod(shape))
    bits = np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).astype(np.int64).reshape(-1)
    np.testing.assert_array_equal(prng.random_bits(key, n).numpy(), bits)
    np.testing.assert_array_equal(prng.uniform(key, shape).numpy(),
                                  np.asarray(jax.random.uniform(jkey, shape, jnp.float32)))
    got = prng.normal(key, shape).numpy()
    want = np.asarray(jax.random.normal(jkey, shape, jnp.float32))
    assert got.shape == want.shape and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= NORMAL_ATOL


def test_erf_inv_is_xlas():
    u = prng.uniform(prng.prng_key(3), (50000,), -0.999999, 0.999999)
    u = torch.cat([u, torch.tensor([0.0, -1.0, 1.0, 0.99999994, -0.99999994])])
    got = prng.erf_inv(u).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u.numpy())))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    assert float(np.abs(got[finite] - want[finite]).max()) <= NORMAL_ATOL


def test_threefry_normal_layouts():
    """One seed: element (r, c) is counter r * n + c of one key (JAX's
    normal(key, (rows, n))); per-row seeds: row r is its own key's draw;
    the runtime's seeded_noise is the broadcast one-row draw."""
    rows = prng.threefry_normal(5, 0, 3, 26)
    key = jax.random.fold_in(_jkey(5), 0)
    want = np.asarray(jax.random.normal(key, (3, 26), jnp.float32))
    assert rows.shape == (3, 26) and float(np.abs(rows.numpy() - want).max()) <= NORMAL_ATOL
    per_row = prng.threefry_normal([5, 6, -1], 0, 3, 26)
    for r, s in enumerate([5, 6, -1]):
        one = np.asarray(jax.random.normal(jax.random.fold_in(_jkey(s), 0), (26,), jnp.float32))
        assert float(np.abs(per_row[r].numpy() - one).max()) <= NORMAL_ATOL
    assert torch.equal(per_row, prng.threefry_normal(torch.tensor([5, 6, 2 ** 32 - 1]), 0, 3, 26))
    drawn = seeded_noise(5, 0, (2, 13), 4, "cpu")
    assert drawn.shape == (4, 2, 13) and torch.equal(drawn[3], rows[0].view(2, 13))
    for output in ("bits", "uniform"):
        a = prng.threefry_normal(9, 1, 2, 7, torch.arange(-3, 5), output=output)
        assert a.shape == (2, 7, 8) and a.dtype == (torch.int64 if output == "bits"
                                                    else torch.float32)


def test_threefry_normal_refuses_bad_arguments():
    with pytest.raises(ValueError, match="seeds for"):
        prng.threefry_normal([1, 2], 0, 3, 4)
    with pytest.raises(ValueError, match="frames must be"):
        prng.threefry_normal(1, 0, 2, 4, torch.zeros(2, 3, dtype=torch.int64))
    with pytest.raises(ValueError, match="output must be"):
        prng.threefry_normal(1, 0, 2, 4, output="gauss")
    with pytest.raises(ValueError, match="cpu or cuda"):
        prng.threefry_normal(1, 0, 2, 4, device="meta")


# -- the per-frame noise against the JAX package's ---------------------------------


@pytest.mark.parametrize("seed", [3, 2 ** 32 - 1, -5])
def test_per_frame_noise_is_jaxs(seed):
    t = np.arange(-47, 40, dtype=np.int32)
    base = jax.random.fold_in(_jkey(seed), 1)
    want = np.asarray(jv.per_frame_noise(base, jnp.asarray(t), 2, 24))
    got = tv.per_frame_noise(seed, torch.from_numpy(t).long(), 2, 24)
    assert got.shape == want.shape == (2, 24, len(t))
    assert float(np.abs(got.numpy() - want).max()) <= NORMAL_ATOL
    got0 = tv.per_frame_noise(torch.tensor(seed & 0xFFFFFFFF), torch.from_numpy(t), 2, 24)
    assert torch.equal(got, got0)


def test_per_row_frame_noise_is_jaxs():
    seeds = [3, 2 ** 32 + 3, 99, -1]
    t = np.array([[-47 + i for i in range(9)], [0 + i for i in range(9)],
                  [100 + i for i in range(9)], [-3 + i for i in range(9)]], np.int32)
    bases = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(s), 1))(
        jnp.asarray([s & 0xFFFFFFFF for s in seeds], jnp.uint32))
    want = np.asarray(jv.per_row_frame_noise(bases, jnp.asarray(t), 24))
    got = tv.per_row_frame_noise(seeds, torch.from_numpy(t).long(), 24)
    assert got.shape == want.shape == (4, 24, 9)
    assert float(np.abs(got.numpy() - want).max()) <= NORMAL_ATOL


# -- the seeded entry points against the JAX runtime ------------------------------


@pytest.fixture(scope="module")
def runtimes(tiny_voice):
    """(port, JAX) runtimes of the tiny voice per (mode, mixed)."""
    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime
    from piper_tpu.engine.runtime import RuntimeOptions as JaxOptions

    made = {}

    def get(mode="split", mixed=False):
        key = (mode, mixed)
        if key not in made:
            tiers = dict(vocoder_precision="high", flow_precision="high") if mixed else {}
            made[key] = (PiperRuntime(*tiny_voice, RuntimeOptions(mode=mode, **tiers),
                                      device="cpu"),
                         JaxRuntime(*tiny_voice, JaxOptions(mode=mode, **tiers)))
        return made[key]

    return get


def _same_plans(port, ref, ids_batch, seed):
    """Both runtimes' phoneme_durations (the ceiled frames per phoneme)."""
    got = port.phoneme_durations(ids_batch, seed=seed)
    want = ref.phoneme_durations(ids_batch, seed=seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _same_audio(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= atol


@pytest.mark.parametrize("mode,mixed", [("split", False), ("fused", False), ("split", True)],
                         ids=["split", "fused", "split_mixed"])
def test_seeded_synthesize_matches_jax(runtimes, mode, mixed):
    port, ref = runtimes(mode, mixed)
    ids = FIX * 2
    for seed in (11, 2 ** 32 - 3):
        _same_plans(port, ref, [ids], seed)
        _same_audio(port.synthesize(ids, seed=seed), ref.synthesize(ids, seed=seed),
                    MIXED_ATOL if mixed else WAVE_ATOL)


def test_seeded_forced_and_batch_match_jax(runtimes):
    port, ref = runtimes()
    ids, other = FIX * 2, FIX[:9]
    plan = ref.phoneme_durations([ids], seed=4)[0]
    _same_audio(port.synthesize_forced(ids, plan, seed=4), ref.synthesize_forced(ids, plan, seed=4),
                WAVE_ATOL)
    got = port.synthesize_batch([ids, other, ids], seed=8)
    want = ref.synthesize_batch([ids, other, ids], seed=8)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_audio(g, w, WAVE_ATOL)


@pytest.mark.parametrize("fused_head", [True, False], ids=["fused_head", "split_head"])
def test_seeded_incremental_stream_matches_jax(runtimes, fused_head):
    port, ref = runtimes()
    ids = FIX * 4
    kw = dict(seed=2 ** 31 + 1, chunk_frames=16, fused_head=fused_head)
    got = list(port.synthesize_stream_incremental(ids, **kw))
    want = list(ref.synthesize_stream_incremental(ids, **kw))
    assert len(got) == len(want) > 1
    assert [c.start_sample_index for c in got] == [c.start_sample_index for c in want]
    _same_audio(np.concatenate([c.samples for c in got]),
                np.concatenate([c.samples for c in want]), WAVE_ATOL)


def test_seeded_batched_heads_and_windows_match_jax(runtimes):
    port, ref = runtimes()
    rows, c0, halo = [FIX, FIX[:10], FIX[::-1]], 8, 6
    seeds = [5, 2 ** 32 - 1, 123456]
    p_enc, p_audio0, p_tot, p_seeds, p_ns = port.dispatch_stream_head_batch(
        rows, c0=c0, halo=halo, seeds=seeds)
    j_enc, j_audio0, j_tot, j_seeds, j_ns = ref.dispatch_stream_head_batch(
        rows, c0=c0, halo=halo, seeds=seeds)
    np.testing.assert_array_equal(p_enc.w_ceil.numpy(), np.asarray(j_enc.w_ceil))
    np.testing.assert_array_equal(p_tot.numpy(), np.asarray(j_tot))
    _same_audio(p_audio0.numpy(), j_audio0, WAVE_ATOL)
    t_off = np.array([c0 - halo, 3, 11], np.int32)
    got = port.dispatch_window_batch(p_enc, p_seeds, t_off, p_tot.numpy(), p_ns,
                                     emit_frames=c0, halo=halo)
    want = ref.dispatch_window_batch(j_enc, jnp.asarray(j_seeds, jnp.uint32), t_off,
                                     np.asarray(j_tot), np.asarray(j_ns, np.float32),
                                     emit_frames=c0, halo=halo)
    _same_audio(got.numpy(), want, WAVE_ATOL)


def test_seeded_sp_synthesize_long_matches_jax():
    """The mesh's sequence-parallel decode at sp=4 with its seeded duration
    and prior noise, against JAX's ShardedVits on four virtual CPU devices."""
    from piper_tpu.parallel.mesh import make_mesh as j_make_mesh
    from piper_tpu.parallel.serving import ShardedVits as JShardedVits
    from piper_tpu_torch.parallel.serving import ShardedVits
    from test_torch_parallel import TINY, _jhp, _weights, cpu_mesh

    _, pt, jp = _weights(TINY, 17)
    ids = np.random.default_rng(0).integers(0, TINY.n_vocab, size=(2, 10))
    lengths = np.full((2,), 10)
    got, g_len = ShardedVits.create(cpu_mesh(4, seq_parallel=4), pt, TINY).synthesize_long(
        ids, lengths, span=16, seed=77)
    want, w_len = JShardedVits.create(j_make_mesh(4, seq_parallel=4), jp, _jhp(TINY)) \
        .synthesize_long(ids, lengths, span=16, seed=77)
    np.testing.assert_array_equal(g_len, w_len)
    _same_audio(got, want, WAVE_ATOL)
