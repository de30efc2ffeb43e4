"""The port's multi-slot layer against the JAX package's, on the CPU.

Counterparts of tests/test_parallel.py, test_seq_parallel.py,
test_tensor_parallel.py and test_pp.py at their TINY hparams. The port runs
on virtual CPU slots (make_mesh(devices=["cpu"] * n)), JAX on its 8 virtual
CPU devices (conftest.py). Bars: the waveform within 1e-4 of JAX's at the
same seed (w_ceil and y_len equal), the encoder's tensors within 2e-5; the
port's own sharded paths within 2e-5 of its one-slot runs (JAX's bar for
its tp and pp tests: the row-parallel sums and the microbatch split change
only the order of fp32 sums). sp is held to JAX at zero noise and to the
port's one-slot windows with noise; its seeded noise (JAX's threefry) is
held to JAX's in tests/test_torch_prng.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from piper_tpu.models.vits.hparams import VitsHParams as JHParams
from piper_tpu.models.vits.params import params_from_arrays
from piper_tpu.parallel import pp as jpp
from piper_tpu.parallel.mesh import make_mesh as j_make_mesh
from piper_tpu.parallel.serving import ShardedVits as JShardedVits
from piper_tpu_torch.models.vits import model as tv
from piper_tpu_torch.models.vits.hparams import VitsHParams, receptive_field_frames
from piper_tpu_torch.models.vits.synthetic import synthetic_params
from piper_tpu_torch.parallel import tp as ttp
from piper_tpu_torch.parallel.mesh import TENSOR_AXIS, batch_sharded, make_mesh, replicated
from piper_tpu_torch.parallel.pp import (balanced_cuts, build_pp_decode, default_microbatches,
                                         pp_decode, unit_flops)
from piper_tpu_torch.parallel.serving import ShardedVits

WAVE_ATOL, MODULE_ATOL, SELF_ATOL = 1e-4, 2e-5, 2e-5

_TINY = dict(
    n_vocab=40, inter_channels=16, hidden_channels=16, filter_channels=32, n_heads=2,
    n_layers=1, dp_filter_channels=16, dp_n_flows=2, flow_n_flows=1,
    flow_hidden_channels=16, flow_n_layers=1, resblock_kernel_sizes=[3],
    resblock_dilation_sizes=[[1]], upsample_rates=[4], upsample_initial_channel=32,
    upsample_kernel_sizes=[8])
TINY = VitsHParams(**_TINY)  # tests/test_parallel.py, test_seq_parallel.py
# tests/test_tensor_parallel.py
TINY_TP = VitsHParams(**{**_TINY, "resblock_dilation_sizes": [[1, 3]],
                         "upsample_rates": [4, 2], "upsample_kernel_sizes": [8, 4]})
TINY_TP_MULTI = dataclasses.replace(TINY_TP, n_speakers=4, gin_channels=8)
# tests/test_pp.py
TINY_PP = dataclasses.replace(TINY_TP, resblock_dilation_sizes=[[1, 2]])
TINY_PP_MS = dataclasses.replace(TINY_PP, n_speakers=3, gin_channels=8)


def cpu_mesh(n, **kw):
    return make_mesh(n, devices=["cpu"] * 8, **kw)


def _jhp(hp):
    return JHParams(**dataclasses.asdict(hp))


def _weights(hp, seed):
    """(numpy weights, the port's tensors, JAX's params) of one seed."""
    w = synthetic_params(hp, seed=seed)
    return (w, {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in w.items()},
            params_from_arrays(w))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dp_case():
    """TINY at B=8, P=12, 32 frames, seed 3 through JAX's dp=8 ShardedVits."""
    w, pt, jp = _weights(TINY, 13)
    rng = np.random.default_rng(0)
    b, p, f = 8, 12, 32
    ids = rng.integers(0, TINY.n_vocab, size=(b, p))
    lengths = np.full((b,), p)
    ja, jl = JShardedVits.create(j_make_mesh(8), jp, _jhp(TINY)).synthesize_batch(
        ids, lengths, max_frames=f, seed=3)
    return pt, ids, lengths, f, ja, jl


# -- test_parallel.py -----------------------------------------------------


def test_mesh_shapes():
    mesh = cpu_mesh(8)
    assert mesh.shape == {"dp": 8, "sp": 1, "tp": 1, "pp": 1}
    assert cpu_mesh(8, seq_parallel=2).shape == {"dp": 4, "sp": 2, "tp": 1, "pp": 1}
    assert cpu_mesh(8, seq_parallel=2, tensor_parallel=2).shape == {
        "dp": 2, "sp": 2, "tp": 2, "pp": 1}
    assert cpu_mesh(8, pipeline_parallel=2).shape == {"dp": 4, "sp": 1, "tp": 1, "pp": 2}
    with pytest.raises(ValueError, match="not divisible"):
        cpu_mesh(6, seq_parallel=4)
    # The placements: a copy per slot (one per device), rows split over dp.
    x = torch.arange(16.0).view(8, 2)
    assert all(r is x for r in replicated(mesh, x))
    shards = batch_sharded(cpu_mesh(8, pipeline_parallel=2), x)
    assert [s.shape[0] for s in shards] == [2] * 4
    assert torch.equal(torch.cat(shards), x)


def test_dp_sharded_batch_matches_single_device(dp_case):
    """dp=8 against JAX's dp=8 ShardedVits at the same seed, and against
    the port's one-slot infer with the same numpy noise."""
    pt, ids, lengths, f, ja, jl = dp_case
    sharded = ShardedVits.create(cpu_mesh(8), pt, TINY)
    audio, y_len = sharded.synthesize_batch(ids, lengths, max_frames=f, seed=3)
    assert audio.shape == (8, f * TINY.hop_length) and np.isfinite(audio).all()
    np.testing.assert_array_equal(y_len, jl)
    np.testing.assert_allclose(audio, ja, atol=WAVE_ATOL, rtol=0)

    rng = np.random.default_rng(3)
    dp_noise = rng.standard_normal((8, 2, 12)).astype(np.float32)
    main_noise = rng.standard_normal((8, TINY.inter_channels, f)).astype(np.float32)
    with torch.inference_mode():
        ref, ref_len = tv.infer(pt, TINY, torch.as_tensor(ids), torch.as_tensor(lengths),
                                torch.from_numpy(dp_noise), torch.from_numpy(main_noise),
                                max_frames=f)
    np.testing.assert_array_equal(y_len, ref_len.numpy())
    np.testing.assert_allclose(audio, ref.numpy(), atol=SELF_ATOL, rtol=0)


def test_sharded_precision_options_plumb(dp_case):
    """The tiers reach the programs. JAX computes every tier in fp32 on the
    CPU, so its test holds the tiered output bit-equal to the default; the
    port's kernels emulate their tier's products on the CPU too, so here
    the tiered output differs from the default's (within the mixed bar,
    1e-3) and equals a one-device infer at the same tiers."""
    pt, ids, lengths, f, _, _ = dp_case
    base = ShardedVits.create(cpu_mesh(8), pt, TINY)
    tiered = ShardedVits.create(cpu_mesh(8), pt, TINY, vocoder_precision="high",
                                flow_precision="high")
    assert base.precision == "highest" and tiered.flow_precision == "high"
    a0, y0 = base.synthesize_batch(ids, lengths, max_frames=f, seed=3)
    a1, y1 = tiered.synthesize_batch(ids, lengths, max_frames=f, seed=3)
    np.testing.assert_array_equal(y0, y1)
    assert 0 < np.abs(a1 - a0).max() <= 1e-3
    rng = np.random.default_rng(3)
    dp_noise = rng.standard_normal((8, 2, 12)).astype(np.float32)
    main_noise = rng.standard_normal((8, TINY.inter_channels, f)).astype(np.float32)
    with torch.inference_mode():
        ref, _ = tv.infer(pt, TINY, torch.as_tensor(ids), torch.as_tensor(lengths),
                          torch.from_numpy(dp_noise), torch.from_numpy(main_noise),
                          max_frames=f, vocoder_precision="high", flow_precision="high")
    np.testing.assert_allclose(a1, ref.numpy(), atol=SELF_ATOL, rtol=0)


def test_repeated_serving_calls_do_not_rebuild(dp_case):
    """The same callable comes back for the same key, and a repeated
    synthesize_batch builds nothing (JAX: does not retrace)."""
    pt = dp_case[0]
    sharded = ShardedVits.create(cpu_mesh(8), pt, TINY)
    assert sharded.infer_fn(32) is sharded.infer_fn(32)
    assert sharded.infer_fn(32, with_sid=False) is sharded.infer_fn(32)
    assert sharded.infer_fn(64) is not sharded.infer_fn(32)
    assert sharded.sp_decode_fn(16) is sharded.sp_decode_fn(16)
    assert sharded.sp_decode_fn(16, halo=4) is not sharded.sp_decode_fn(16, halo=8)

    sharded2 = ShardedVits.create(cpu_mesh(8), pt, TINY)
    ids = np.zeros((8, 12), np.int64)
    lengths = np.full((8,), 12)
    sharded2.synthesize_batch(ids, lengths, max_frames=32, seed=1)
    assert sharded2.builds == 1
    sharded2.synthesize_batch(ids, lengths, max_frames=32, seed=2)
    assert sharded2.builds == 1, "second call rebuilt"


def test_multispeaker_sharded():
    hp = dataclasses.replace(TINY, n_speakers=8, gin_channels=8)
    _, pt, jp = _weights(hp, 14)
    rng = np.random.default_rng(1)
    b, p = 4, 10
    ids = rng.integers(0, hp.n_vocab, size=(b, p))
    sid = np.arange(b) % 8
    audio, y_len = ShardedVits.create(cpu_mesh(4), pt, hp).synthesize_batch(
        ids, np.full((b,), p), max_frames=16, sid=sid)
    assert audio.shape[0] == b and np.isfinite(audio).all()
    ja, jl = JShardedVits.create(j_make_mesh(4), jp, _jhp(hp)).synthesize_batch(
        ids, np.full((b,), p), max_frames=16, sid=sid)
    np.testing.assert_array_equal(y_len, jl)
    np.testing.assert_allclose(audio, ja, atol=WAVE_ATOL, rtol=0)


# -- test_seq_parallel.py -------------------------------------------------


def test_sp_decode_matches_single_device_windows():
    """sp=4 against the same windowed decode run serially on one slot, with
    noise; and against JAX's sp=4 at zero noise."""
    _, pt, jp = _weights(TINY, 17)
    sharded = ShardedVits.create(cpu_mesh(4, seq_parallel=4), pt, TINY)
    rng = np.random.default_rng(0)
    b, p, span, n_sp = 2, 10, 16, 4
    ids = rng.integers(0, TINY.n_vocab, size=(b, p))
    lengths = np.full((b,), p)
    audio, y_len = sharded.synthesize_long(ids, lengths, span=span, seed=77)
    assert audio.shape == (b, n_sp * span * TINY.hop_length) and np.isfinite(audio).all()

    halo = receptive_field_frames(TINY)
    window, total, hop = span + 2 * halo, n_sp * span, TINY.hop_length
    from piper_tpu_torch.engine.runtime import seeded_noise

    with torch.inference_mode():
        enc = tv.encode(pt, TINY, torch.as_tensor(ids), torch.as_tensor(lengths),
                        seeded_noise(77, 0, (2, p), b, "cpu"))
        pieces = []
        for k in range(n_sp):
            t_offset = k * span - halo
            noise = tv.per_frame_noise(77, t_offset + torch.arange(window), b,
                                       TINY.inter_channels)
            aw = tv.decode_window(pt, TINY, enc, noise, t_offset, window=window,
                                  total_frames=total)
            pieces.append(aw.numpy()[:, halo * hop:(halo + span) * hop])
    np.testing.assert_allclose(audio, np.concatenate(pieces, axis=1), atol=SELF_ATOL, rtol=0)
    np.testing.assert_array_equal(y_len, np.clip(enc.y_total.numpy(), 1, total))

    zero = (0.0, 1.0, 0.0)
    a0, l0 = sharded.synthesize_long(ids, lengths, span=span, seed=77, scales=zero)
    ja, jl = JShardedVits.create(j_make_mesh(4, seq_parallel=4), jp, _jhp(TINY)) \
        .synthesize_long(ids, lengths, span=span, seed=77, scales=zero)
    np.testing.assert_array_equal(l0, jl)
    np.testing.assert_allclose(a0, ja, atol=WAVE_ATOL, rtol=0)


def test_sp_dp_combined_mesh_still_works():
    _, pt, _ = _weights(TINY, 18)
    sharded = ShardedVits.create(cpu_mesh(8, seq_parallel=2), pt, TINY)
    ids = np.random.default_rng(1).integers(0, TINY.n_vocab, size=(1, 8))
    audio, _ = sharded.synthesize_long(ids, np.array([8]), span=8, seed=3)
    assert audio.shape == (1, 2 * 8 * TINY.hop_length) and np.isfinite(audio).all()


# -- test_tensor_parallel.py ----------------------------------------------


def _synthesize(mesh, hp, *, b, p, sid=None, seed=11):
    pt = _weights(hp, 3)[1]
    rng = np.random.default_rng(1)
    ids = rng.integers(0, hp.n_vocab, size=(b, p))
    return ShardedVits.create(mesh, pt, hp).synthesize_batch(
        ids, np.full((b,), p, np.int64), max_frames=24, sid=sid, seed=seed)


def test_tp_specs_shard_the_expected_axes():
    hp = TINY_TP_MULTI
    pt = _weights(hp, 0)[1]
    mesh = cpu_mesh(8, tensor_parallel=2)
    shardings = ttp.tp_param_shardings(pt, mesh)
    assert set(shardings) == set(pt)

    def spec(name):
        return shardings[name].spec

    assert spec("dec.conv_pre.weight")[0] == TENSOR_AXIS
    assert spec("dec.conv_pre.bias")[0] == TENSOR_AXIS
    assert spec("dec.cond.weight")[0] == TENSOR_AXIS
    assert spec("dec.ups.0.weight")[1] == TENSOR_AXIS
    assert spec("dec.ups.0.bias")[0] == TENSOR_AXIS
    assert spec("dec.resblocks.0.convs1.0.weight")[0] == TENSOR_AXIS
    assert spec("dec.resblocks.0.convs2.0.weight")[1] == TENSOR_AXIS
    assert spec("dec.resblocks.0.convs2.0.bias") == ()
    assert spec("dec.conv_post.weight")[1] == TENSOR_AXIS
    assert spec("flow.flows.0.enc.in_layers.0.weight")[0] == TENSOR_AXIS
    assert spec("flow.flows.0.enc.res_skip_layers.0.weight")[1] == TENSOR_AXIS
    assert all(shardings[n].is_fully_replicated for n in pt if n.startswith("enc_p."))
    # The same table as JAX's, spec for spec.
    from piper_tpu.parallel.tp import _spec_for as j_spec_for

    for name, t in pt.items():
        assert tuple(j_spec_for(name, t.shape, 2)) == spec(name), name
    # Each slot holds its piece: slot (dp, tp=1) the second half of C_out.
    slots = ttp.place_params(pt, mesh)
    w = pt["dec.conv_pre.weight"]
    assert torch.equal(slots[mesh.index(dp=1, tp=1)]["dec.conv_pre.weight"],
                       w[w.shape[0] // 2:])


def test_tp_spec_falls_back_to_replicated_when_not_divisible():
    assert ttp._spec_for("dec.conv_pre.weight", (3, 16, 7), 2) == ()
    assert ttp._spec_for("dec.conv_pre.bias", (3,), 2) == ()
    assert ttp._spec_for("dec.conv_post.weight", (1, 15, 7), 2) == ()


def test_tp_infer_matches_replicated():
    ref_audio, ref_len = _synthesize(cpu_mesh(1), TINY_TP, b=2, p=10)
    audio, y_len = _synthesize(cpu_mesh(4, tensor_parallel=4), TINY_TP, b=2, p=10)
    assert (y_len == ref_len).all()
    np.testing.assert_allclose(audio, ref_audio, atol=SELF_ATOL, rtol=0)


def test_tp_composes_with_dp():
    ref_audio, ref_len = _synthesize(cpu_mesh(1), TINY_TP, b=4, p=10)
    audio, y_len = _synthesize(cpu_mesh(8, tensor_parallel=2), TINY_TP, b=4, p=10)
    assert (y_len == ref_len).all()
    np.testing.assert_allclose(audio, ref_audio, atol=SELF_ATOL, rtol=0)
    # ...and JAX's dp x tp mesh replicated-equal too: both against JAX's
    # one-device run at the same seed.
    w, _, jp = _weights(TINY_TP, 3)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, TINY_TP.n_vocab, size=(4, 10))
    ja, jl = JShardedVits.create(j_make_mesh(8, tensor_parallel=2), jp, _jhp(TINY_TP)) \
        .synthesize_batch(ids, np.full((4,), 10, np.int32), max_frames=24, seed=11)
    np.testing.assert_array_equal(y_len, jl)
    np.testing.assert_allclose(audio, ja, atol=WAVE_ATOL, rtol=0)


def test_tp_multispeaker_matches_replicated():
    sid = np.array([1, 3], np.int64)
    ref_audio, ref_len = _synthesize(cpu_mesh(1), TINY_TP_MULTI, b=2, p=8, sid=sid)
    audio, y_len = _synthesize(cpu_mesh(4, tensor_parallel=2), TINY_TP_MULTI, b=2, p=8,
                               sid=sid)
    assert (y_len == ref_len).all()
    np.testing.assert_allclose(audio, ref_audio, atol=SELF_ATOL, rtol=0)


def test_tp_runtime_serving_matches_single_device(tiny_voice):
    """A PiperRuntime on a dp x tp mesh serves the same stack (fused
    dispatch, BatchingServer) and matches the one-device runtime."""
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIX
    from piper_tpu_torch.engine.batcher import BatchingServer
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions

    single = PiperRuntime(*tiny_voice, RuntimeOptions(mode="fused"), device="cpu")
    rt = PiperRuntime(*tiny_voice, RuntimeOptions(mode="fused"),
                      mesh=cpu_mesh(8, tensor_parallel=2))
    assert rt._tp_size == 2 and rt._dp_size == 4
    # The tp-sharded weight is a shard, not a copy.
    assert rt.params["dec.conv_pre.weight"].shape[0] * 2 == \
        single.params["dec.conv_pre.weight"].shape[0]
    assert rt.hbm_bytes() == single.hbm_bytes()
    np.testing.assert_allclose(rt.synthesize(FIX, seed=5), single.synthesize(FIX, seed=5),
                               atol=SELF_ATOL, rtol=0)

    def serve(runtime):
        with BatchingServer(runtime, max_batch=8, max_wait_ms=20) as server:
            futs = [server.submit(FIX) for _ in range(5)]
            futs += [server.submit(FIX[:6]) for _ in range(3)]
            out = [f.result(timeout=600) for f in futs]
        m = server.metrics()
        assert m["completed"] == 8 and m["failed"] == 0
        return out

    for got, want in zip(serve(rt), serve(single)):
        assert np.isfinite(got).all() and len(got) > 0
        np.testing.assert_allclose(got, want, atol=SELF_ATOL, rtol=0)


def test_tp_rejects_sp_decode():
    pt = _weights(TINY_TP, 3)[1]
    sharded = ShardedVits.create(cpu_mesh(4, tensor_parallel=2), pt, TINY_TP)
    with pytest.raises(NotImplementedError):
        sharded.sp_decode_fn(span=16)
    with pytest.raises(NotImplementedError):
        sharded.synthesize_long(np.zeros((1, 8), np.int64), np.full((1,), 8), span=16)
    assert sharded.builds == 0  # failed before the encoder was built


def test_tp_rejects_explicit_pallas(tiny_voice):
    """use_pallas=True contradicts tp: both serving surfaces raise."""
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions

    pt = _weights(TINY_TP, 3)[1]
    with pytest.raises(ValueError, match="use_pallas"):
        ShardedVits.create(cpu_mesh(4, tensor_parallel=2), pt, TINY_TP, use_pallas=True)
    with pytest.raises(ValueError, match="use_pallas"):
        PiperRuntime(*tiny_voice, RuntimeOptions(use_pallas=True),
                     mesh=cpu_mesh(8, tensor_parallel=2))
    # Without the request tp resolves to the plain convs, as JAX's does.
    assert ShardedVits.create(cpu_mesh(4, tensor_parallel=2), pt, TINY_TP).use_pallas is False


# -- test_pp.py -----------------------------------------------------------


def _encode_and_reference(hp, b=4, p=8, max_frames=16, seed=0, sid=None):
    """The port's encode and one-device decode of one batch, with numpy
    noise."""
    pt = _weights(hp, 11)[1]
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(0, hp.n_vocab, size=(b, p)))
    lengths = torch.full((b,), p)
    dpn = torch.from_numpy(rng.standard_normal((b, 2, p)).astype(np.float32))
    mn = torch.from_numpy(rng.standard_normal((b, hp.inter_channels, max_frames))
                          .astype(np.float32))
    with torch.inference_mode():
        enc = tv.encode(pt, hp, ids, lengths, dpn,
                        sid=None if sid is None else torch.as_tensor(sid))
        audio, ylen = tv.decode(pt, hp, enc, mn, max_frames=max_frames)
    return pt, enc, mn, audio.numpy(), ylen.numpy()


def _pp(pt, hp, enc, mn, mesh, **kw):
    with torch.inference_mode():
        audio, ylen = pp_decode(pt, hp, enc, mn, mesh=mesh, max_frames=16, **kw)
    return audio.numpy(), ylen.numpy()


def test_balanced_cuts_properties():
    costs = [5.0, 3.0, 8.0, 8.0, 2.0, 1.0]
    cuts = balanced_cuts(costs, 3)
    assert cuts[0] == 0 and cuts[-1] == len(costs) and sorted(cuts) == cuts
    assert max(sum(costs[cuts[s]: cuts[s + 1]]) for s in range(3)) == 11.0
    assert cuts == jpp.balanced_cuts(costs, 3)
    with pytest.raises(ValueError):
        balanced_cuts([1.0, 2.0], 3)
    fl = unit_flops(TINY_PP, 16)
    assert len(fl) == 2 + TINY_PP.num_upsamples and fl[-1] == min(fl)
    # The same cost model and cuts as JAX's, on the medium preset too.
    from piper_tpu_torch.models.vits.hparams import PRESETS

    from piper_tpu_torch.parallel.pp import _boundary_shapes, unit_names

    for hp in (TINY_PP, PRESETS["medium"]):
        assert unit_names(hp) == jpp.unit_names(_jhp(hp))
        assert _boundary_shapes(hp, 256) == jpp._boundary_shapes(_jhp(hp), 256)
        assert unit_flops(hp, 256) == jpp.unit_flops(_jhp(hp), 256)
        for s in (2, 3, 4):
            assert balanced_cuts(unit_flops(hp, 256), s) == \
                jpp.balanced_cuts(jpp.unit_flops(_jhp(hp), 256), s)


def test_default_microbatches():
    assert default_microbatches(8, 2) == 4
    assert default_microbatches(8, 4) == 8
    assert default_microbatches(6, 4) == 6
    assert default_microbatches(1, 4) == 1
    assert default_microbatches(7, 2) == 1
    for rows in range(1, 33):
        for s in (2, 3, 4):
            assert default_microbatches(rows, s) == jpp.default_microbatches(rows, s)


def test_pp_rejects_bad_meshes():
    pt = _weights(TINY_PP, 11)[1]
    with pytest.raises(NotImplementedError):
        build_pp_decode(cpu_mesh(4, seq_parallel=2, pipeline_parallel=2), TINY_PP,
                        max_frames=16, rows_per_dp=4, with_g=False)
    with pytest.raises(ValueError):
        build_pp_decode(cpu_mesh(4), TINY_PP, max_frames=16, rows_per_dp=4, with_g=False)
    sv = ShardedVits.create(cpu_mesh(4, tensor_parallel=2), pt, TINY_PP)
    with pytest.raises(NotImplementedError):
        sv.pp_decode_fn(16, 4)
    with pytest.raises(ValueError):  # more stages than units (TINY_PP has 4)
        build_pp_decode(cpu_mesh(8, pipeline_parallel=8), TINY_PP, max_frames=16,
                        rows_per_dp=8, with_g=False)
    with pytest.raises(ValueError):
        build_pp_decode(cpu_mesh(2, pipeline_parallel=2), TINY_PP, max_frames=16,
                        rows_per_dp=4, with_g=False, microbatches=3)


def test_pp_matches_single_device_decode():
    pt, enc, mn, ref_audio, ref_ylen = _encode_and_reference(TINY_PP)
    audio, ylen = _pp(pt, TINY_PP, enc, mn, cpu_mesh(2, pipeline_parallel=2))
    np.testing.assert_allclose(audio, ref_audio, atol=SELF_ATOL, rtol=0)
    np.testing.assert_array_equal(ylen, ref_ylen)


def test_pp_microbatch_count_is_invisible():
    """M=1 against M=4: microbatching is a pure row split. JAX holds the
    two bit-equal; PyTorch's CPU convs order their fp32 sums by the batch's
    shape, so here they agree within the bar."""
    pt, enc, mn, ref_audio, _ = _encode_and_reference(TINY_PP)
    mesh = cpu_mesh(2, pipeline_parallel=2)
    a1, _ = _pp(pt, TINY_PP, enc, mn, mesh, microbatches=1)
    a4, _ = _pp(pt, TINY_PP, enc, mn, mesh, microbatches=4)
    np.testing.assert_allclose(a1, ref_audio, atol=SELF_ATOL, rtol=0)
    np.testing.assert_allclose(a1, a4, atol=SELF_ATOL, rtol=0)


def test_pp_composes_with_dp():
    """dp=2 x pp=2 through ShardedVits against its dp-fused audio, and
    against JAX's synthesize_pipelined at the same seed (the encoder's
    tensors within 2e-5, the waveform within 1e-4)."""
    _, pt, jp = _weights(TINY_PP, 11)
    rng = np.random.default_rng(3)
    b, p, f = 4, 8, 16
    ids = rng.integers(0, TINY_PP.n_vocab, size=(b, p))
    lengths = np.full((b,), p, np.int64)
    sv_pp = ShardedVits.create(cpu_mesh(4, pipeline_parallel=2), pt, TINY_PP)
    a_pp, l_pp = sv_pp.synthesize_pipelined(ids, lengths, max_frames=f)
    a_dp, l_dp = ShardedVits.create(cpu_mesh(4), pt, TINY_PP).synthesize_batch(
        ids, lengths, max_frames=f)
    np.testing.assert_allclose(a_pp, a_dp, atol=SELF_ATOL, rtol=0)
    np.testing.assert_array_equal(l_pp.astype(np.int64), l_dp.astype(np.int64))

    jsv = JShardedVits.create(j_make_mesh(4, pipeline_parallel=2), jp, _jhp(TINY_PP))
    ja, jl = jsv.synthesize_pipelined(ids, lengths.astype(np.int32), max_frames=f)
    np.testing.assert_array_equal(l_pp.astype(np.int64), np.asarray(jl).astype(np.int64))
    np.testing.assert_allclose(a_pp, ja, atol=WAVE_ATOL, rtol=0)
    dpn = np.random.default_rng(1234).standard_normal((b, 2, p)).astype(np.float32)
    enc = sv_pp.encode_fn(1.0, 0.8)(torch.as_tensor(ids), torch.as_tensor(lengths),
                                    torch.from_numpy(dpn), None)
    import jax.numpy as jnp

    jenc = jsv.encode_fn(1.0, 0.8)(jsv.params, jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(lengths, jnp.int32), jnp.asarray(dpn), None)
    for name in ("m_p", "logs_p", "x_mask"):
        np.testing.assert_allclose(getattr(enc, name).numpy(), np.asarray(getattr(jenc, name)),
                                   atol=MODULE_ATOL, rtol=0)
    np.testing.assert_array_equal(enc.w_ceil.numpy(), np.asarray(jenc.w_ceil))


def test_pp_multispeaker():
    sid = np.array([0, 1, 2, 1], np.int64)
    pt, enc, mn, ref_audio, ref_ylen = _encode_and_reference(TINY_PP_MS, sid=sid)
    audio, ylen = _pp(pt, TINY_PP_MS, enc, mn, cpu_mesh(4, pipeline_parallel=4))
    np.testing.assert_allclose(audio, ref_audio, atol=SELF_ATOL, rtol=0)
    np.testing.assert_array_equal(ylen, ref_ylen)


def test_pp_mesh_guards_on_whole_graph_paths():
    pt = _weights(TINY_PP, 11)[1]
    sv = ShardedVits.create(cpu_mesh(4, pipeline_parallel=2), pt, TINY_PP)
    with pytest.raises(NotImplementedError, match="synthesize_pipelined"):
        sv.infer_fn(16)
    with pytest.raises(NotImplementedError, match="synthesize_pipelined"):
        sv.sp_decode_fn(8)
    with pytest.raises(NotImplementedError, match="synthesize_pipelined"):
        sv.synthesize_batch(np.zeros((4, 8), np.int64), np.full((4,), 8), max_frames=16)


def test_pp_decode_fn_cache_resolves_default_microbatches():
    pt = _weights(TINY_PP, 11)[1]
    sv = ShardedVits.create(cpu_mesh(2, pipeline_parallel=2), pt, TINY_PP)
    m = default_microbatches(4, 2)
    assert sv.pp_decode_fn(16, 4) is sv.pp_decode_fn(16, 4, microbatches=m)
    assert len(sv._pp_decode_fns) == 1


def test_encode_fn_is_cached_across_calls():
    pt = _weights(TINY_PP, 11)[1]
    sv = ShardedVits.create(cpu_mesh(2, pipeline_parallel=2), pt, TINY_PP)
    assert sv.encode_fn(1.0, 0.8) is sv.encode_fn(1.0, 0.8)
    assert sv.encode_fn(1.0, 0.8, keyed=True) is sv.encode_fn(1.0, 0.8, keyed=True)
    assert sv.encode_fn(1.0, 0.8) is not sv.encode_fn(1.1, 0.8)
    ids = np.random.default_rng(3).integers(0, TINY_PP.n_vocab, size=(2, 8))
    lengths = np.full((2,), 8)
    n_before, builds = len(sv._enc_fns), sv.builds
    sv.synthesize_pipelined(ids, lengths, max_frames=16)
    sv.synthesize_pipelined(ids, lengths, max_frames=16)
    assert len(sv._enc_fns) == n_before
    assert sv.builds == builds + 1  # the one pp decode, built once
