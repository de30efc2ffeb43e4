"""The port's PiperRuntime(mesh=...) on virtual CPU slots.

Counterparts of tests/test_mesh_runtime.py's cases: a runtime on an 8-slot
dp mesh drives the same serving stack (BatchingServer, dispatch/fetch,
streams, StreamingServer, MultiVoiceBatchingServer, UnifiedServer) with
rows split over the dp groups. The port's seeded noise is one draw per row
broadcast over the rows, so the mesh runtime's audio is held to the
one-device runtime's on the same request within 2e-5 (the dp split changes
only the batch shape the CPU convs sum over); the injected-noise path,
which runs whole on the first group, is held to the JAX mesh runtime's
within 1e-4.
"""

import threading

import numpy as np
import pytest
import torch

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIX
from piper_tpu_torch.engine.batcher import BatchingServer
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
from piper_tpu_torch.parallel import tp as ttp
from piper_tpu_torch.parallel.mesh import make_mesh

ATOL = 2e-5


def cpu_mesh(n, **kw):
    return make_mesh(n, devices=["cpu"] * 8, **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return cpu_mesh(8)


@pytest.fixture(scope="module")
def mesh_runtime(tiny_voice, mesh):
    return PiperRuntime(*tiny_voice, RuntimeOptions(mode="fused"), mesh=mesh)


@pytest.fixture(scope="module")
def single(tiny_voice):
    return PiperRuntime(*tiny_voice, RuntimeOptions(mode="fused"), device="cpu")


def test_runtime_rejects_pp_mesh(tiny_voice):
    with pytest.raises(NotImplementedError, match="synthesize_pipelined"):
        PiperRuntime(*tiny_voice, mesh=cpu_mesh(4, pipeline_parallel=2))


def test_batch_ladder_is_dp_divisible(mesh_runtime):
    assert all(x % 8 == 0 for x in mesh_runtime.batch_ladder)
    assert mesh_runtime.batch_ladder[0] == 8
    assert cpu_mesh(8, tensor_parallel=8).shape["dp"] == 1


def test_params_replicated(mesh_runtime, mesh, single):
    """Every dp group reads the weights on its slot's device; virtual slots
    of one device share one copy, equal to the one-device runtime's."""
    groups = mesh_runtime._groups
    assert [g.slot for g in groups] == [mesh.index(dp=d) for d in range(8)]
    assert all(g.params[k] is groups[0].params[k] for g in groups for k in g.params)
    for name, t in single.params.items():
        assert torch.equal(mesh_runtime.params[name], t), name
    assert mesh_runtime.hbm_bytes() == single.hbm_bytes()


def test_single_utterance_on_mesh(mesh_runtime, single):
    audio = mesh_runtime.synthesize(FIX)
    assert len(audio) > 0 and np.isfinite(audio).all()
    np.testing.assert_allclose(audio, single.synthesize(FIX), atol=ATOL, rtol=0)


def test_batch_shards_rows_over_dp(mesh_runtime, single):
    """A 3-row batch pads to the 8-rung, one row per dp group; the sliced
    results keep each request's exact length."""
    batch = [FIX, FIX[:6], FIX * 2]
    audios = mesh_runtime.synthesize_batch(batch)
    assert len(audios) == 3 and len(audios[2]) > len(audios[1])
    assert mesh_runtime.last_run_timings.frame_bucket > 0
    for got, want in zip(audios, single.synthesize_batch(batch)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_dispatch_fetch_fused_on_mesh(mesh_runtime, single):
    outs, meta = mesh_runtime.dispatch_batch([FIX, FIX[:6]], fused=True)
    assert meta["fused_batch"]
    audios = mesh_runtime.fetch_batch(outs, meta)
    assert len(audios) == 2 and all(len(a) > 0 for a in audios)
    # A single fused dispatch rides the batched path on a mesh.
    outs, meta = mesh_runtime.dispatch_fused(FIX, seed=9)
    assert meta["fused_batch"]
    np.testing.assert_allclose(mesh_runtime.fetch_fused(outs, meta),
                               single.synthesize(FIX, seed=9), atol=ATOL, rtol=0)


def test_injected_noise_matches_single_device(tiny_voice, mesh):
    """The injected-noise path runs whole on the first group: numerically
    the one-device computation, and JAX's mesh runtime's."""
    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime
    from piper_tpu.parallel.mesh import make_mesh as j_make_mesh

    rng = np.random.default_rng(7)
    dp_noise = rng.standard_normal((1, 2, 16)).astype(np.float32)
    single = PiperRuntime(*tiny_voice, device="cpu")
    main_noise = rng.standard_normal((1, single.hparams.inter_channels, 64)).astype(
        np.float32)
    a_single = single.synthesize(FIX, dp_noise=dp_noise, main_noise=main_noise)
    a_mesh = PiperRuntime(*tiny_voice, mesh=mesh).synthesize(
        FIX, dp_noise=dp_noise, main_noise=main_noise)
    assert a_single.shape == a_mesh.shape
    np.testing.assert_allclose(a_mesh, a_single, atol=1e-5, rtol=0)
    a_jax = JaxRuntime(*tiny_voice, mesh=j_make_mesh(8)).synthesize(
        FIX, dp_noise=dp_noise, main_noise=main_noise)
    assert a_jax.shape == a_mesh.shape
    np.testing.assert_allclose(a_mesh, a_jax, atol=1e-4, rtol=0)


def test_batching_server_over_mesh(mesh_runtime):
    with BatchingServer(mesh_runtime, max_batch=8, max_wait_ms=50) as server:
        assert server.fused
        futs = [server.submit(FIX) for _ in range(10)]
        futs += [server.submit(FIX[:6]) for _ in range(5)]
        futs += [server.submit(FIX * 2) for _ in range(3)]
        audios = [f.result(timeout=600) for f in futs]
    assert len(audios) == 18
    assert all(len(a) > 0 and np.isfinite(a).all() for a in audios)
    m = server.metrics()
    assert m["completed"] == 18 and m["failed"] == 0


def test_streaming_on_mesh(mesh_runtime, single):
    chunks = list(mesh_runtime.synthesize_stream(FIX * 2, incremental=True, seed=4))
    assert chunks[-1].is_final
    got = np.concatenate([c.samples for c in chunks])
    want = np.concatenate([c.samples for c in single.synthesize_stream(
        FIX * 2, incremental=True, seed=4)])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_stream_server_on_mesh(mesh_runtime):
    """Concurrent streams through StreamingServer on a mesh runtime match
    their solo mesh decodes (heads and windows run on the first group)."""
    from piper_tpu_torch.engine.stream_server import StreamingServer

    srv = StreamingServer(mesh_runtime, emit_frames=16, c0=8, row_rungs=(1, 2, 4),
                          max_sessions=8)
    try:
        cases = [(FIX * 2, 61), (FIX, 62)]
        results, errors = {}, []

        def run(i, ids, seed):
            try:
                chunks = list(srv.submit(ids, seed=seed))
                assert chunks[-1].is_final
                results[i] = np.concatenate([c.samples for c in chunks])
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i, ids, seed))
                   for i, (ids, seed) in enumerate(cases)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        for i, (ids, seed) in enumerate(cases):
            ref = np.concatenate([c.samples for c in
                                  mesh_runtime.synthesize_stream_incremental(ids, seed=seed)])
            assert len(results[i]) == len(ref)
            np.testing.assert_allclose(results[i], ref, atol=1e-5)
    finally:
        srv.shutdown()


def test_multivoice_batching_over_mesh(tiny_voice, mesh):
    """Two mesh runtimes behind one MultiVoiceBatchingServer: multi-voice
    continuous batching and the dp split compose, one worker thread."""
    from piper_tpu_torch.engine.batcher import MultiVoiceBatchingServer

    rts = {k: PiperRuntime(*tiny_voice, RuntimeOptions(mode="fused"), mesh=mesh)
           for k in ("a", "b")}
    with MultiVoiceBatchingServer(rts, max_batch=8, max_wait_ms=30) as srv:
        futs = [srv.submit("a" if i % 2 else "b", FIX[: 6 + i]) for i in range(6)]
        audios = [f.result(timeout=600) for f in futs]
    assert all(len(a) > 0 and np.isfinite(a).all() for a in audios)
    m = srv.metrics()
    assert m["a"]["rows"] == 3 and m["b"]["rows"] == 3


def test_phoneme_durations_on_mesh_snaps_pad_rows(mesh_runtime, single):
    """A pinned row count that is not dp-divisible snaps up inside
    phoneme_durations, and the durations match the audio and the server's."""
    d = mesh_runtime.phoneme_durations([FIX], pad_rows_to=3)[0]
    assert d.shape == (len(FIX),)
    np.testing.assert_array_equal(d, single.phoneme_durations([FIX])[0])
    audio = mesh_runtime.synthesize(FIX)
    assert int(d.sum()) * mesh_runtime.hparams.hop_length >= len(audio)
    with BatchingServer(mesh_runtime, max_batch=8, max_wait_ms=20) as server:
        d2 = server.submit_durations(FIX).result(timeout=300)
    np.testing.assert_array_equal(d, d2)


def test_forced_and_unified_over_mesh(tiny_voice, mesh, single):
    """The rest of the stack: a forced batch splits its rows over dp, and a
    UnifiedServer of a mesh runtime serves batch and stream traffic."""
    from piper_tpu_torch.engine.unified import UnifiedServer

    rt = PiperRuntime(*tiny_voice, RuntimeOptions(mode="fused"), mesh=mesh)
    plan = [2] * len(FIX)
    got = rt.synthesize_batch_forced([FIX, FIX], [plan, plan], seed=3, pad_rows_to=3)
    want = single.synthesize_batch_forced([FIX, FIX], [plan, plan], seed=3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    with UnifiedServer({"m": rt}, max_batch=8, max_wait_ms=10,
                       stream_kwargs=dict(emit_frames=16, c0=8, row_rungs=(1, 2))) as srv:
        fut = srv.submit("m", FIX)
        chunks = list(srv.submit_stream("m", FIX, seed=2))
        audio = fut.result(timeout=300)
    assert len(audio) > 0 and chunks[-1].is_final


def test_plain_convs_and_tp_stages(tiny_voice, single):
    """use_pallas=False runs the tp forward's PyTorch convs on one device
    (JAX's XLA convs); a tp mesh runs them over its shards."""
    plain = PiperRuntime(*tiny_voice, RuntimeOptions(mode="fused", use_pallas=False),
                         device="cpu")
    assert plain._group(0).stages.generator is ttp.hifigan_generator
    assert single._group(0).stages.generator is not ttp.hifigan_generator
    np.testing.assert_allclose(plain.synthesize(FIX, seed=1), single.synthesize(FIX, seed=1),
                               atol=ATOL, rtol=0)
    tp = PiperRuntime(*tiny_voice, RuntimeOptions(mode="fused"),
                      mesh=cpu_mesh(8, tensor_parallel=2))
    group = tp._group(1).stages.params
    assert isinstance(group, ttp.TPGroup) and len(group.slots) == 2
    chunks = list(tp.synthesize_stream_incremental(FIX * 2, seed=3))
    want = list(single.synthesize_stream_incremental(FIX * 2, seed=3))
    np.testing.assert_allclose(np.concatenate([c.samples for c in chunks]),
                               np.concatenate([c.samples for c in want]), atol=ATOL, rtol=0)
    tp.close()
    assert tp.closed and tp.hbm_bytes() == 0
    with pytest.raises(RuntimeError, match="closed"):
        tp.synthesize(FIX)
