"""The port's UnifiedServer (piper_tpu_torch.engine.unified): batch and
stream traffic on ONE worker thread, on the CPU.

Every case of tests/test_unified.py under its own name, on the port's
runtime at device="cpu" (the stub-runtime cases as they are, on the port's
batcher), and the UnifiedServer cases of tests/test_voice_lifecycle.py.
Streams are held to the port's own solo synthesize_stream_incremental
within 1e-5 (the same fp32 sums, ordered by the batch's shape on the CPU).
Then one UnifiedServer of the port against the JAX package's on the same
voice at noise_scale=0, noise_w=0: batch futures and streams within 1e-4
max-abs, their lengths and the served durations equal.

Torch runs one intra-op thread in this module (see
tests/test_torch_stream_server.py).
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine.batcher import BatchingServer, MultiVoiceBatchingServer
from piper_tpu_torch.engine.runtime import PiperRuntime
from piper_tpu_torch.engine.unified import UnifiedServer

ROW_ATOL = 1e-5
WAVE_ATOL = 1e-4
ZERO = dict(noise_scale=0.0, noise_w=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runtime(tiny_voice):
    return PiperRuntime(*tiny_voice, device="cpu")


def _collect(chunks):
    chunks = list(chunks)
    assert chunks[-1].is_final
    assert all(not c.is_final for c in chunks[:-1])
    return np.concatenate([c.samples for c in chunks])


def _reference(rt, ids, seed):
    return np.concatenate([c.samples for c in rt.synthesize_stream_incremental(ids, seed=seed)])


@pytest.fixture(scope="module")
def unified(runtime):
    srv = UnifiedServer(
        {"v": runtime}, max_batch=4, max_wait_ms=5,
        stream_kwargs=dict(emit_frames=16, c0=8, row_rungs=(1, 2, 4), max_sessions=8))
    yield srv
    srv.close()


# -- tests/test_unified.py on the port ---------------------------------------------


def test_batch_then_stream_one_server(unified, runtime):
    """Both surfaces work from one server object; stream audio is exact
    vs the solo incremental reference."""
    fut = unified.submit("v", FIXTURE_IDS)
    audio = fut.result(timeout=300)
    assert len(audio) > 0 and np.isfinite(audio).all()
    ids = FIXTURE_IDS * 3
    got = _collect(unified.submit_stream("v", ids, seed=5))
    ref = _reference(runtime, ids, seed=5)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, atol=ROW_ATOL)


def test_mixed_batch_and_stream_load(unified, runtime):
    """Concurrent batch submitters AND stream consumers on one worker:
    every future resolves, every stream is exact, nothing deadlocks."""
    ids = FIXTURE_IDS * 2
    ref = _reference(runtime, ids, seed=21)
    stream_out = {}
    errors = []

    def stream_client(i):
        try:
            stream_out[i] = _collect(unified.submit_stream("v", ids, seed=21))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=stream_client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    # Batch traffic while the streams decode.
    futs = [unified.submit("v", FIXTURE_IDS[: 4 + i % 6]) for i in range(12)]
    durs = unified.submit_durations("v", FIXTURE_IDS)
    batch = [f.result(timeout=300) for f in futs]
    d = durs.result(timeout=300)
    for t in threads:
        t.join(timeout=300)
    assert not errors
    assert all(len(a) > 0 and np.isfinite(a).all() for a in batch)
    assert d.sum() > 0
    for i in range(3):
        np.testing.assert_allclose(stream_out[i], ref, atol=ROW_ATOL)
    m = unified.metrics()
    assert m["batch"]["v"]["completed"] >= 12
    assert m["stream"]["v"]["sessions"] >= 3


def test_stream_exact_under_batch_traffic(unified, runtime):
    """A stream that RUNS while batch groups dispatch equals its solo
    decode at the fp32 tolerance — scheduling never changes realization."""
    ids = FIXTURE_IDS * 4
    ref = _reference(runtime, ids, seed=7)
    handle = unified.submit_stream("v", ids, seed=7)
    futs = [unified.submit("v", FIXTURE_IDS) for _ in range(6)]
    got = _collect(handle)
    for f in futs:
        assert len(f.result(timeout=300)) > 0
    np.testing.assert_allclose(got, ref, atol=ROW_ATOL)


def test_unknown_voice_and_closed(runtime):
    srv = UnifiedServer({"v": runtime}, max_batch=2, max_wait_ms=2,
                        stream_kwargs=dict(emit_frames=16, c0=8, row_rungs=(1, 2)))
    try:
        with pytest.raises(KeyError):
            srv.submit_stream("nope", FIXTURE_IDS)
        with pytest.raises(KeyError):
            srv.submit("nope", FIXTURE_IDS)
    finally:
        srv.close()
    with pytest.raises(RuntimeError):
        srv.submit_stream("v", FIXTURE_IDS)
    with pytest.raises(RuntimeError):
        srv.submit("v", FIXTURE_IDS)


# -- non-pausing add_voice (stub-level, deterministic timing) ------------------------


class _StubRT:
    """Instant dispatch/fetch stand-in (see test_torch_batcher._StubRuntime)."""

    def __init__(self):
        self.hparams = SimpleNamespace(n_vocab=1000, hop_length=4)
        self.options = SimpleNamespace(
            phoneme_buckets=(16, 32, 64), batch_buckets=(1, 2, 4, 8), mode="split")

    def dispatch_batch(self, ids_batch, **kw):
        return None, {"b": len(ids_batch)}

    def fetch_batch(self, outs, meta):
        return [np.zeros(8, np.float32)] * meta["b"]


def test_add_voice_warm_steps_interleave_with_traffic():
    """A cold add_voice must NOT pause resident voices for its whole grid.
    Warm steps (stubbed at 40 ms each) interleave with traffic at one-step
    granularity, so no resident-voice request waits longer than ~one step,
    where pausing would wait for the full grid (here 8 * 40 = 320 ms)."""
    step_times = []
    STEP_S = 0.04
    N_STEPS = 8

    def make_steps():
        def one():
            time.sleep(STEP_S)
            step_times.append(time.perf_counter())
        for _ in range(N_STEPS):
            yield ("program", one)

    srv = MultiVoiceBatchingServer({"a": _StubRT()}, max_batch=4, max_wait_ms=1, warm_every=1)
    try:
        fut = srv.add_voice("b", _StubRT(), prewarm=False, extra_warm_steps=make_steps())
        latencies = []
        deadline = time.perf_counter() + 10.0
        while not fut.done() and time.perf_counter() < deadline:
            t0 = time.perf_counter()
            srv.submit("a", FIXTURE_IDS).result(timeout=30)
            latencies.append(time.perf_counter() - t0)
        stats = fut.result(timeout=30)
        assert stats["programs"] == N_STEPS
        assert len(step_times) == N_STEPS
        # The whole grid took >= N_STEPS * STEP_S of worker time, yet no
        # resident request waited anywhere near that.
        assert latencies, "no traffic completed during warming"
        assert max(latencies) < N_STEPS * STEP_S * 0.75, (
            f"a resident request stalled {max(latencies) * 1e3:.0f} ms — "
            f"warming is pausing traffic")
        # And traffic genuinely interleaved: steps did not all run
        # back-to-back before the first request completed.
        assert len(latencies) >= 3
        # The new voice serves after (and during) warming.
        assert srv.submit("b", FIXTURE_IDS).result(timeout=30).shape == (8,)
        assert srv.ready()
    finally:
        srv.close()


def test_add_voice_warming_progress_and_metrics():
    """warming() exposes per-voice progress while steps run; ready() is
    False mid-warm and True after."""
    gate = threading.Event()
    entered = threading.Event()

    def make_steps():
        def blocked():
            entered.set()
            gate.wait(timeout=30)
        yield ("program", blocked)
        yield ("program", lambda: None)

    srv = MultiVoiceBatchingServer({"a": _StubRT()}, max_batch=4, max_wait_ms=1)
    try:
        fut = srv.add_voice("b", _StubRT(), prewarm=False, extra_warm_steps=make_steps())
        assert entered.wait(timeout=30)
        assert not srv.ready()
        w = srv.warming()
        assert "b" in w and w["b"]["programs"] == 0
        gate.set()
        stats = fut.result(timeout=30)
        assert stats["programs"] == 2
        assert srv.ready() and srv.warming() == {}
    finally:
        gate.set()
        srv.close()


def test_add_voice_failed_step_surfaces_on_future():
    def make_steps():
        yield ("program", lambda: None)

        def boom():
            raise ValueError("injected warm failure")
        yield ("program", boom)

    srv = MultiVoiceBatchingServer({"a": _StubRT()}, max_batch=4, max_wait_ms=1)
    try:
        fut = srv.add_voice("b", _StubRT(), prewarm=False, extra_warm_steps=make_steps())
        with pytest.raises(ValueError, match="injected warm failure"):
            fut.result(timeout=30)
        # the voice stays registered: already-warm shapes serve
        assert srv.submit("b", FIXTURE_IDS).result(timeout=30).shape == (8,)
    finally:
        srv.close()


def test_unified_add_and_remove_voice(tiny_voice, runtime):
    """add_voice on a live UnifiedServer: batch grid + STREAM grid warm
    between traffic; remove_voice drains open streams gracefully."""
    srv = UnifiedServer({"v": runtime}, max_batch=2, max_wait_ms=2,
                        stream_kwargs=dict(emit_frames=16, c0=8, row_rungs=(1, 2)))
    try:
        rt2 = PiperRuntime(*tiny_voice, device="cpu")
        fut = srv.add_voice(
            "w", rt2, p_buckets=[16],
            stream_prewarm_kwargs=dict(phoneme_lengths=(14,), row_rungs=(1, 2),
                                       head_rungs=(1,)))
        # the resident voice keeps serving while w warms
        assert len(srv.submit("v", FIXTURE_IDS).result(timeout=300)) > 0
        while not fut.done():
            assert len(srv.submit("v", FIXTURE_IDS).result(timeout=300)) > 0
        stats = fut.result(timeout=600)
        assert stats["programs"] > 0
        # both surfaces live on the added voice
        assert len(srv.submit("w", FIXTURE_IDS).result(timeout=300)) > 0
        got = _collect(srv.submit_stream("w", FIXTURE_IDS * 2, seed=3))
        np.testing.assert_allclose(got, _reference(rt2, FIXTURE_IDS * 2, 3), atol=ROW_ATOL)
        # removal: an OPEN stream on w finishes; new submits fail
        handle = srv.submit_stream("w", FIXTURE_IDS * 2, seed=4)
        srv.remove_voice("w").result(timeout=300)
        with pytest.raises(KeyError):
            srv.submit_stream("w", FIXTURE_IDS)
        with pytest.raises(KeyError):
            srv.submit("w", FIXTURE_IDS)
        drained = _collect(handle)  # graceful: the session decodes to the end
        np.testing.assert_allclose(drained, _reference(rt2, FIXTURE_IDS * 2, 4), atol=ROW_ATOL)
        # voice v unaffected throughout
        assert len(srv.submit("v", FIXTURE_IDS).result(timeout=300)) > 0
    finally:
        srv.close()


def test_stream_group_frac_scales_pops_not_grid():
    """group_scale shrinks how many requests a group POPS, but the rung
    ladder (the grid of shapes) stays derived from the full limit — a
    scaled scheduler must never pad to an unwarmed rung."""
    srv = BatchingServer(_StubRT(), max_batch=8, max_rows=128, max_wait_ms=1,
                         start_worker=False)
    key = ((None, None, None), 16)
    full = srv._group_limit(key)
    rungs_full = srv._rungs(16)
    srv.group_scale = 0.25
    assert srv._group_limit(key) == max(1, full // 4)
    assert srv._rungs(16) == rungs_full  # grid unchanged
    assert srv._group_limit_unscaled(key) == full
    srv.group_scale = 1.0
    assert srv._group_limit(key) == full


def test_stream_group_frac_scales_clamped_limit():
    """When max_rows is the BINDING constraint (short buckets at large
    max_batch), the scaled limit must land at or below the mid rung."""
    srv = BatchingServer(_StubRT(), max_batch=32, max_rows=128, max_wait_ms=1,
                         start_worker=False)
    key = ((None, None, None), 16)
    full = srv._group_limit_unscaled(key)
    assert full == 128  # the clamp engages: budget//bucket = 256 > max_rows
    rungs = srv._rungs(16)
    srv.group_scale = 0.25
    scaled = srv._group_limit(key)
    assert scaled == full // 4
    mid = sorted(rungs)[1] if len(rungs) > 1 else rungs[0]
    assert scaled <= mid, (scaled, rungs)


def test_stream_group_frac_snaps_down_to_rung_ladder():
    """A fraction strictly between rungs snaps DOWN to the largest rung <=
    the scaled limit (pops pad UP to rungs); below the smallest rung, the
    smallest rung."""
    srv = BatchingServer(_StubRT(), max_batch=32, max_rows=128, max_wait_ms=1,
                         start_worker=False)
    key = ((None, None, None), 16)
    assert srv._rungs(16) == (8, 32, 128)
    for frac, want in ((0.5, 32), (0.9, 32), (0.3, 32), (0.25, 32),
                       (0.1, 8), (0.0625, 8), (0.01, 8)):
        srv.group_scale = frac
        got = srv._group_limit(key)
        assert got == want, (frac, got)
        assert got in srv._rungs(16)


def test_add_voice_duplicate_key_preserves_stream_server(runtime):
    """Duplicates fail synchronously with the stream registry untouched
    (registering first would clobber the resident voice's StreamingServer,
    whose open sessions would never tick again)."""
    srv = UnifiedServer({"v": runtime}, max_batch=2, max_wait_ms=2,
                        stream_kwargs=dict(emit_frames=16, c0=8, row_rungs=(1, 2)))
    try:
        old_ss = srv._streams["v"]
        with pytest.raises(ValueError, match="already loaded"):
            srv.add_voice("v", runtime)
        assert srv._streams["v"] is old_ss
        # streams on the resident voice still tick and serve
        assert len(_collect(srv.submit_stream("v", FIXTURE_IDS, seed=2))) > 0
    finally:
        srv.close()


def test_add_voice_generator_error_fails_only_the_future():
    """An exception raised by the warm-step GENERATOR BODY fails only the
    add_voice future, like a failed step() does."""
    def make_steps():
        raise TypeError("bad prewarm kwargs")
        yield  # pragma: no cover — makes this a generator function

    srv = MultiVoiceBatchingServer({"a": _StubRT()}, max_batch=4, max_wait_ms=1)
    try:
        fut = srv.add_voice("b", _StubRT(), prewarm=False, extra_warm_steps=make_steps())
        with pytest.raises(TypeError, match="bad prewarm kwargs"):
            fut.result(timeout=30)
        # the SERVER survives: the resident voice still serves
        assert srv.submit("a", FIXTURE_IDS).result(timeout=30).shape == (8,)
        assert srv.ready()
    finally:
        srv.close()


def test_worker_sleeps_through_batching_window(runtime):
    """An unripe batch queue is not a wake signal: the worker makes only a
    handful of passes while the batching window runs."""
    srv = UnifiedServer({"v": runtime}, max_batch=8, max_wait_ms=400,
                        stream_kwargs=dict(emit_frames=16, c0=8, row_rungs=(1, 2)))
    try:
        calls = [0]
        orig = srv.batch.serve_step

        def counting(*a, **kw):
            calls[0] += 1
            return orig(*a, **kw)

        srv.batch.serve_step = counting
        fut = srv.submit("v", FIXTURE_IDS)
        time.sleep(0.25)  # well inside the 400 ms batching window
        n = calls[0]
        assert n < 100, f"worker made {n} passes in 250 ms — busy spin"
        assert len(fut.result(timeout=300)) > 0
    finally:
        srv.close()


def test_unified_stream_group_frac_applies_while_streaming(runtime):
    srv = UnifiedServer({"v": runtime}, max_batch=4, max_wait_ms=2, stream_group_frac=0.25,
                        stream_kwargs=dict(emit_frames=16, c0=8, row_rungs=(1, 2)))
    try:
        with pytest.raises(ValueError):
            UnifiedServer({"v": runtime}, stream_group_frac=0.0)
        handle = srv.submit_stream("v", FIXTURE_IDS * 2, seed=1)
        # While the stream is open the worker applies the reduced scale.
        deadline = time.perf_counter() + 60
        scaled = False
        while time.perf_counter() < deadline and not scaled:
            scaled = all(s.group_scale == 0.25 for s in srv.batch._servers.values())
            time.sleep(0.01)
        assert scaled, "group_scale not applied while a stream is open"
        _collect(handle)  # drain the stream
        # After it closes, full batching returns.
        deadline = time.perf_counter() + 60
        restored = False
        while time.perf_counter() < deadline and not restored:
            srv.submit("v", FIXTURE_IDS).result(timeout=60)  # keeps the worker looping
            restored = all(s.group_scale == 1.0 for s in srv.batch._servers.values())
        assert restored, "group_scale not restored after streams closed"
    finally:
        srv.close()


# -- the UnifiedServer cases of tests/test_voice_lifecycle.py -------------------------


def test_unified_remove_voice_closes_runtime(tiny_voice):
    rt_a = PiperRuntime(*tiny_voice, device="cpu")
    srv = UnifiedServer(
        {"a": rt_a}, max_batch=2, max_wait_ms=5,
        stream_kwargs=dict(emit_frames=16, c0=8, row_rungs=(1, 2), max_sessions=4))
    try:
        rt_b = PiperRuntime(*tiny_voice, device="cpu")
        srv.add_voice("b", rt_b, prewarm=False, stream_prewarm=False).result(timeout=120)
        # Serve both surfaces on b, then remove with close_runtime.
        srv.submit("b", FIXTURE_IDS).result(timeout=600)
        chunks = list(srv.submit_stream("b", FIXTURE_IDS))
        assert chunks[-1].is_final
        assert srv.metrics()["batch"]["a"]["hbm_bytes"] > 0
        base = rt_b.hbm_bytes()
        assert base > 0
        srv.remove_voice("b", close_runtime=True).result(timeout=120)
        deadline = time.monotonic() + 60
        while not rt_b.closed and time.monotonic() < deadline:
            time.sleep(0.05)
        assert rt_b.closed, "runtime not closed after streams drained"
        assert rt_b.hbm_bytes() == 0
        # The resident voice is untouched and still serves.
        assert rt_a.hbm_bytes() > 0
        audio = srv.submit("a", FIXTURE_IDS).result(timeout=600)
        assert np.isfinite(audio).all()
    finally:
        srv.close()
    assert not rt_a.closed  # caller-owned; close() is the caller's call


def test_unified_close_closes_pending_remove_runtime(tiny_voice):
    """close_runtime removals whose streams never drained are closed by
    UnifiedServer.close() (their consumers were failed)."""
    rt_a = PiperRuntime(*tiny_voice, device="cpu")
    rt_b = PiperRuntime(*tiny_voice, device="cpu")
    srv = UnifiedServer(
        {"a": rt_a, "b": rt_b}, max_batch=2, max_wait_ms=5,
        stream_kwargs=dict(emit_frames=16, c0=8, row_rungs=(1, 2), max_sessions=4))
    try:
        srv.remove_voice("b", close_runtime=True).result(timeout=120)
    finally:
        srv.close()
    assert rt_b.closed
    assert not rt_a.closed


# -- the port against the JAX package's UnifiedServer ---------------------------------


def test_unified_matches_the_reference_server(tiny_voice):
    """At zero noise one UnifiedServer of each package serves the same
    batch requests, durations and concurrent streams: audio within 1e-4,
    lengths, chunk sizes and durations equal."""
    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime
    from piper_tpu.engine.unified import UnifiedServer as JaxUnified

    reqs = [FIXTURE_IDS, FIXTURE_IDS[:6], FIXTURE_IDS * 2]
    streams = [(FIXTURE_IDS * 2, 1), (FIXTURE_IDS * 4, 2)]
    kw = dict(max_batch=4, max_wait_ms=20,
              stream_kwargs=dict(emit_frames=16, c0=8, row_rungs=(1, 2, 4), max_sessions=8))
    served = {}
    for name, cls, rt in (("port", UnifiedServer, PiperRuntime(*tiny_voice, device="cpu")),
                          ("ref", JaxUnified, JaxRuntime(*tiny_voice))):
        with cls({"v": rt}, **kw) as srv:
            handles = [srv.submit_stream("v", ids, seed=seed, **ZERO) for ids, seed in streams]
            futs = [srv.submit("v", r, **ZERO) for r in reqs]
            durs = [srv.submit_durations("v", r, noise_w=0.0) for r in reqs]
            chunks = [list(h) for h in handles]
            served[name] = ([np.asarray(f.result(timeout=600)) for f in futs],
                            [np.asarray(f.result(timeout=600)) for f in durs],
                            [[len(c.samples) for c in cs] for cs in chunks],
                            [np.concatenate([c.samples for c in cs]) for cs in chunks])
    (audio, durs, sizes, stream_audio), ref = served["port"], served["ref"]
    for a, w in zip(audio, ref[0]):
        assert a.shape == w.shape
        np.testing.assert_allclose(a, w, atol=WAVE_ATOL, rtol=0)
    for d, w in zip(durs, ref[1]):
        np.testing.assert_array_equal(d, w)
    assert sizes == ref[2] and all(len(s) > 2 for s in sizes)
    for a, w in zip(stream_audio, ref[3]):
        np.testing.assert_allclose(a, w, atol=WAVE_ATOL, rtol=0)
