"""The port's continuous batcher (piper_tpu_torch.engine.batcher), on the CPU.

Every case of tests/test_batcher.py under its own name, on the port's
runtime at device="cpu" (the stub-runtime cases as they are), and the
batcher cases of tests/test_speaker_mix.py. Then the port against the JAX
package on the same tiny voice:

- the grouping decisions (`_group_limit`, `_rungs`, `_pad_rows_for`,
  `_budget_frames`, `_dur_rows`) exactly equal on stub runtimes, for every
  phoneme bucket at several (max_batch, max_rows, group_scale);
- `dispatch_batch(fused=True, ...)` at noise_scale=0, noise_w=0, where both
  packages are deterministic: equal row lengths, the waveform within 1e-4
  max-abs (the fp32 bar), the same rows overflowing and redone the same way;
- audio served by both BatchingServers at zero noise within 1e-4, and
  `submit_durations` at noise_w=0 exactly equal (the `w_ceil` bar);
- the public signatures of both servers and the runtime's new methods, the
  metrics' keys, and `RuntimeOptions.from_env()` under one environment;
- `python -m piper_tpu_torch.tools.serving_sim --device cpu` printing the
  JAX tool's keys.

The frame budget is pinned on both sides (`_fpp`, fused_frames_per_phoneme):
`calibrate()` measures it with a seeded synthesis, and the port's seeded
noise is not JAX's. Torch runs one intra-op thread here: the servers drive
it from worker threads, and under six xdist workers each thread's OpenMP
team would oversubscribe the cores.
"""

import inspect
import threading
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine.batcher import (BatchingServer, DeadlineExceeded,
                                            MultiVoiceBatchingServer, ServerOverloaded,
                                            _Request)
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

WAVE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runtime(tiny_voice):
    return PiperRuntime(*tiny_voice, device="cpu")


def test_batched_group_serves_all(runtime):
    with BatchingServer(runtime, max_batch=8, max_wait_ms=50) as server:
        futs = [server.submit(FIXTURE_IDS) for _ in range(8)]
        audios = [f.result(timeout=300) for f in futs]
    assert len(audios) == 8
    for a in audios:
        assert len(a) > 0 and np.isfinite(a).all()
    # Seeded noise is one draw per row, so identical requests produce
    # identical audio however the server grouped them.
    for a in audios[1:]:
        np.testing.assert_array_equal(audios[0], a)


def test_mixed_lengths_batch(runtime):
    with BatchingServer(runtime, max_batch=4, max_wait_ms=50) as server:
        futs = [
            server.submit(FIXTURE_IDS),
            server.submit(FIXTURE_IDS[:6]),
            server.submit(FIXTURE_IDS * 2),
        ]
        audios = [f.result(timeout=300) for f in futs]
    lengths = [len(a) for a in audios]
    assert all(n > 0 for n in lengths)
    assert lengths[2] > lengths[1]


def _bare_server(runtime, max_batch=4):
    """A BatchingServer with no worker and no queues, for the scheduling
    math (drain mode: no batching window)."""
    srv = BatchingServer.__new__(BatchingServer)
    srv.rt = runtime
    srv.max_batch = max_batch
    srv.max_rows = 128
    srv.group_scale = 1.0
    srv.phoneme_budget = max_batch * 128
    srv.max_wait_s = 0.0
    srv.deadline_s = None
    srv.fused = False
    srv._pending = 0
    srv._metrics = {"groups": 0, "rows": 0, "padded_rows": 0,
                    "wait_ms_sum": 0.0, "wait_ms_max": 0.0}
    srv._closed = True
    srv._cond = threading.Condition()
    srv._queues = {}
    return srv


def test_length_bucketed_grouping(runtime):
    """Mixed lengths are served as same-phoneme-bucket batches; the
    scheduler picks the oldest-waiting bucket first so neither starves."""
    short, long = FIXTURE_IDS[:4], FIXTURE_IDS * 4  # buckets 16 and 64
    with BatchingServer(runtime, max_batch=4, max_wait_ms=100) as server:
        futs = [server.submit(short), server.submit(long),
                server.submit(short), server.submit(long)]
        audios = [f.result(timeout=300) for f in futs]
    assert len(audios) == 4
    assert len(audios[1]) > len(audios[0])
    srv = _bare_server(runtime)
    srv._pending = 3
    for ids in (short, long, short):
        key = ((None, None, None), 16 if len(ids) <= 16 else 64)
        srv._queues.setdefault(key, deque()).append(
            _Request(ids, (None, None, None), None, None))
    g1 = srv._take_group(block=False)
    g2 = srv._take_group(block=False)
    sizes = sorted([sorted(len(r.ids) for r in g) for g in (g1, g2)])
    assert sizes == [[4, 4], [56]]


def test_oversized_request_fails_its_future_only(runtime):
    too_long = FIXTURE_IDS * 400  # 5600 > 4096-bucket ladder max
    with BatchingServer(runtime, max_batch=4, max_wait_ms=50) as server:
        f_bad = server.submit(too_long)
        f_ok = server.submit(FIXTURE_IDS)
        with pytest.raises(Exception):
            f_bad.result(timeout=300)
        assert len(f_ok.result(timeout=300)) > 0
        assert len(server.submit(FIXTURE_IDS[:6]).result(timeout=300)) > 0


def test_depth2_pipeline_drains_on_idle(runtime):
    with BatchingServer(runtime, max_batch=8, max_wait_ms=5) as server:
        for _ in range(3):
            assert len(server.submit(FIXTURE_IDS).result(timeout=300)) > 0
        time.sleep(0.05)  # idle gap; server must not be wedged
        assert len(server.submit(FIXTURE_IDS[:6]).result(timeout=300)) > 0


def test_scale_mismatch_served_separately(runtime):
    with BatchingServer(runtime, max_batch=8, max_wait_ms=100) as server:
        f1 = server.submit(FIXTURE_IDS)
        f2 = server.submit(FIXTURE_IDS, length_scale=2.0)
        a1 = f1.result(timeout=300)
        a2 = f2.result(timeout=300)
    assert len(a2) > len(a1)


def test_bad_request_fails_fast(runtime):
    with BatchingServer(runtime) as server:
        with pytest.raises(ValueError):
            server.submit([999999])
        assert len(server.submit(FIXTURE_IDS).result(timeout=300)) > 0


def test_submit_after_close(runtime):
    server = BatchingServer(runtime)
    server.close()
    with pytest.raises(RuntimeError):
        server.submit(FIXTURE_IDS)


# -- fused group dispatch ----------------------------------------------------


@pytest.fixture(scope="module")
def fused_runtime(tiny_voice):
    return PiperRuntime(*tiny_voice, options=RuntimeOptions(mode="fused"), device="cpu")


def test_fused_batch_dispatch_fetch(fused_runtime):
    rt = fused_runtime
    batch = [FIXTURE_IDS, FIXTURE_IDS[:6], FIXTURE_IDS + FIXTURE_IDS[:2]]
    outs, meta = rt.dispatch_batch(batch, fused=True)
    assert meta.get("fused_batch")
    audios = rt.fetch_batch(outs, meta)
    assert len(audios) == 3
    for a in audios:
        assert len(a) > 0 and np.isfinite(np.asarray(a, np.float32)).all()
    assert len(audios[2]) > len(audios[1])


def test_fused_batch_matches_split_when_bucket_matches(tiny_voice):
    """With a single-rung frame ladder both paths decode at the same frame
    bucket, so their noise draws coincide and the audio matches."""
    base = PiperRuntime(*tiny_voice, device="cpu")
    base.synthesize_batch([FIXTURE_IDS, FIXTURE_IDS[:6]])
    f_bucket = base.last_run_timings.frame_bucket
    opts = RuntimeOptions(mode="fused", frame_buckets=(f_bucket,))
    rt = PiperRuntime(*tiny_voice, options=opts, device="cpu")
    split = rt.synthesize_batch([FIXTURE_IDS, FIXTURE_IDS[:6]])
    outs, meta = rt.dispatch_batch([FIXTURE_IDS, FIXTURE_IDS[:6]], fused=True)
    fused = rt.fetch_batch(outs, meta)
    assert len(fused) == len(split) == 2
    for a, b in zip(fused, split):
        assert a.shape == b.shape
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   atol=2e-5, rtol=0)


def test_fused_batch_overflow_rows_redone(tiny_voice):
    """Every row overflows a 1-frame-per-phoneme budget at length_scale 5:
    the redo is a split synthesize_batch of the whole batch, bit-equal."""
    opts = RuntimeOptions(mode="fused", fused_frames_per_phoneme=1)
    rt = PiperRuntime(*tiny_voice, options=opts, device="cpu")
    batch = [FIXTURE_IDS, FIXTURE_IDS[:6]]
    outs, meta = rt.dispatch_batch(batch, fused=True, length_scale=5.0)
    audios = rt.fetch_batch(outs, meta)
    expected = rt.synthesize_batch(batch, length_scale=5.0)
    for a, b in zip(audios, expected):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_batcher_uses_fused_dispatch(fused_runtime):
    with BatchingServer(fused_runtime, max_batch=8, max_wait_ms=50) as server:
        assert server.fused
        futs = [server.submit(FIXTURE_IDS) for _ in range(6)]
        audios = [f.result(timeout=300) for f in futs]
    assert all(len(a) > 0 for a in audios)
    m = server.metrics()
    assert m["completed"] == 6 and m["failed"] == 0


def test_fused_grid_rungs(fused_runtime):
    srv = BatchingServer(fused_runtime, max_batch=8, max_wait_ms=1)
    try:
        assert srv._rungs(16) == (8, 16, 64)
        assert srv._rungs(128) == (2, 8)
        assert srv._pad_rows_for(16, 3) == 8
        assert srv._pad_rows_for(16, 9) == 16
        assert srv._pad_rows_for(16, 200) == 64
    finally:
        srv.close()


def test_prewarm_covers_grid(tiny_voice):
    """After prewarm(), a mixed burst runs only prewarmed keys: no shape is
    seen for the first time in traffic."""
    rt = PiperRuntime(*tiny_voice, options=RuntimeOptions(mode="fused"), device="cpu")
    with BatchingServer(rt, max_batch=8, max_wait_ms=20) as server:
        stats = server.prewarm(p_buckets=[16, 32])
        assert stats["programs"] >= 2
        n_programs = len(rt._compiled_keys)
        futs = [server.submit(FIXTURE_IDS) for _ in range(12)]
        futs += [server.submit(FIXTURE_IDS * 2) for _ in range(3)]
        for f in futs:
            assert len(f.result(timeout=300)) > 0
        assert len(rt._compiled_keys) == n_programs, (
            "traffic ran new keys beyond the prewarmed grid")


def test_pad_rows_to_and_budget_frames(fused_runtime):
    rt = fused_runtime
    outs, meta = rt.dispatch_batch([FIXTURE_IDS, FIXTURE_IDS[:6]],
                                   fused=True, pad_rows_to=8, budget_frames=48)
    assert outs[0].shape[0] == 8  # padded rows
    assert meta["f_bucket"] == 64
    audios = rt.fetch_batch(outs, meta)
    assert len(audios) == 2 and all(len(a) > 0 for a in audios)
    with pytest.raises(ValueError):
        rt.dispatch_batch([FIXTURE_IDS] * 4, fused=True, pad_rows_to=2)


def test_overflow_redo_stays_on_fused_grid(tiny_voice):
    """Rows overflowing the pinned budget are redone on the taller fused
    grid shape, not the split path."""
    rt = PiperRuntime(*tiny_voice, options=RuntimeOptions(mode="fused"), device="cpu")
    outs, meta = rt.dispatch_batch(
        [FIXTURE_IDS * 2], fused=True, pad_rows_to=4, budget_frames=32,
        overflow_budget_frames=256, overflow_pad_rows=4)
    audios = rt.fetch_batch(outs, meta)
    assert len(audios) == 1 and len(audios[0]) > 32 * rt.hparams.hop_length
    kinds = {k for (k, _) in rt._compiled_keys}
    assert kinds == {"fused"}, kinds


def test_calibration_measures_fpp(fused_runtime):
    srv = BatchingServer(fused_runtime, max_batch=8, max_wait_ms=1)
    try:
        fpp = srv.calibrate()
        assert 0.5 <= fpp < 20.0
        assert srv._budget_frames(16) >= 32
    finally:
        srv.close()


# -- admission control ------------------------------------------------------


class _StubRuntime:
    """Deterministic runtime stand-in: dispatch blocks until released, so
    tests control exactly how much queue builds up."""

    def __init__(self):
        self.hparams = SimpleNamespace(n_vocab=1000, hop_length=4)
        self.options = SimpleNamespace(
            phoneme_buckets=(16, 32, 64), batch_buckets=(1, 2, 4, 8),
            mode="split",
        )
        self.release = threading.Event()
        self.dispatched = []

    def dispatch_batch(self, ids_batch, **kw):
        self.release.wait(timeout=60)
        self.dispatched.append(len(ids_batch))
        return None, {"b": len(ids_batch)}

    def fetch_batch(self, outs, meta):
        return [np.zeros(8, np.float32)] * meta["b"]


def test_overload_sheds_at_the_door():
    rt = _StubRuntime()
    server = BatchingServer(rt, max_batch=4, max_wait_ms=1, max_pending=2)
    try:
        futs = [server.submit(FIXTURE_IDS) for _ in range(2)]
        with pytest.raises(ServerOverloaded):
            for _ in range(8):
                futs.append(server.submit(FIXTURE_IDS))
        assert server.metrics()["shed_overload"] >= 1
    finally:
        rt.release.set()
        server.close()
    assert all(len(f.result(timeout=60)) == 8 for f in futs)


def test_deadline_sheds_stale_requests():
    rt = _StubRuntime()
    server = BatchingServer(rt, max_batch=4, max_wait_ms=1, deadline_ms=30)
    try:
        f0 = server.submit(FIXTURE_IDS)
        time.sleep(0.1)
        stale = [server.submit(FIXTURE_IDS) for _ in range(3)]
        time.sleep(0.1)
        rt.release.set()
        fresh = server.submit(FIXTURE_IDS)
        assert len(fresh.result(timeout=60)) == 8
        assert len(f0.result(timeout=60)) == 8
        n_shed = 0
        for f in stale:
            try:
                f.result(timeout=60)
            except DeadlineExceeded:
                n_shed += 1
        assert n_shed >= 1
        assert server.metrics()["shed_deadline"] == n_shed
    finally:
        rt.release.set()
        server.close()


def test_metrics_snapshot(runtime):
    with BatchingServer(runtime, max_batch=8, max_wait_ms=20) as server:
        futs = [server.submit(FIXTURE_IDS) for _ in range(5)]
        [f.result(timeout=300) for f in futs]
        m = server.metrics()
    assert m["submitted"] == 5
    assert m["completed"] == 5
    assert m["rows"] == 5
    assert m["groups"] >= 1
    assert m["wait_ms_max"] >= m["wait_ms_mean"] >= 0.0
    assert m["queue_depth"] == 0
    assert m["hbm_bytes"] == runtime.hbm_bytes() > 0


# -- multi-voice batching -----------------------------------------------------


class _TaggedStub(_StubRuntime):
    """Stub whose fetched audio is filled with a per-voice tag value, and
    which logs (tag, rows) into a shared cross-voice dispatch log."""

    def __init__(self, tag: float, log):
        super().__init__()
        self.tag = tag
        self.log = log
        self.release.set()

    def dispatch_batch(self, ids_batch, **kw):
        self.release.wait(timeout=60)
        self.log.append((self.tag, len(ids_batch)))
        return None, {"b": len(ids_batch)}

    def fetch_batch(self, outs, meta):
        return [np.full(8, self.tag, np.float32)] * meta["b"]


def test_multivoice_single_worker_no_cross_talk():
    log: list = []
    rts = {"a": _TaggedStub(1.0, log), "b": _TaggedStub(2.0, log)}
    with MultiVoiceBatchingServer(rts, max_batch=4, max_wait_ms=5) as srv:
        assert sorted(srv.voices) == ["a", "b"]
        futs = [(v, srv.submit(v, FIXTURE_IDS))
                for v in ("a", "b", "a", "b", "b", "a")]
        for v, f in futs:
            audio = f.result(timeout=60)
            assert audio.shape == (8,)
            assert float(audio[0]) == (1.0 if v == "a" else 2.0)
    m = srv.metrics()
    assert m["a"]["rows"] == 3 and m["b"]["rows"] == 3
    assert sum(b for _, b in log) == 6


def test_multivoice_oldest_request_served_first():
    log: list = []
    rts = {"a": _TaggedStub(1.0, log), "b": _TaggedStub(2.0, log)}
    rts["a"].release.clear()
    with MultiVoiceBatchingServer(rts, max_batch=4, max_wait_ms=1) as srv:
        f_a = srv.submit("a", FIXTURE_IDS)
        time.sleep(0.05)
        f_b1 = srv.submit("b", FIXTURE_IDS)
        time.sleep(0.02)
        f_a2 = srv.submit("a", FIXTURE_IDS)
        rts["a"].release.set()
        assert float(f_b1.result(timeout=60)[0]) == 2.0
        assert float(f_a.result(timeout=60)[0]) == 1.0
        assert float(f_a2.result(timeout=60)[0]) == 1.0
    assert [t for t, _ in log[:2]] == [1.0, 2.0]


def test_multivoice_per_voice_admission():
    log: list = []
    rts = {"a": _TaggedStub(1.0, log), "b": _TaggedStub(2.0, log)}
    rts["a"].release.clear()
    rts["b"].release.clear()
    srv = MultiVoiceBatchingServer(rts, max_batch=4, max_wait_ms=1, max_pending=2)
    futs = []
    try:
        futs.append(srv.submit("a", FIXTURE_IDS))
        time.sleep(0.05)
        futs += [srv.submit("a", FIXTURE_IDS) for _ in range(2)]
        with pytest.raises(ServerOverloaded):
            for _ in range(8):
                futs.append(srv.submit("a", FIXTURE_IDS))
        futs.append(srv.submit("b", FIXTURE_IDS))
    finally:
        rts["a"].release.set()
        rts["b"].release.set()
        srv.close()
    assert all(len(f.result(timeout=60)) == 8 for f in futs)
    assert srv.metrics()["a"]["shed_overload"] >= 1
    assert srv.metrics()["b"]["shed_overload"] == 0


def test_multivoice_unknown_voice():
    with MultiVoiceBatchingServer({"a": _TaggedStub(1.0, [])}) as srv:
        with pytest.raises(KeyError):
            srv.submit("nope", FIXTURE_IDS)


def test_multivoice_concurrent_submitters_stress():
    log: list = []
    rts = {f"v{i}": _TaggedStub(float(i + 1), log) for i in range(3)}
    results: list = []
    lock = threading.Lock()
    with MultiVoiceBatchingServer(rts, max_batch=8, max_wait_ms=2) as srv:
        def client(seed):
            rng = np.random.default_rng(seed)
            for _ in range(100):
                v = int(rng.integers(3))
                fut = srv.submit(f"v{v}", FIXTURE_IDS[: int(rng.integers(4, 14))])
                audio = fut.result(timeout=60)
                with lock:
                    results.append((v, float(audio[0])))
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        m = srv.metrics()
    assert len(results) == 800
    assert all(tag == v + 1 for v, tag in results)
    assert sum(m[f"v{i}"]["rows"] for i in range(3)) == 800
    assert sum(m[f"v{i}"]["completed"] for i in range(3)) == 800


def test_multivoice_add_voice_live():
    log: list = []
    rts = {"a": _TaggedStub(1.0, log)}
    with MultiVoiceBatchingServer(rts, max_batch=4, max_wait_ms=2) as srv:
        assert srv.voices == ["a"]
        f1 = srv.submit("a", FIXTURE_IDS)
        with pytest.raises(KeyError):
            srv.submit("b", FIXTURE_IDS)
        stats = srv.add_voice("b", _TaggedStub(2.0, log), prewarm=False).result(timeout=60)
        assert stats == {}
        f2 = srv.submit("b", FIXTURE_IDS)
        assert float(f1.result(timeout=60)[0]) == 1.0
        assert float(f2.result(timeout=60)[0]) == 2.0
        assert sorted(srv.voices) == ["a", "b"]
        with pytest.raises(ValueError):
            srv.add_voice("b", _TaggedStub(3.0, log), prewarm=False).result(timeout=60)


def test_multivoice_remove_voice_fails_queued():
    log: list = []
    rts = {"a": _TaggedStub(1.0, log), "b": _TaggedStub(2.0, log)}
    rts["b"].release.clear()
    srv = MultiVoiceBatchingServer(rts, max_batch=4, max_wait_ms=2)
    try:
        fb0 = srv.submit("b", FIXTURE_IDS)
        time.sleep(0.05)
        queued = [srv.submit("b", FIXTURE_IDS) for _ in range(3)]
        rts["b"].release.set()
        n_failed = srv.remove_voice("b").result(timeout=60)
        assert len(fb0.result(timeout=60)) == 8
        failed = 0
        for f in queued:
            try:
                f.result(timeout=60)
            except ServerOverloaded:
                failed += 1
        assert failed == n_failed
        with pytest.raises(KeyError):
            srv.submit("b", FIXTURE_IDS)
        assert float(srv.submit("a", FIXTURE_IDS).result(timeout=60)[0]) == 1.0
    finally:
        srv.close()


def test_worker_crash_fails_open_not_hang():
    log: list = []
    rts = {"a": _TaggedStub(1.0, log)}
    rts["a"].release.clear()
    srv = MultiVoiceBatchingServer(rts, max_batch=4, max_wait_ms=2)
    f0 = srv.submit("a", FIXTURE_IDS)
    time.sleep(0.05)
    queued = [srv.submit("a", FIXTURE_IDS) for _ in range(2)]

    def boom(*a, **k):
        raise AssertionError("injected scheduler bug")

    srv._take_group = boom
    rts["a"].release.set()
    results = []
    for f in [f0] + queued:
        try:
            results.append(f.result(timeout=30))
        except Exception as e:  # noqa: BLE001
            results.append(e)
    assert all(isinstance(r, (np.ndarray, Exception)) for r in results)
    assert any(isinstance(r, RuntimeError) and "worker died" in str(r) for r in results)
    with pytest.raises(RuntimeError):
        srv.submit("a", FIXTURE_IDS)


def test_speaker_id_validated_at_submit(runtime):
    """Out-of-range speaker ids are refused at the door (on the card an
    out-of-range index would be a device-side assert)."""
    with BatchingServer(runtime, max_batch=4, max_wait_ms=5) as server:
        with pytest.raises(ValueError):
            server.submit(FIXTURE_IDS, speaker_id=999)
        with pytest.raises(ValueError):
            server.submit(FIXTURE_IDS, speaker_id=-1)


def test_mesh_rungs_snap_up_not_down():
    """A group limit above the dp ladder's top snaps UP to a dp-multiple
    (the port has no mesh yet; the stub runtime carries one)."""
    rt = _StubRuntime()
    rt.mesh = object()
    rt.batch_ladder = (8, 16, 32, 64, 128)
    srv = BatchingServer(rt, max_batch=32, max_rows=256, max_wait_ms=1, start_worker=False)
    rungs = srv._rungs(16)
    assert rungs[-1] >= srv._group_limit(((), 16))
    assert all(r % 8 == 0 for r in rungs)
    assert srv._pad_rows_for(16, 200) >= 200


def test_submit_durations_matches_served_audio(runtime):
    hop = runtime.hparams.hop_length
    with BatchingServer(runtime, max_batch=8, max_wait_ms=50) as server:
        d_futs = [server.submit_durations(FIXTURE_IDS),
                  server.submit_durations(FIXTURE_IDS[:6])]
        a_futs = [server.submit(FIXTURE_IDS), server.submit(FIXTURE_IDS[:6])]
        durs = [f.result(timeout=300) for f in d_futs]
        audios = [f.result(timeout=300) for f in a_futs]
    assert durs[0].shape == (len(FIXTURE_IDS),)
    assert durs[1].shape == (6,)
    assert int(durs[0].sum()) * hop == len(audios[0])
    assert int(durs[1].sum()) * hop == len(audios[1])
    m = server.metrics()
    assert m["completed"] == 4 and m["failed"] == 0


def test_submit_durations_validates(runtime):
    with BatchingServer(runtime, max_batch=4, max_wait_ms=10) as server:
        with pytest.raises(ValueError):
            server.submit_durations([])
        with pytest.raises(ValueError):
            server.submit_durations([10 ** 9])
        with pytest.raises(ValueError):
            server.submit_durations(FIXTURE_IDS, speaker_id=5)


def test_multivoice_submit_durations(tiny_voice):
    rts = {"a": PiperRuntime(*tiny_voice, device="cpu")}
    with MultiVoiceBatchingServer(rts, max_batch=4, max_wait_ms=10) as srv:
        d = srv.submit_durations("a", FIXTURE_IDS).result(timeout=300)
        a = srv.submit("a", FIXTURE_IDS).result(timeout=300)
    assert int(d.sum()) * rts["a"].hparams.hop_length == len(a)


def test_durations_groups_use_one_pinned_program(tiny_voice):
    """Every durations group of a phoneme bucket pads to ONE pinned row
    rung, run once by prewarm."""
    rt = PiperRuntime(*tiny_voice, device="cpu")
    with BatchingServer(rt, max_batch=8, max_wait_ms=20) as server:
        server.prewarm(p_buckets=[16], calibrate=False)
        programs = set(rt._compiled_keys)
        server.submit_durations(FIXTURE_IDS).result(timeout=300)
        futs = [server.submit_durations(FIXTURE_IDS[:k]) for k in (6, 8, 10)]
        durs = [f.result(timeout=300) for f in futs]
        assert [len(d) for d in durs] == [6, 8, 10]
        new = {k for k in rt._compiled_keys - programs if k[0] == "enc_key"}
        assert new == set(), f"durations ran new keys mid-traffic: {new}"
    direct = rt.phoneme_durations([FIXTURE_IDS[:6]])[0]
    np.testing.assert_array_equal(durs[0], direct)


# -- speaker mixes through the batcher (tests/test_speaker_mix.py) ------------


@pytest.fixture(scope="module")
def ms_runtime(tmp_path_factory):
    d = tmp_path_factory.mktemp("mix_voice")
    voice = make_synthetic_voice(d, quality="test", seed=6, n_speakers=4, gin_channels=32)
    return PiperRuntime(*voice, device="cpu")


def test_submitted_mix_dict_is_copied(ms_runtime):
    with BatchingServer(ms_runtime, max_batch=4, max_wait_ms=200) as server:
        mix = {2: 1.0}
        fut = server.submit(FIXTURE_IDS, speaker_mix=mix)
        mix.clear()  # the caller reuses the dict before the worker dispatches
        a = fut.result(timeout=300)
    np.testing.assert_array_equal(a, ms_runtime.synthesize(FIXTURE_IDS, speaker_mix={2: 1.0}))


def test_server_mix_matches_id(ms_runtime):
    with BatchingServer(ms_runtime, max_batch=4, max_wait_ms=20) as server:
        f_mix = server.submit(FIXTURE_IDS, speaker_mix={2: 1.0})
        f_id = server.submit(FIXTURE_IDS, speaker_id=2)
        a_mix = f_mix.result(timeout=300)
        a_id = f_id.result(timeout=300)
    np.testing.assert_array_equal(a_mix, a_id)


def test_server_mixed_traffic_and_metrics(ms_runtime):
    with BatchingServer(ms_runtime, max_batch=8, max_wait_ms=50) as server:
        futs = ([server.submit(FIXTURE_IDS, speaker_id=1) for _ in range(3)]
                + [server.submit(FIXTURE_IDS, speaker_mix={0: 0.5, 1: 0.5})
                   for _ in range(3)])
        audios = [f.result(timeout=300) for f in futs]
        m = server.metrics()
    assert all(np.isfinite(a).all() and len(a) > 0 for a in audios)
    assert m["groups"] >= 2 and m["completed"] == 6


def test_server_durations_and_forced_with_mix(ms_runtime):
    with BatchingServer(ms_runtime, max_batch=4, max_wait_ms=20) as server:
        durs = server.submit_durations(FIXTURE_IDS, speaker_mix={1: 1.0}).result(timeout=300)
        durs_id = server.submit_durations(FIXTURE_IDS, speaker_id=1).result(timeout=300)
        np.testing.assert_array_equal(durs, durs_id)
        a_mix = server.submit_forced(FIXTURE_IDS, list(durs),
                                     speaker_mix={1: 1.0}).result(timeout=300)
        a_id = server.submit_forced(FIXTURE_IDS, list(durs_id),
                                    speaker_id=1).result(timeout=300)
    np.testing.assert_array_equal(a_mix, a_id)


def test_server_submit_validation(ms_runtime):
    with BatchingServer(ms_runtime, max_batch=4, max_wait_ms=20) as server:
        with pytest.raises(ValueError):
            server.submit(FIXTURE_IDS, speaker_id=1, speaker_mix={0: 1.0})
        with pytest.raises(ValueError):
            server.submit(FIXTURE_IDS, speaker_mix={9: 1.0})
        with pytest.raises(ValueError):
            server.submit(FIXTURE_IDS, speaker_mix={})
        with pytest.raises(ValueError):
            server.submit(FIXTURE_IDS, speaker_mix={0: float("inf")})


def test_prewarm_mix_programs(ms_runtime):
    with BatchingServer(ms_runtime, max_batch=2, max_wait_ms=5) as server:
        base = server.prewarm(p_buckets=[64])
        server._fpp = None
        mixed = server.prewarm(p_buckets=[64], speaker_mix_programs=True)
    assert mixed["programs"] > base["programs"]


# -- against the JAX package --------------------------------------------------


def _jax_server(runtime, **kw):
    from piper_tpu.engine.batcher import BatchingServer as JaxServer

    return JaxServer(runtime, start_worker=False, **kw)


@pytest.mark.parametrize("max_batch,max_rows", [(16, 128), (32, 128), (8, 24), (4, 512)])
@pytest.mark.parametrize("group_scale", [1.0, 0.5, 0.25, 0.1])
def test_grouping_equals_the_reference(max_batch, max_rows, group_scale):
    """The grouping decisions, exactly, for every phoneme bucket and kind,
    with the heuristic budget and a calibrated one, on stub runtimes."""
    rt = _StubRuntime()
    rt.options.phoneme_buckets = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
    rt.options.fused_frames_per_phoneme = 6
    port = BatchingServer(rt, max_batch=max_batch, max_rows=max_rows, start_worker=False)
    ref = _jax_server(rt, max_batch=max_batch, max_rows=max_rows)
    for fpp in (None, 1.43):
        for srv in (port, ref):
            srv.group_scale = group_scale
            srv._fpp = fpp
        for bucket in rt.options.phoneme_buckets:
            for kind in ("synth", "dur", "forced"):
                key = ((None, None, None), bucket, kind, False)
                assert port._group_limit(key) == ref._group_limit(key), (bucket, kind)
            assert port._rungs(bucket) == ref._rungs(bucket), bucket
            assert port._budget_frames(bucket) == ref._budget_frames(bucket), bucket
            assert port._dur_rows(bucket) == ref._dur_rows(bucket), bucket
            for n in (1, 3, 8, 9, 33, 200):
                assert port._pad_rows_for(bucket, n) == ref._pad_rows_for(bucket, n)
        assert port._group_limit(((), "overflow")) == ref._group_limit(((), "overflow")) == 1


def test_metrics_keys_equal_the_reference():
    """The JAX server's keys, and the port's overflow-redo counters."""
    rt = _StubRuntime()
    port = BatchingServer(rt, start_worker=False)
    ref = _jax_server(rt)
    assert sorted(port.metrics()) == sorted(
        [*ref.metrics(), "overflow_rows", "overflow_split_rows"])


def _params(fn):
    return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]


def _public(cls):
    return sorted(n for n, v in vars(cls).items()
                  if (not n.startswith("_") or n == "__init__") and callable(v))


def test_server_signatures_equal_the_reference():
    from piper_tpu.engine import batcher as jb

    for port_cls, ref_cls in ((BatchingServer, jb.BatchingServer),
                              (MultiVoiceBatchingServer, jb.MultiVoiceBatchingServer)):
        assert _public(port_cls) == _public(ref_cls), port_cls.__name__
        for name in _public(ref_cls):
            assert _params(getattr(port_cls, name)) == _params(getattr(ref_cls, name)), name
    for name in ("_deliver", "ServerOverloaded", "DeadlineExceeded"):
        assert hasattr(jb, name)
    import piper_tpu_torch.engine.batcher as tb

    assert issubclass(tb.ServerOverloaded, RuntimeError)
    assert issubclass(tb.DeadlineExceeded, RuntimeError)
    assert [f for f in tb._Request.__dataclass_fields__] == [
        f for f in jb._Request.__dataclass_fields__]


def test_runtime_serving_signatures_equal_the_reference():
    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime
    from piper_tpu.engine.runtime import RuntimeOptions as JaxOptions

    for name in ("prewarm", "close", "hbm_bytes", "dispatch_batch", "fetch_batch"):
        assert _params(getattr(PiperRuntime, name)) == _params(getattr(JaxRuntime, name)), name
    assert isinstance(PiperRuntime.closed, property) and isinstance(JaxRuntime.closed, property)
    assert PiperRuntime.params.fset is not None
    assert _params(RuntimeOptions.from_env) == _params(JaxOptions.from_env)


@pytest.mark.parametrize("env", [
    {},
    {"PIPER_TPU_PRECISION": "high", "PIPER_TPU_MODE": "fused"},
    {"PIPER_TPU_VOCODER_PRECISION": "high, none ,default", "PIPER_TPU_FLOW_PRECISION": "high"},
    {"PIPER_TPU_VOCODER_PRECISION": "none", "PIPER_TPU_FLOW_PRECISION": "",
     "PIPER_TPU_MODE": "split"},
])
def test_options_from_env_equal_the_reference(monkeypatch, env):
    from piper_tpu.engine.runtime import RuntimeOptions as JaxOptions

    for k in ("PIPER_TPU_PRECISION", "PIPER_TPU_MODE", "PIPER_TPU_VOCODER_PRECISION",
              "PIPER_TPU_FLOW_PRECISION"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = RuntimeOptions.from_env(), JaxOptions.from_env()
    for name in RuntimeOptions.__dataclass_fields__:
        assert getattr(got, name) == getattr(want, name), name


def test_options_from_env_refuses_bfloat16(monkeypatch):
    """The bf16 capacity tier is read from the environment as the JAX
    package reads it; from_env validates, so a vocoder tier it cannot
    carry (bf16 activations run "default" only) is refused there."""
    from piper_tpu.engine.runtime import RuntimeOptions as JaxOptions

    monkeypatch.setenv("PIPER_TPU_PRECISION", "bfloat16")
    assert RuntimeOptions.from_env().precision == JaxOptions.from_env().precision == "bfloat16"
    monkeypatch.setenv("PIPER_TPU_VOCODER_PRECISION", "high")
    with pytest.raises(ValueError, match="under precision 'bfloat16'"):
        RuntimeOptions.from_env()


ROWS = [FIXTURE_IDS, FIXTURE_IDS[:6], FIXTURE_IDS * 2]  # 72, 29 and 158 frames at zero noise
ZERO = dict(noise_scale=0.0, noise_w=0.0)


@pytest.fixture(scope="module")
def pair(tiny_voice):
    """(port, JAX) fused-mode runtimes of the tiny voice, the budget
    heuristic pinned alike."""
    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime
    from piper_tpu.engine.runtime import RuntimeOptions as JaxOptions

    return (PiperRuntime(*tiny_voice, RuntimeOptions(mode="fused", fused_frames_per_phoneme=8),
                         device="cpu"),
            JaxRuntime(*tiny_voice, options=JaxOptions(mode="fused",
                                                       fused_frames_per_phoneme=8)))


def _redone(rt):
    """Record the overflow redos of a runtime: ('fused', rows) per taller
    fused dispatch and ('split', rows) per blocking synthesize_batch."""
    calls = []
    fused, split = rt._dispatch_batch_fused, rt.synthesize_batch

    def on_fused(ids_batch, **kw):
        calls.append(("fused", [len(r) for r in ids_batch], kw.get("budget_frames")))
        return fused(ids_batch, **kw)

    def on_split(ids_batch, *a, **kw):
        calls.append(("split", [len(r) for r in ids_batch]))
        return split(ids_batch, *a, **kw)

    rt._dispatch_batch_fused = on_fused
    rt.synthesize_batch = on_split
    return calls


@pytest.mark.parametrize("case,grid", [
    ("fits", dict(budget_frames=192)),
    ("overflow_to_grid", dict(budget_frames=96, overflow_budget_frames=192,
                              overflow_pad_rows=2)),
    ("overflow_to_split", dict(budget_frames=96)),
])
def test_fused_group_dispatch_matches_the_reference(pair, case, grid):
    """dispatch_batch(fused=True, pad_rows_to=4, ...) at zero noise scales
    against the JAX runtime's same call: equal row lengths, the waveform
    within 1e-4, and the same rows overflow and are redone the same way."""
    port, ref = pair
    got_calls, want_calls = _redone(port), _redone(ref)
    try:
        outs, meta = port.dispatch_batch(ROWS, fused=True, pad_rows_to=4, **grid, **ZERO)
        assert outs[0].shape[0] == 4
        got = port.fetch_batch(outs, meta)
        outs, meta_ref = ref.dispatch_batch(ROWS, fused=True, pad_rows_to=4, **grid, **ZERO)
        want = ref.fetch_batch(outs, meta_ref)
    finally:
        for rt in (port, ref):
            del rt._dispatch_batch_fused, rt.synthesize_batch
    assert meta["f_bucket"] == meta_ref["f_bucket"]
    # The redo's own dispatch is recorded too: drop the first (outer) call.
    assert got_calls[1:] == want_calls[1:]
    assert len(got_calls[1:]) == (case != "fits")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), atol=WAVE_ATOL, rtol=0)


def test_served_audio_matches_the_reference(pair):
    """The same requests through both BatchingServers (fused, the budget
    pinned): at zero noise scales the served audio agrees within 1e-4,
    and submit_durations at noise_w=0 exactly."""
    from piper_tpu.engine.batcher import BatchingServer as JaxServer

    reqs = [FIXTURE_IDS, FIXTURE_IDS[:6], FIXTURE_IDS[:10], FIXTURE_IDS * 2]
    served = {}
    for name, cls, rt in (("port", BatchingServer, pair[0]), ("ref", JaxServer, pair[1])):
        with cls(rt, max_batch=4, max_wait_ms=50) as server:
            server._fpp = 3.0  # budgets 64 and 128 frames: the longest row of each bucket overflows
            futs = [server.submit(r, **ZERO) for r in reqs]
            durs = [server.submit_durations(r, noise_w=0.0) for r in reqs]
            served[name] = ([np.asarray(f.result(timeout=600)) for f in futs],
                            [f.result(timeout=600) for f in durs])
    (audio, durs), (audio_ref, durs_ref) = served["port"], served["ref"]
    for a, w in zip(audio, audio_ref):
        assert a.shape == w.shape
        np.testing.assert_allclose(a, w, atol=WAVE_ATOL, rtol=0)
    for d, w in zip(durs, durs_ref):
        np.testing.assert_array_equal(d, w)


def test_serving_sim_prints_the_reference_keys(capsys, tmp_path, monkeypatch):
    """The port's serving_sim on the CPU prints one JSON line with every
    key of the JAX tool's line (its `report`, fed the same kind of
    results), and the port's own: device, prewarm, hbm_bytes."""
    import importlib.util
    import json
    from pathlib import Path

    from piper_tpu_torch.tools import serving_sim

    monkeypatch.setenv("PIPER_TPU_CACHE", str(tmp_path))
    serving_sim.main(["--device", "cpu", "--quality", "test", "--rate", "20",
                      "--duration", "2", "--max-batch", "2"])
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 1
    got = json.loads(lines[0])

    path = Path(__file__).resolve().parent.parent / "tools" / "serving_sim.py"
    spec = importlib.util.spec_from_file_location("jax_serving_sim", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert ref.LENGTH_MIX == serving_sim.LENGTH_MIX
    args = SimpleNamespace(platform=None, duration=2.0, max_batch=2, max_wait_ms=10.0,
                           cache_mb=0.0, voices=1)
    metrics = {"rows_per_group": 1.0, "groups": 1, "padded_rows": 0, "wait_ms_mean": 0.0,
               "wait_ms_max": 0.0, "shed_overload": 0, "shed_deadline": 0}
    ref.report(args, 20.0, [(0.1, 1, 0.0)], 1.0, 2.0, {"overload": 0, "deadline": 0},
               metrics, [1, 2, 4, 8, 16])
    want = json.loads(capsys.readouterr().out)
    assert set(want) <= set(got) and set(want["server"]) <= set(got["server"])
    assert set(got) - set(want) == {"device", "prewarm", "hbm_bytes"}
    assert got["shed"] == {"overload": 0, "deadline": 0}
    assert got["requests"] > 0 and got["rtf_aggregate"] > 0
    assert got["hbm_bytes"]["v0"] > 0 and got["prewarm"]["programs"] > 0


@pytest.mark.parametrize("flags,match", [
    (["--http", "--unified"], "does not combine with --unified"),
])
def test_serving_sim_unported_flags_raise(flags, match):
    """No flag of the JAX tool is left unported: the port's parser takes
    every one of them (--platform is --device here), and only the pair the
    JAX tool would silently resolve (--http wins over --unified) exits."""
    import re
    from pathlib import Path

    from piper_tpu_torch.tools import serving_sim

    source = (Path(__file__).resolve().parent.parent / "tools" / "serving_sim.py").read_text()
    jax_flags = set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', source))
    assert jax_flags - set(serving_sim._parser()._option_string_actions) == {"--platform"}
    assert not hasattr(serving_sim, "UNPORTED")
    with pytest.raises(SystemExit, match=match):
        serving_sim.main(["--device", "cpu", *flags])


def test_serving_sim_http_prints_the_reference_keys(capsys, tmp_path, monkeypatch):
    """`--http` on the CPU, a short low-rate pass: the serving mix goes over
    loopback HTTP into the port's PiperHTTPServer, one JSON line with the
    in-process run's keys and "http": true, nothing shed."""
    import json

    from piper_tpu_torch.tools import serving_sim

    monkeypatch.setenv("PIPER_TPU_CACHE", str(tmp_path))
    serving_sim.main(["--device", "cpu", "--quality", "test", "--rate", "10",
                      "--duration", "2", "--max-batch", "2", "--http"])
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got["http"] is True
    assert got["shed"] == {"overload": 0, "deadline": 0}
    assert got["server"]["shed_overload"] == got["server"]["shed_deadline"] == 0
    assert got["requests"] > 0 and got["rtf_aggregate"] > 0
    for key in ("latency_ms", "audio_s_total", "offered_rtf", "wall_s", "server", "device",
                "prewarm", "hbm_bytes", "length_mix_factors", "rate_req_s"):
        assert key in got, key
    assert got["server"]["per_voice_rows"]["v0"] == got["requests"]
    assert got["door"]["transport_errors"] == 0


def test_serving_sim_unified_streams_print_the_reference_keys(capsys, tmp_path, monkeypatch):
    """`--unified --stream-rate 2` on the CPU, a short pass: the batch mix
    and Poisson streams on one UnifiedServer; the JSON line holds every key
    of the JAX tool's unified line with streams (its `report`), and the
    streams' TTFB."""
    import importlib.util
    import json
    from pathlib import Path

    from piper_tpu_torch.tools import serving_sim

    monkeypatch.setenv("PIPER_TPU_CACHE", str(tmp_path))
    serving_sim.main(["--device", "cpu", "--quality", "test", "--rate", "10",
                      "--duration", "2", "--max-batch", "2", "--unified", "--stream-rate", "2",
                      "--stream-factor", "2", "--stream-group-frac", "0.25"])
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 1
    got = json.loads(lines[0])

    path = Path(__file__).resolve().parent.parent / "tools" / "serving_sim.py"
    spec = importlib.util.spec_from_file_location("jax_serving_sim", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    args = SimpleNamespace(platform=None, duration=2.0, max_batch=2, max_wait_ms=10.0,
                           cache_mb=0.0, voices=1, unified=True)
    metrics = {"rows_per_group": 1.0, "groups": 1, "padded_rows": 0, "wait_ms_mean": 0.0,
               "wait_ms_max": 0.0, "shed_overload": 0, "shed_deadline": 0}
    ref.report(args, 10.0, [(0.1, 1, 0.0)], 1.0, 2.0, {"overload": 0, "deadline": 0},
               metrics, [1, 2, 4, 8, 16],
               stream_stats=[{"ttfb_ms": 5.0, "audio_s": 1.0, "wall_s": 0.5}])
    want = json.loads(capsys.readouterr().out)
    assert set(want) <= set(got) and set(want["streams"]) <= set(got["streams"])
    assert got["unified"] is True and got["shed"] == {"overload": 0, "deadline": 0}
    streams = got["streams"]
    assert streams["count"] >= 1 and streams["shed"] == 0 and streams["audio_s_total"] > 0
    assert 0 < streams["ttfb_ms"]["p50"] <= streams["ttfb_ms"]["p95"]
    assert got["requests"] > 0 and got["prewarm"]["programs"] > 0


def test_serving_sim_stream_rate_needs_unified():
    """--stream-rate without --unified exits, as the JAX tool does."""
    from piper_tpu_torch.tools import serving_sim

    with pytest.raises(SystemExit, match="requires --unified"):
        serving_sim.main(["--device", "cpu", "--stream-rate", "2"])
