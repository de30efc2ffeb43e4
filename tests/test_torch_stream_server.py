"""The port's batched multi-stream server (piper_tpu_torch.engine.stream_server),
on the CPU.

Every case of tests/test_stream_server.py under its own name, with the same
fixtures (emit_frames=16, c0=8, row_rungs=(1, 2, 4), max_sessions=8) and
the same bar: a stream served beside others within 1e-5 of the port's own
synthesize_stream_incremental at its seed (the same fp32 sums, which the
CPU's convs order by the batch's shape). Then the StreamingServer cases of
tests/test_speaker_mix.py on a 4-speaker voice, and the port against the
JAX package's StreamingServer on the same voice at noise_scale=0,
noise_w=0, where both are deterministic (seeded noise is the standing
deviation of ROADMAP.md §3): concurrent streams of different lengths and
phoneme buckets, lengths and chunk boundaries equal, the waveform within
1e-4 max-abs at fp32 and 1e-3 at "high" (BASELINE.md's gate for the
lowered tiers). Last, units: _pad_enc, a tick's host reads, and the kernel
counters of a CPU stream.

Torch runs one intra-op thread in this module: the servers drive it from
worker threads, and under six xdist workers each thread's OpenMP team
would oversubscribe the cores.
"""

import queue
import threading
import time

import numpy as np
import pytest
import torch

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine import runtime as runtime_mod
from piper_tpu_torch.engine.batcher import ServerOverloaded
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
from piper_tpu_torch.engine.stream_server import StreamingServer, _Session
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice
from piper_tpu_torch.ops.kernels import conv as K1
from piper_tpu_torch.ops.kernels import folded as K4
from piper_tpu_torch.ops.kernels import interleave as K5
from piper_tpu_torch.ops.kernels import resblock as R

ROW_ATOL = 1e-5
WAVE_ATOL, MIXED_ATOL = 1e-4, 1e-3
SMALL = dict(emit_frames=16, c0=8, row_rungs=(1, 2, 4), max_sessions=8)
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


@pytest.fixture(scope="module")
def server(runtime):
    srv = StreamingServer(runtime, **SMALL)
    yield srv
    srv.shutdown()


def _collect(chunks):
    chunks = list(chunks)
    assert chunks[-1].is_final
    assert all(not c.is_final for c in chunks[:-1])
    offs = [c.start_sample_index for c in chunks]
    sizes = [len(c.samples) for c in chunks]
    assert offs == [int(np.sum(sizes[:i])) for i in range(len(sizes))]
    return np.concatenate([c.samples for c in chunks])


def _reference(rt, ids, seed, **kw):
    return np.concatenate([c.samples for c in rt.synthesize_stream_incremental(
        ids, seed=seed, **kw)])


def _concurrently(fn, cases):
    """fn(*case) on one thread per case; their results in case order."""
    results, errors = {}, []

    def run(i, case):
        try:
            results[i] = fn(*case)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, c)) for i, c in enumerate(cases)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    return [results[i] for i in range(len(cases))]


# -- tests/test_stream_server.py on the port -----------------------------------


def test_single_stream_matches_incremental(server, runtime):
    ids = FIXTURE_IDS * 3
    got = _collect(server.submit(ids, seed=5))
    ref = _reference(runtime, ids, seed=5)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, atol=ROW_ATOL)


def test_concurrent_streams_are_exact(server, runtime):
    """Streams batched together must each equal their solo decode — across
    different lengths, seeds, and finish times."""
    cases = [(FIXTURE_IDS * 2, 11), (FIXTURE_IDS * 5, 12), (FIXTURE_IDS, 13),
             (FIXTURE_IDS * 4, 14)]
    results = _concurrently(lambda ids, seed: _collect(server.submit(ids, seed=seed)), cases)
    for i, (ids, seed) in enumerate(cases):
        ref = _reference(runtime, ids, seed)
        assert len(results[i]) == len(ref), (i, len(results[i]), len(ref))
        np.testing.assert_allclose(results[i], ref, atol=ROW_ATOL, err_msg=f"stream {i}")
    m = server.metrics()
    assert m["window_dispatches"] >= 1
    # concurrency actually batched rows (not 4 serialized B=1 decodes)
    assert m["window_rows"] > m["window_dispatches"]


def test_chunk_cadence(server, runtime):
    """Chunk 0 carries c0 frames, steady chunks emit_frames, tail trimmed."""
    hop = runtime.hparams.hop_length
    chunks = list(server.submit(FIXTURE_IDS * 3, seed=2))
    sizes = [len(c.samples) for c in chunks]
    assert sizes[0] == 8 * hop
    assert all(s == 16 * hop for s in sizes[1:-1])
    assert 0 < sizes[-1] <= 16 * hop


def test_short_stream_is_single_final_chunk(server, runtime):
    """An utterance that fits in the head window ends in one chunk."""
    big = StreamingServer(runtime, emit_frames=16, c0=4096, row_rungs=(1,), max_sessions=2)
    try:
        chunks = list(big.submit(FIXTURE_IDS, seed=3))
        assert len(chunks) == 1 and chunks[0].is_final
        ref = _reference(runtime, FIXTURE_IDS, seed=3)
        assert len(chunks[0].samples) == len(ref)
    finally:
        big.shutdown()


def test_overload_rejects(runtime):
    srv = StreamingServer(runtime, emit_frames=16, c0=8, row_rungs=(1,), max_sessions=1)
    try:
        it = srv.submit(FIXTURE_IDS * 3, seed=1)
        with pytest.raises(ServerOverloaded):
            srv.submit(FIXTURE_IDS, seed=2)
        _collect(it)  # drain; the slot frees
        _collect(srv.submit(FIXTURE_IDS, seed=2))
    finally:
        srv.shutdown()


def test_invalid_ids_fail_only_that_stream(server):
    with pytest.raises(ValueError):
        list(server.submit([10 ** 9], seed=1))
    # server still serves
    _collect(server.submit(FIXTURE_IDS, seed=4))


def _mk_session(ids, seed):
    return _Session(sid=0, ids=list(ids), seed=seed, noise_scale=None,
                    length_scale=None, noise_w=None, speaker_id=None,
                    out=queue.Queue(maxsize=100))


def _abandon(sessions):
    """The test read what it checks: cancel the rest, as a consumer that
    stops early does, so shutdown() need not wait out its grace for the
    chunks nobody reads."""
    for s in sessions:
        s.cancelled = True


def test_burst_heads_batch_and_match_solo(runtime):
    """Simultaneous same-bucket arrivals run ONE batched head; each row's
    first chunk equals the solo stream's audio — including a shorter row
    sharing the bucket (the seeded duration-noise draw spans the bucket,
    so same-bucket grouping is the exactness condition)."""
    srv = StreamingServer(runtime, **SMALL)
    try:
        short = (FIXTURE_IDS * 2)[:17]  # bucket 32, same as 28 phonemes
        cases = [(FIXTURE_IDS * 2, 31), (FIXTURE_IDS * 2, 32), (short, 33)]
        sessions = [_mk_session(ids, seed) for ids, seed in cases]
        with srv._lock:
            srv._n_open += len(sessions)
        work = srv._dispatch_heads(sessions)
        assert [w[0] for w in work] == ["headb"]
        m = srv.metrics()
        assert m["head_dispatches"] == 1 and m["head_rows"] == 3
        assert m["padded_head_rows"] == 1  # 3 rows pad to rung 4
        srv._process("headb", work[0][1], work[0][2].wait())
        for (ids, seed), s in zip(cases, sessions):
            chunk = s.out.get(timeout=30)
            ref = _reference(runtime, ids, seed)
            np.testing.assert_allclose(chunk.samples, ref[: len(chunk.samples)], atol=ROW_ATOL)
            if chunk.is_final:
                assert len(chunk.samples) == len(ref)
    finally:
        _abandon(sessions)
        srv.shutdown()


def test_burst_mixed_buckets_split_into_groups(runtime):
    """Arrivals from different phoneme buckets never share a head batch
    (bucket-dependent noise would change a stream's audio)."""
    srv = StreamingServer(runtime, **SMALL)
    try:
        cases = [(FIXTURE_IDS, 41), (FIXTURE_IDS * 2, 42),
                 (FIXTURE_IDS * 2, 43)]  # buckets 16, 32, 32
        sessions = [_mk_session(ids, seed) for ids, seed in cases]
        with srv._lock:
            srv._n_open += len(sessions)
        work = srv._dispatch_heads(sessions)
        assert sorted(w[0] for w in work) == ["head", "headb"]
        for kind, target, copy in work:
            srv._process(kind, target, copy.wait())
        for (ids, seed), s in zip(cases, sessions):
            chunk = s.out.get(timeout=30)
            ref = _reference(runtime, ids, seed)
            np.testing.assert_allclose(chunk.samples, ref[: len(chunk.samples)], atol=ROW_ATOL)
    finally:
        _abandon(sessions)
        srv.shutdown()


def test_bad_row_fails_only_that_stream_in_a_burst(runtime):
    """A validation error inside a burst falls back to solo heads: the
    good streams play, only the offending one fails."""
    srv = StreamingServer(runtime, **SMALL)
    try:
        good = _mk_session(FIXTURE_IDS * 2, 51)
        bad = _mk_session((FIXTURE_IDS * 2)[:-1] + [10 ** 9], 52)
        with srv._lock:
            srv._n_open += 2
        work = srv._dispatch_heads([good, bad])
        assert [w[0] for w in work] == ["head"]  # solo fallback, bad failed
        assert isinstance(bad.out.get_nowait(), ValueError)
        for kind, target, copy in work:
            srv._process(kind, target, copy.wait())
        ref = _reference(runtime, good.ids, 51)
        chunk = good.out.get(timeout=30)
        np.testing.assert_allclose(chunk.samples, ref[: len(chunk.samples)], atol=ROW_ATOL)
    finally:
        _abandon([good])
        srv.shutdown()


def test_prewarm_covers_traffic_programs(runtime):
    """Every shape the traffic runs was marked by the prewarm (the runtime's
    first-run keys do not grow)."""
    srv = StreamingServer(runtime, emit_frames=16, c0=8, row_rungs=(1, 2), max_sessions=4)
    try:
        stats = srv.prewarm(phoneme_lengths=(len(FIXTURE_IDS),))
        assert stats["programs"] == 4 and stats["seconds"] > 0  # head, head x2, windows x1/x2
        before = len(runtime._compiled_keys)
        done = _concurrently(lambda seed: _collect(srv.submit(FIXTURE_IDS, seed=seed)),
                             [(1,), (2,)])
        assert len(done) == 2
        assert len(runtime._compiled_keys) == before
    finally:
        srv.shutdown()


def _wait_closed(srv):
    deadline = time.time() + 30
    while time.time() < deadline and srv.metrics()["open_sessions"] > 0:
        time.sleep(0.02)
    assert srv.metrics()["open_sessions"] == 0


def test_cancel_frees_session_slot(runtime):
    """An abandoned stream (consumer stops early) releases its
    max_sessions slot once cancelled."""
    srv = StreamingServer(runtime, max_sessions=2, emit_frames=16, c0=8)
    try:
        handle = srv.submit(FIXTURE_IDS * 4)
        it = iter(handle)
        next(it)  # read the head chunk, then walk away
        handle.cancel()
        _wait_closed(srv)
        # slot is reusable: a fresh stream completes
        chunks = list(srv.submit(FIXTURE_IDS))
        assert chunks and chunks[-1].is_final
        # cancel-before-head also frees
        h2 = srv.submit(FIXTURE_IDS * 4)
        h2.cancel()
        _wait_closed(srv)
    finally:
        srv.shutdown()


def test_cancel_as_context_manager(runtime):
    srv = StreamingServer(runtime, max_sessions=2, emit_frames=16, c0=8)
    try:
        with srv.submit(FIXTURE_IDS * 4) as handle:
            next(iter(handle))
        _wait_closed(srv)
    finally:
        srv.shutdown()


def test_worker_crash_fails_every_session(runtime, monkeypatch):
    """Sessions dispatched in the CURRENT tick (new_work / ready) must fail
    too: inject a window-dispatch failure and require every open stream to
    resolve (with an error) and every slot to free."""
    srv = StreamingServer(runtime, max_sessions=4, emit_frames=16, c0=8)
    try:
        def boom(*a, **k):
            raise RuntimeError("injected window failure")

        handles = [srv.submit(FIXTURE_IDS * 4, seed=i) for i in range(3)]
        monkeypatch.setattr(srv.rt, "dispatch_window_batch", boom)
        results = []
        for h in handles:
            try:
                results.append(sum(len(c.samples) for c in h))
            except Exception as e:  # noqa: BLE001
                results.append(e)
        # every consumer resolved (no hang), none silently truncated
        assert all(isinstance(r, Exception) for r in results if not isinstance(r, int))
        _wait_closed(srv)
    finally:
        srv.shutdown()


# -- the StreamingServer cases of tests/test_speaker_mix.py ----------------------


@pytest.fixture(scope="module")
def ms_voice(tmp_path_factory):
    return make_synthetic_voice(tmp_path_factory.mktemp("ms_stream_server"), quality="test",
                                seed=6, n_speakers=4, gin_channels=32)


@pytest.fixture(scope="module")
def ms_runtime(ms_voice):
    return PiperRuntime(*ms_voice, device="cpu")


def test_streaming_prewarm_mix_heads(ms_runtime):
    server = StreamingServer(ms_runtime, max_sessions=4)
    try:
        base = server.prewarm(phoneme_lengths=(14,), head_rungs=(1, 2))
        mixed = server.prewarm(phoneme_lengths=(14,), head_rungs=(1, 2), speaker_mix=True)
        assert mixed["programs"] > base["programs"]
    finally:
        server.shutdown()


def test_streaming_server_mix(ms_runtime):
    server = StreamingServer(ms_runtime, max_sessions=8)
    try:
        # Sequential (solo-head) submissions: a one-hot mix is bit-identical
        # to the id stream (the mix product runs in true fp32).
        a_id = np.concatenate([c.samples for c in server.submit(
            FIXTURE_IDS, seed=7, speaker_id=3)])
        a_mix = np.concatenate([c.samples for c in server.submit(
            FIXTURE_IDS, seed=7, speaker_mix={3: 1.0})])
        np.testing.assert_array_equal(a_id, a_mix)
        # Simultaneous mix + blend: the two mix streams may burst into ONE
        # batched head (same conditioning kind), whose sums run in another
        # order than b=1 ones: a tight allclose.
        h_mix2 = server.submit(FIXTURE_IDS, seed=7, speaker_mix={3: 1.0})
        h_blend = server.submit(FIXTURE_IDS, seed=7, speaker_mix={0: 0.5, 3: 0.5})
        a_mix2 = np.concatenate([c.samples for c in h_mix2])
        a_blend = np.concatenate([c.samples for c in h_blend])
        np.testing.assert_allclose(a_mix2, a_mix, atol=ROW_ATOL)
        assert np.isfinite(a_blend).all()
        if a_blend.shape == a_id.shape:
            assert not np.array_equal(a_blend, a_id)
        with pytest.raises(ValueError):
            server.submit(FIXTURE_IDS, speaker_mix={9: 1.0})
        with pytest.raises(ValueError):
            server.submit(FIXTURE_IDS, speaker_id=1, speaker_mix={0: 1.0})
    finally:
        server.shutdown()


# -- the port against the JAX package's StreamingServer ---------------------------

# Three streams, phoneme buckets 16, 32 and 64, at once: they batch their
# windows across buckets (rows padded to the group's largest).
CROSS_STREAMS = [(FIXTURE_IDS, 1), (FIXTURE_IDS * 2, 2), (FIXTURE_IDS * 4, 3)]


def _served(srv, streams, **kw):
    """Every stream submitted before any is read, then drained on one
    thread each: [(chunk sizes, offsets, audio)] in stream order."""
    handles = [srv.submit(ids, seed=seed, **ZERO, **kw) for ids, seed in streams]

    def drain(h):
        chunks = list(h)
        assert chunks[-1].is_final and not any(c.is_final for c in chunks[:-1])
        return ([len(c.samples) for c in chunks], [c.start_sample_index for c in chunks],
                np.concatenate([c.samples for c in chunks]))

    return _concurrently(drain, [(h,) for h in handles])


@pytest.mark.parametrize("tier,atol,spk", [
    (None, WAVE_ATOL, None),
    ("high", MIXED_ATOL, None),
    (None, WAVE_ATOL, {"speaker_id": 2}),
], ids=["fp32", "high", "speaker"])
def test_streams_match_the_reference_server(tiny_voice, ms_voice, tier, atol, spk):
    """At zero noise both servers serve the same concurrent streams: equal
    chunk sizes and offsets, the waveform within the tier's bar."""
    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime
    from piper_tpu.engine.runtime import RuntimeOptions as JaxOptions
    from piper_tpu.engine.stream_server import StreamingServer as JaxServer

    voice = tiny_voice if spk is None else ms_voice
    tiers = dict(vocoder_precision=tier, flow_precision=tier)
    port = StreamingServer(PiperRuntime(*voice, RuntimeOptions(**tiers), device="cpu"), **SMALL)
    ref = JaxServer(JaxRuntime(*voice, options=JaxOptions(**tiers)), **SMALL)
    try:
        got = _served(port, CROSS_STREAMS, **(spk or {}))
        want = _served(ref, CROSS_STREAMS, **(spk or {}))
        assert port.metrics()["window_rows"] > port.metrics()["window_dispatches"]
    finally:
        port.shutdown()
        ref.shutdown()
    for (sizes, offs, audio), (w_sizes, w_offs, w_audio) in zip(got, want):
        assert (sizes, offs) == (w_sizes, w_offs)
        assert len(sizes) > 2  # a head and several windows
        np.testing.assert_allclose(audio, w_audio, atol=atol, rtol=0)


# -- units -----------------------------------------------------------------------


def test_pad_enc_pads_w_and_keeps_g(ms_runtime):
    """_pad_enc pads m_p, logs_p, x_mask, w and w_ceil with zeros along the
    phoneme axis and keeps y_total and the speaker vector g; a window over
    the padded encode is the window over the original, exactly."""
    rt = ms_runtime
    enc, _, total, _, ns = rt.dispatch_stream_head(FIXTURE_IDS, c0=8, halo=15, seed=3,
                                                   speaker_id=1)
    padded = StreamingServer._pad_enc(enc, 32)
    assert StreamingServer._pad_enc(enc, 16) is enc
    for name in ("m_p", "logs_p", "x_mask", "w", "w_ceil"):
        a, b = getattr(enc, name), getattr(padded, name)
        assert b.shape[-1] == 32 and torch.equal(b[..., :16], a), name
        assert not b[..., 16:].any(), name
    assert padded.g is enc.g and padded.g is not None
    assert padded.y_total is enc.y_total
    assert enc.w.sum() > 0
    kw = dict(emit_frames=16, halo=15)
    args = ([3], [8 - 15], [int(total)], [ns])
    torch.testing.assert_close(rt.dispatch_window_batch(padded, *args, **kw),
                               rt.dispatch_window_batch(enc, *args, **kw), rtol=0, atol=0)


def test_pad_enc_keeps_a_missing_g(runtime):
    enc = runtime.dispatch_stream_head(FIXTURE_IDS, c0=8, halo=15, seed=3)[0]
    padded = StreamingServer._pad_enc(enc, 64)
    assert enc.g is None and padded.g is None
    assert padded.w.shape[-1] == 64 and not padded.w[..., 16:].any()


class _NoHostReads:
    """Refuse every host read of a tensor (item, tolist, cpu, numpy, int,
    float, bool) outside _HostCopy.wait, and count the waits."""

    NAMES = ("item", "tolist", "cpu", "numpy", "__int__", "__float__", "__bool__")

    def __init__(self, monkeypatch):
        self.waits = 0
        self._in_wait = False
        real_wait = runtime_mod._HostCopy.wait

        def wait(copy):
            self.waits += 1
            self._in_wait = True
            try:
                return real_wait(copy)
            finally:
                self._in_wait = False

        monkeypatch.setattr(runtime_mod._HostCopy, "wait", wait)
        for name in self.NAMES:
            monkeypatch.setattr(torch.Tensor, name, self._refuse(name, getattr(torch.Tensor, name)))

    def _refuse(self, name, real):
        def method(t, *a, **k):
            if not self._in_wait:
                raise AssertionError(f"a tick read a tensor on the host: Tensor.{name}")
            return real(t, *a, **k)
        return method


def test_a_tick_reads_the_device_only_through_its_copies(runtime, monkeypatch):
    """Driven tick by tick (no worker): a tick waits once for each copy of
    the previous tick's dispatches and makes no other host read of a
    tensor — heads and windows dispatched in one tick included — and the
    streams still equal their solo runs."""
    cases = [(FIXTURE_IDS * 2, 61), (FIXTURE_IDS * 3, 62), (FIXTURE_IDS, 63)]
    refs = [_reference(runtime, ids, seed) for ids, seed in cases]
    srv = StreamingServer(runtime, start_worker=False, **SMALL)
    guard = _NoHostReads(monkeypatch)
    handles = [srv.submit(ids, seed=seed) for ids, seed in cases[:2]]
    out = [[] for _ in cases]
    ticks = both = 0
    while srv.pending() or len(handles) < len(cases):
        if ticks == 2:  # a late arrival: its head beside the others' windows
            handles.append(srv.submit(cases[2][0], seed=cases[2][1]))
        prev = len(srv._inflight)
        waits = guard.waits
        heads = srv.metrics()["head_dispatches"]
        windows = srv.metrics()["window_dispatches"]
        srv.tick()
        assert guard.waits - waits == prev
        m = srv.metrics()
        both += m["head_dispatches"] > heads and m["window_dispatches"] > windows
        ticks += 1
        for i, h in enumerate(handles):
            while not h._s.out.empty():
                out[i].append(h._s.out.get_nowait())
        assert ticks < 500
    monkeypatch.undo()
    assert both >= 1 and srv.metrics()["window_rows"] > srv.metrics()["window_dispatches"]
    for chunks, ref in zip(out, refs):
        np.testing.assert_allclose(_collect(chunks), ref, atol=ROW_ATOL)
    srv.shutdown()


def test_cpu_streams_launch_no_kernel(server):
    counters = (R.resblock1_branch, R.resblock1_mrf, K1.conv1d_same,
                K4.resblock1_mrf_folded, K5.interleave)
    before = [c.launches for c in counters]
    _concurrently(lambda seed: _collect(server.submit(FIXTURE_IDS * 2, seed=seed)),
                  [(71,), (72,)])
    assert [c.launches for c in counters] == before
