"""The port's timeline (utils/profiling.py): spans at the serving layers'
boundaries, on the CPU, and their CUDA events on a card.

- A torch.profiler session opened in the main thread opens the timeline
  for spans recorded in the pipeline's worker thread (the profiler's
  process-wide flag, a private global of torch's, is held here); with the
  profiler off and PIPER_TPU_TRACE unset nothing is kept.
- One submit_batch leaves pipeline.dispatch over runtime.encode,
  runtime.read and runtime.decode, and pipeline.fetch over runtime.fetch,
  one batch id on all, each inside its parent's interval; the ring is
  bounded.
- PIPER_TPU_TRACE=1 prints one stderr line a run with the JAX runtime's
  fields.
- A fused group whose rows overflow its frame budget raises the batcher's
  overflow_rows by the rows redone (overflow_split_rows by those a
  blocking split call redid), and reset_metrics() zeroes them.
- On a card (marked `cuda`): events map through the anchor onto
  perf_counter within 100 us of the host's own times, and a 2-row split
  batch queued behind device work, as the pipeline queues it, has a read
  gap from the events within 50 us of the one torch.profiler shows: from
  the encode's last operation on the card to the host's record of the
  decode's start event (the stream idle after the read, the event runs as
  it is recorded), the decode's first operation after it.

This file imports no JAX at module level, so its card tests run on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_timeline.py -q -m cuda
"""

import re
import time

import pytest
import torch

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine.batcher import BatchingServer
from piper_tpu_torch.engine.pipeline import ServingPipeline
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice
from piper_tpu_torch.utils import profiling

RUNTIME_SPANS = ("runtime.encode", "runtime.read", "runtime.decode", "runtime.fetch")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_ring():
    profiling.RING.clear()
    yield
    profiling.RING.clear()


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    return make_synthetic_voice(tmp_path_factory.mktemp("timeline_voice"), quality="test",
                                seed=5)


@pytest.fixture(scope="module")
def runtime(voice):
    return PiperRuntime(*voice, device="cpu")


def _one_batch(runtime, ids_batch):
    """One submit_batch through a pipeline, closed (its worker joined, so
    every span of the batch has ended)."""
    with ServingPipeline(runtime, num_fetchers=1) as pipe:
        return pipe.submit_batch(ids_batch).result(timeout=300)


def test_a_profiler_session_in_the_main_thread_opens_the_timeline_in_a_worker(runtime):
    # The process-wide flag the timeline reads (torch's private global):
    # a torch that drops it must fail here, not leave the timeline shut.
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    assert not runtime.profiler.trace
    _one_batch(runtime, [FIXTURE_IDS])
    assert list(profiling.RING) == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        assert profiling.profiler_active()
        _one_batch(runtime, [FIXTURE_IDS, FIXTURE_IDS[:6]])
    assert not profiling.profiler_active()
    names = {r.name: r.thread for r in list(profiling.RING)}
    assert set(RUNTIME_SPANS) | {"pipeline.dispatch", "pipeline.fetch"} <= set(names)
    assert all(names[n] == "piper-torch-pipeline-batch" for n in RUNTIME_SPANS)


def test_no_record_with_the_profiler_off_and_the_trace_flag_unset(voice, monkeypatch):
    monkeypatch.delenv("PIPER_TPU_TRACE", raising=False)
    rt = PiperRuntime(*voice, RuntimeOptions(mode="fused"), device="cpu")
    assert not rt.profiler.trace and not profiling.profiler_active()
    rt.synthesize(FIXTURE_IDS)
    rt.synthesize_batch([FIXTURE_IDS, FIXTURE_IDS[:6]])
    _one_batch(rt, [FIXTURE_IDS, FIXTURE_IDS[:6]])
    with BatchingServer(rt, max_batch=4, max_wait_ms=5) as server:
        server.submit(FIXTURE_IDS).result(timeout=300)
    assert list(profiling.RING) == []
    # The aggregates stay on: the layers' own rows beside the runtime's.
    rows = {s for s, _, _ in rt.profiler.rows()}
    assert {"fused", "encode", "decode", "pipeline.dispatch", "pipeline.fetch",
            "batcher.group", "batcher.dispatch", "batcher.fetch"} <= rows


def test_one_submit_batch_nests_the_runtime_spans_under_the_pipeline_spans(runtime,
                                                                          monkeypatch):
    monkeypatch.setattr(runtime.profiler, "trace", True)
    pcm = _one_batch(runtime, [FIXTURE_IDS, FIXTURE_IDS[:6]])
    recs = [r for r in list(profiling.RING) if r.name != "pipeline.wait"]
    by_name = {r.name: r for r in recs}
    assert len(by_name) == len(recs) == 6, recs
    by_id = {r.id: r for r in recs}
    dispatch, fetch = by_name["pipeline.dispatch"], by_name["pipeline.fetch"]
    for name in ("runtime.encode", "runtime.read", "runtime.decode"):
        assert by_name[name].parent == dispatch.id, name
    assert by_name["runtime.fetch"].parent == fetch.id
    assert dispatch.parent is None and fetch.parent is None
    assert len({r.batch for r in recs}) == 1
    for r in recs:
        assert r.t0 <= r.t1
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.t0 <= r.t0 and r.t1 <= p.t1, (r, p)
    enc, read, dec = (by_name[n] for n in ("runtime.encode", "runtime.read", "runtime.decode"))
    assert enc.t1 <= read.t0 and read.t1 <= dec.t0 and dispatch.t1 <= fetch.t0
    hop = runtime.hparams.hop_length
    frames = [len(a) // hop for a in pcm]
    assert dec.attrs == {"rows": 2, "padded_rows": 0, "f_bucket": dec.bucket,
                         "frames": sum(frames)}
    assert dec.bucket >= max(frames) and enc.bucket == 16
    assert all(r.events is None for r in recs)  # the CPU: no device work to bracket


def test_the_ring_is_bounded(monkeypatch):
    monkeypatch.setenv("PIPER_TPU_TRACE", "1")
    prof = profiling.Profiler()
    assert profiling.RING.maxlen == profiling.RING_SIZE
    for i in range(profiling.RING_SIZE + 10):
        with prof.span("s", i=i):
            pass
    recs = list(profiling.RING)
    assert len(recs) == profiling.RING_SIZE
    assert recs[0].attrs == {"i": 10} and recs[-1].attrs == {"i": profiling.RING_SIZE + 9}
    ((stage, _, st),) = prof.rows()
    assert stage == "s" and st.count == profiling.RING_SIZE + 10


LINE = re.compile(r"\[piper-tpu\] B=(\d+) P=(\d+) T=(\d+) (fused|split) "
                  r"wall=\d+\.\dms compiled=(True|False)")


def test_the_trace_flag_prints_one_line_a_run_with_the_jax_runtimes_fields(
        voice, monkeypatch, capsys):
    from piper_tpu.engine.runtime import PiperRuntime as JaxRuntime

    monkeypatch.setenv("PIPER_TPU_TRACE", "1")
    rt = PiperRuntime(*voice, device="cpu")
    assert rt.profiler.trace
    capsys.readouterr()
    rt.synthesize(FIXTURE_IDS)
    f_bucket = rt.last_run_timings.frame_bucket
    rt.synthesize_batch([FIXTURE_IDS, FIXTURE_IDS[:6]])
    outs, meta = rt.dispatch_batch([FIXTURE_IDS] * 2)
    rt.fetch_batch(outs, meta)
    # Called alone, the runtime's spans of one batch share its id.
    assert sorted(r.name for r in list(profiling.RING) if r.batch == meta["batch"]) == sorted(
        RUNTIME_SPANS)
    lines = capsys.readouterr().err.splitlines()
    assert len(lines) == 3, lines
    got = [LINE.fullmatch(x).groups() for x in lines]
    assert got[0][:4] == ("1", "16", str(f_bucket), "split") and got[0][4] == "True"
    assert [g[0] for g in got] == ["1", "2", "2"]
    assert got[2][2] == str(meta["f_bucket"])

    JaxRuntime(*voice).synthesize(FIXTURE_IDS)
    (jax_line,) = [x for x in capsys.readouterr().err.splitlines() if x.startswith("[piper-tpu]")]
    assert re.findall(r"(\w+)=", jax_line) == re.findall(r"(\w+)=", lines[0])
    assert LINE.fullmatch(jax_line).groups()[:4] == got[0][:4]


def test_overflow_rows_count_the_rows_a_fused_group_redid(voice):
    rt = PiperRuntime(*voice, RuntimeOptions(mode="fused"), device="cpu")
    reqs = [FIXTURE_IDS[:k] for k in (4, 8, 12, 14)]
    totals = [int(d.sum()) for d in rt.phoneme_durations(reqs)]
    with BatchingServer(rt, max_batch=8, max_wait_ms=200) as server:
        server._fpp = 0.5  # frame budget 32 at the 16-phoneme bucket, the redo's 64
        budget = rt._frame_bucket(server._budget_frames(16))
        redo = rt._frame_bucket(2 * server._budget_frames(16))
        for f in [server.submit(r) for r in reqs]:
            f.result(timeout=300)
        m = server.metrics()
        # One row fits, one is redone on the taller grid shape, one by a
        # blocking split call (this voice's totals: 14, 26, 57, 65 frames).
        assert (budget, redo) == (32, 64)
        assert m["overflow_rows"] == sum(t > budget for t in totals) == 2
        assert m["overflow_split_rows"] == sum(t > redo for t in totals) == 1
        server.reset_metrics()
        m = server.metrics()
        assert m["overflow_rows"] == m["overflow_split_rows"] == 0


# -- on a card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_events_map_onto_perf_counter_through_the_anchor(cuda, monkeypatch):
    monkeypatch.setenv("PIPER_TPU_TRACE", "1")
    prof = profiling.Profiler()
    with prof.span("anchor", device=cuda):
        pass
    torch.cuda.synchronize()
    time.sleep(0.2)
    # _sleep spins ~20M clock cycles (about 10 ms) on an idle card.
    with prof.span("sleep", device=cuda):
        torch.cuda._sleep(20_000_000)
    torch.cuda.synchronize()
    t_sync = time.perf_counter()
    first, rec = list(profiling.RING)
    assert rec.name == "sleep" and rec.anchor is first.anchor
    t_start, t_end = rec.clock(rec.events[0]), rec.clock(rec.events[1])
    # The card was idle: the start event ran as the host recorded it, the
    # end event as the sleep finished, just before the host's synchronize.
    assert t_end - t_start > 1e-3
    assert abs(t_start - rec.t0) < 100e-6, (t_start - rec.t0)
    assert abs(t_end - t_sync) < 100e-6, (t_end - t_sync)


@pytest.mark.cuda
def test_the_read_gap_from_events_matches_the_profilers(cuda, voice):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    rt = PiperRuntime(*voice, device="cuda")
    batch = [FIXTURE_IDS, FIXTURE_IDS[:6]]
    for _ in range(3):  # the kernels' build, cuDNN's choices, the allocator
        rt.fetch_batch(*rt.dispatch_batch(batch))
    # A first profile pays the profiler's set-up, and its batch makes the
    # timeline's anchor and side stream, so that neither holds the host
    # while the measured batch is queued.
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        rt.fetch_batch(*rt.dispatch_batch(batch))
    torch.cuda.synchronize()
    # CUDA activity alone: its runtime calls and its device operations
    # share CUPTI's clock (host operations' times may sit apart from it).
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as p:
        # The card still busy when the encode is queued, as in the pipeline,
        # where an encode waits behind the previous batch's decode: its end
        # event then runs as its last operation ends.
        torch.cuda._sleep(200_000_000)
        outs, meta = rt.dispatch_batch(batch)
        rt.fetch_batch(outs, meta)
        torch.cuda.synchronize()
    recs = {r.name: r for r in list(profiling.RING) if r.batch == meta["batch"]}
    enc, dec = recs["runtime.encode"], recs["runtime.decode"]
    gap_events_us = enc.events[1].elapsed_time(dec.events[0]) * 1e3
    events = list(p.events())
    ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == DeviceType.CUDA)
    # The frame counts' read is the one copy to pageable host memory (the
    # audio's goes to pinned memory). The host wakes from it, picks the
    # bucket and records the decode's start event: the first event record
    # (a CUDA runtime call) after the copy.
    (read,) = [i for i, op in enumerate(ops) if "Pageable" in op[2]]
    enc_last_end = max(e for _, e, _ in ops[:read])
    dec_recorded = min(e.time_range.start for e in events
                       if e.device_type == DeviceType.CPU and "EventRecord" in e.name
                       and e.time_range.start > ops[read][1])
    gap_profiler_us = dec_recorded - enc_last_end
    assert gap_events_us > 0 and gap_profiler_us > 0
    assert abs(gap_events_us - gap_profiler_us) < 50, (gap_events_us, gap_profiler_us)
    # The decode's first operation runs after its start event: the host's
    # preparation of that launch is the decode span's, not the read gap's.
    assert ops[read + 1][0] > dec_recorded
