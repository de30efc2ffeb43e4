"""The port's ServingPipeline (mirrors tests/test_pipeline.py's single-speaker
tests), on the CPU with the tiny test voice.

`submit` runs fused dispatches; its results equal a fused-mode synthesize
with the same seed. `submit_batch` runs split batches on one worker; its
results equal synthesize_batch. The tiny voice needs ~7 frames per
phoneme: fused_frames_per_phoneme=1 with length_scale 3 overflows the
budget, and the fetcher redoes the utterance in split mode.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine.pipeline import ServingPipeline
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread per process: each pipeline thread that drives
    torch gets its own OpenMP team, and under a parallel test run those
    teams oversubscribe the cores (tens of seconds for a one-second test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runtime(tiny_voice):
    return PiperRuntime(*tiny_voice, device="cpu")


def _fused(voice, **kw):
    return PiperRuntime(*voice, RuntimeOptions(mode="fused", **kw), device="cpu")


def test_pipeline_matches_fused_synthesize(runtime, tiny_voice):
    ref = _fused(tiny_voice).synthesize(FIXTURE_IDS, seed=9)
    with ServingPipeline(runtime) as pipe:
        audio = pipe.submit(FIXTURE_IDS, seed=9).result(timeout=300)
    np.testing.assert_array_equal(audio, ref)


def test_pipeline_many_requests_in_flight(runtime):
    reqs = [FIXTURE_IDS, FIXTURE_IDS[:8], FIXTURE_IDS * 2, FIXTURE_IDS[:4]] * 3
    with ServingPipeline(runtime, max_inflight=4) as pipe:
        futs = [pipe.submit(ids, seed=i) for i, ids in enumerate(reqs)]
        audios = [f.result(timeout=300) for f in futs]
    assert len(audios) == len(reqs)
    for a in audios:
        assert len(a) > 0 and np.isfinite(a).all()
    with ServingPipeline(runtime) as pipe:
        again = pipe.submit(reqs[0], seed=0).result(timeout=300)
    np.testing.assert_array_equal(again, audios[0])


def test_pipeline_overflow_falls_back(tiny_voice):
    rt = _fused(tiny_voice, fused_frames_per_phoneme=1)
    ref = rt.synthesize(FIXTURE_IDS, length_scale=3.0)  # overflows the budget
    with ServingPipeline(rt) as pipe:
        audio = pipe.submit(FIXTURE_IDS, length_scale=3.0).result(timeout=300)
    np.testing.assert_array_equal(audio, ref)


def test_overflow_redo_while_others_dispatch(tiny_voice):
    """A fetcher's split-mode redo runs the runtime's blocking synthesize
    while other threads keep dispatching: under the runtime's lock every
    result still equals its own synthesize. More client threads than cores,
    and a short switch interval, so the threads interleave finely."""
    rt = _fused(tiny_voice, fused_frames_per_phoneme=1)
    clients = max(12, (os.cpu_count() or 1) + 2)
    reqs = [(FIXTURE_IDS, 3.0 if i % 3 == 0 else 0.5, i) for i in range(2 * clients)]
    want = [rt.synthesize(ids, length_scale=ls, seed=s) for ids, ls, s in reqs]
    got = [None] * len(reqs)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ServingPipeline(rt, max_inflight=6, num_fetchers=3) as pipe:
            def client(k):
                futs = [(i, pipe.submit(reqs[i][0], length_scale=reqs[i][1], seed=reqs[i][2]))
                        for i in range(k, len(reqs), clients)]
                for i, f in futs:
                    got[i] = f.result(timeout=300)

            threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_submit_batch_matches_synthesize_batch(runtime):
    batch = [FIXTURE_IDS, FIXTURE_IDS[:8], FIXTURE_IDS * 2]
    ref = runtime.synthesize_batch(batch, seed=7)
    with ServingPipeline(runtime) as pipe:
        audios = pipe.submit_batch(batch, seed=7).result(timeout=300)
    assert len(audios) == len(ref)
    for a, r in zip(audios, ref):
        np.testing.assert_array_equal(a, r)


def test_submit_batch_pipelines_multiple_batches(runtime):
    batch = [FIXTURE_IDS, FIXTURE_IDS[:6]]
    with ServingPipeline(runtime, max_inflight=3) as pipe:
        futs = [pipe.submit_batch(batch, seed=i) for i in range(5)]
        results = [f.result(timeout=300) for f in futs]
    assert not np.array_equal(results[0][0], results[1][0])  # seeds differ
    for i, res in enumerate(results):
        for a, r in zip(res, runtime.synthesize_batch(batch, seed=i)):
            np.testing.assert_array_equal(a, r)


def test_submit_batch_singleton_matches_fused(tiny_voice):
    """A 1-row batch on a fused-mode runtime delegates to dispatch_fused, so
    it equals synthesize_batch (which takes the fused path for one row)."""
    rt = _fused(tiny_voice, fused_frames_per_phoneme=12)
    ref = rt.synthesize_batch([FIXTURE_IDS], seed=21)
    with ServingPipeline(rt) as pipe:
        out = pipe.submit_batch([FIXTURE_IDS], seed=21).result(timeout=300)
    assert {kind for kind, _ in rt._compiled_keys} == {"fused"}
    np.testing.assert_array_equal(out[0], ref[0])


def test_submit_batch_error_propagates(runtime):
    with ServingPipeline(runtime) as pipe:
        fut = pipe.submit_batch([[999999], FIXTURE_IDS])
        with pytest.raises(ValueError):
            fut.result(timeout=60)
        audios = pipe.submit_batch([FIXTURE_IDS]).result(timeout=300)
    assert len(audios) == 1 and len(audios[0]) > 0


def test_pipeline_error_propagates(runtime):
    with ServingPipeline(runtime) as pipe:
        fut = pipe.submit([999999])  # out-of-range phoneme id
        with pytest.raises(ValueError):
            fut.result(timeout=60)
        audio = pipe.submit(FIXTURE_IDS).result(timeout=300)  # still serving
    assert len(audio) > 0


def test_submit_after_close_raises(runtime):
    pipe = ServingPipeline(runtime)
    pipe.close()
    with pytest.raises(RuntimeError):
        pipe.submit(FIXTURE_IDS)
    with pytest.raises(RuntimeError):
        pipe.submit_batch([FIXTURE_IDS])


def test_cancelled_future_does_not_kill_fetchers(runtime):
    with ServingPipeline(runtime, num_fetchers=2) as pipe:
        for _ in range(4):  # more cancels than fetchers
            fut = pipe.submit(FIXTURE_IDS)
            fut.cancel()  # may or may not win the race; both must be safe
        outs = [pipe.submit(FIXTURE_IDS) for _ in range(3)]
        for f in outs:
            assert len(f.result(timeout=300)) > 0


def test_cancelled_batch_future_keeps_worker(runtime):
    with ServingPipeline(runtime) as pipe:
        f0 = pipe.submit_batch([FIXTURE_IDS, FIXTURE_IDS[:6]])
        f0.cancel()
        audios = pipe.submit_batch([FIXTURE_IDS]).result(timeout=300)
        assert len(audios) == 1 and len(audios[0]) > 0


def test_threads_are_named_and_joined(runtime):
    """Every pipeline thread is named piper-torch-pipeline-* (the suite's
    leak guard looks for piper-*), and close() joins them all."""
    pipe = ServingPipeline(runtime, num_fetchers=3)
    pipe.submit_batch([FIXTURE_IDS]).result(timeout=300)
    mine = pipe._fetchers + [pipe._batch_thread]
    assert sorted(t.name for t in mine) == [
        "piper-torch-pipeline-batch", "piper-torch-pipeline-fetch-0",
        "piper-torch-pipeline-fetch-1", "piper-torch-pipeline-fetch-2"]
    pipe.close()
    assert not any(t.is_alive() for t in mine)
