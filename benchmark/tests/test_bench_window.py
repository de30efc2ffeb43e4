"""The window arithmetic of each end-to-end metric, on fake programs that
answer on a schedule the test sets: no voice, no card."""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from benchmark.core import spec as specs
from benchmark.core.window import Window


class _Hp:
    hop_length = 256


class _Options:
    seed = 5


class FakeRuntime:
    hparams = _Hp()
    sample_rate = 22050
    options = _Options()


class StalledServer:
    """A BatchingServer stand-in that answers every request `service_s`
    after it arrives, except that it stalls (takes no request) for
    `stall_s` seconds once it has taken `stall_after` requests."""

    def __init__(self, service_s=0.005, stall_after=None, stall_s=0.0):
        self.service_s, self.stall_after, self.stall_s = service_s, stall_after, stall_s
        self.n = 0
        self.timers = []

    def submit(self, ids):
        self.n += 1
        if self.stall_after is not None and self.n == self.stall_after:
            time.sleep(self.stall_s)  # the submit itself blocks, as a full queue would
        fut = Future()
        t = threading.Timer(self.service_s, fut.set_result, [np.zeros(256 * len(ids), np.int16)])
        t.start()
        self.timers.append(t)
        return fut

    def metrics(self):
        return {"rows": self.n, "groups": self.n, "wait_ms_mean": 1.0, "padded_rows": 0,
                "shed_overload": 0, "shed_deadline": 0}

    def close(self):
        for t in self.timers:
            t.join()


def _served(server, rate=100.0, seconds=1.0):
    mix = {"rate": rate, "length_mix": [[1, 1.0]], "lead_in_s": 0.05}
    loop = specs.loop("served").Loop(FakeRuntime(), mix, seed=3)
    loop.server = server
    return loop.window(seconds)


def test_latency_runs_from_the_due_time_through_a_stall():
    """A stall of 0.3 s in submit: the requests due during it are answered
    late by up to the stall, though each waits only service_s after its
    submit. Timed from the submit the tail would read ~5 ms."""
    w = _served(StalledServer(service_s=0.005, stall_after=30, stall_s=0.3))
    assert w.attempted == 100 and w.failed == 0
    assert w.e2e["latency_ms_p95"] > 100.0
    assert w.info["generator_late_ms_max"] > 250.0


def test_latency_without_a_stall_is_the_service_time():
    w = _served(StalledServer(service_s=0.005))
    assert 4.0 < w.e2e["latency_ms_p95"] < 60.0


def test_a_failed_request_counts_as_infinitely_late():
    class Failing(StalledServer):
        def submit(self, ids):
            fut = super().submit(ids)
            if self.n % 10 == 0:
                f2 = Future()
                f2.set_exception(RuntimeError("fault"))
                return f2
            return fut

    w = _served(Failing())
    assert w.failed == 10 and w.e2e["latency_ms_p95"] == float("inf")


class FakePipeline:
    """ServingPipeline stand-in: each batch takes `batch_s`, one at a time."""

    def __init__(self, batch_s):
        self.batch_s = batch_s
        self.free_at = time.perf_counter()
        self.lock = threading.Lock()
        self.timers = []

    def submit_batch(self, ids_batch, seed=None):
        with self.lock:
            start = max(time.perf_counter(), self.free_at)
            self.free_at = start + self.batch_s
            delay = self.free_at - time.perf_counter()
        fut = Future()
        out = [np.zeros(256 * 10 * len(ids) // 14, np.int16) for ids in ids_batch]
        t = threading.Timer(delay, fut.set_result, [out])
        t.start()
        self.timers.append(t)
        return fut

    def close(self):
        for t in self.timers:
            t.join()


def test_offline_rate_is_whole_batches_over_their_time():
    mix = {"rows": 4, "classes": [[1, 0.5], [2, 0.5]], "block": 4, "ahead": 3, "content_seed": 1}
    loop = specs.loop("offline").Loop(FakeRuntime(), mix, seed=1)
    loop.pipe = FakePipeline(batch_s=0.05)
    w = loop.window(0.5)
    assert 8 <= w.info["batches"] <= 11
    audio = sum(len(r.pcm) for r in w.rows) / 22050
    assert w.e2e["audio_s_per_s"] == pytest.approx(audio / (w.t_close - w.t_open))
    # the window closes at the last completion inside it
    assert w.t_close - w.t_open <= 0.5
    per_batch = 4 * 256 * 10 * 1.5 / 22050  # mean audio of a batch (f = 1 or 2)
    assert w.e2e["audio_s_per_s"] == pytest.approx(per_batch / 0.05, rel=0.2)


def test_per_layer_readers_on_a_known_window_and_trace():
    from benchmark.core import costs

    config = specs.config("piper_high")
    w = Window(t_open=0.0, t_close=2.0, frames=[[100, 200]], phonemes=[[14, 28]],
                     traced_frames=[[100, 200]])
    trace = {"busy_s": 0.75, "window_s": 1.0,
             "kernel_s": {"void piper_rb::resblock1_kernel<true, false, 1, float, 32>(x)": 0.5,
                          "sm80_xmma_fprop": 0.25}}
    ctx = specs.Context(config=config, mix={}, window=w, trace=trace)
    read = lambda m: specs.reader(m).read(ctx)  # noqa: E731
    assert read("device_idle_share.offline") == pytest.approx(25.0)
    flops, nbytes = costs.resblock1_work(config["hparams"], [[100, 200]])
    want = 100 * costs.bound_s(flops, nbytes, "high") / 0.5
    assert read("resblock_roofline") == pytest.approx(want)
    no_kernel = dict(trace, kernel_s={"sm80_xmma_fprop": 0.25})
    assert specs.reader("resblock_roofline").read(
        specs.Context(config=config, mix={}, window=w, trace=no_kernel)) is None
    mfu = costs.step_flops(config["hparams"], [(14, 100), (28, 200)]) / 2.0
    assert read("mfu.offline") == pytest.approx(100 * mfu / costs.TIER_FLOPS["high"])
    assert specs.reader("device_idle_share.offline").read(
        specs.Context(config=config, mix={}, window=w, trace=None)) is None


def test_offline_sample_holds_every_slot_and_the_longest_class():
    from benchmark.reference.judge import Row

    mix = {"rows": 8}
    rows = [Row(ids=[0] * (14 if g % 3 else 56), seed=1, pcm=np.zeros(1, np.int16), group=g)
            for g in range(10) for _ in range(8)]
    for seed in (1, 2 ** 33 + 1):
        picked = specs.loop("offline").sample(rows, mix, seed)
        assert sorted(i % 8 for i in picked) == list(range(8))
        assert all(len(rows[i].ids) == 56 for i in picked if i % 8 % 4 == 0)
    assert specs.loop("offline").sample(rows, mix, 1) != specs.loop("offline").sample(rows, mix, 2)
