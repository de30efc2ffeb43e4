"""Loop kind `offline`: a narration job through ServingPipeline.submit_batch.

Batches of the mix's `rows` rows, one length class a batch
(`traffic.offline_batches`), `ahead` batches outstanding so the worker's
queue never empties. The window opens when the first batch completes and
closes at the last completion within `seconds`: `audio_s_per_s` is the
audio of whole batches over the time they took.

The judge holds every row to frames_off and, to audio_gap, one row in each
slot of a batch (the slot's batch drawn from the seed), a quarter of them
from batches of the longest class.
"""

from __future__ import annotations

import collections
import time
from typing import List

import numpy as np

from benchmark.core import traffic
from benchmark.core.trace import span
from benchmark.core.window import Window
from benchmark.reference.judge import Row


class Loop:
    def __init__(self, rt, mix: dict, seed: int):
        self.rt, self.mix, self.seed = rt, mix, seed

    def prepare(self) -> dict:
        from piper_tpu_torch.engine.pipeline import ServingPipeline

        self.pipe = ServingPipeline(self.rt, **self.mix.get("pipeline", {}))
        # One batch of every length class at the window's shape (a seed of
        # its own), through the same entry: cuDNN's per-shape choices and
        # the allocator's growth land here, not in the window.
        warm = traffic.offline_batches(self.mix, self.seed ^ 0x5EED)
        seen, futs = set(), []
        for b in warm:
            if b.factor not in seen:
                seen.add(b.factor)
                futs.append(self.pipe.submit_batch(b.ids, seed=b.seed))
            if len(seen) == len(self.mix["classes"]):
                break
        for f in futs:
            f.result()
        return {"warm_batches": len(futs)}

    def window(self, seconds: float, tracer=None) -> Window:
        w = Window()
        gen = traffic.offline_batches(self.mix, self.seed)
        inflight = collections.deque()
        hop = self.rt.hparams.hop_length
        sr = self.rt.sample_rate

        def submit():
            b = next(gen)
            with span(tracer, "bench.submit_batch"):
                inflight.append((b, self.pipe.submit_batch(b.ids, seed=b.seed)))

        for _ in range(self.mix["ahead"]):
            submit()
        b0, f0 = inflight.popleft()
        f0.result()
        submit()
        w.t_open = time.perf_counter()
        slice_s = float(self.mix.get("trace_slice_s", seconds))
        traced = None
        done = []
        while True:
            b, f = inflight.popleft()
            with span(tracer, "bench.wait_batch"):
                pcm = f.result()
            t = time.perf_counter()
            if t - w.t_open > seconds and done:
                break
            done.append((b, pcm, t))
            if tracer is not None and traced is None and t - w.t_open >= seconds - slice_s:
                # the traced slice: the window's last slice_s, from a completion
                traced = [t, None]
                tracer.start()
            submit()
        w.t_close = done[-1][2]
        for _, f in inflight:
            f.result()
        if traced is not None:
            traced[1] = w.t_close
            tracer.stop()
        self.pipe.close()
        audio_s = 0.0
        for b, pcm, t in done:
            audio_s += sum(len(a) for a in pcm) / sr
            w.rows += [Row(ids=list(ids), seed=b.seed, pcm=a, group=b.index)
                       for ids, a in zip(b.ids, pcm)]
            w.frames.append([len(a) // hop for a in pcm])
            w.phonemes.append([len(ids) for ids in b.ids])
            if traced is not None and traced[0] < t <= traced[1]:
                w.traced_frames.append(w.frames[-1])
        w.attempted = sum(len(b.ids) for b, _, _ in done)
        w.e2e["audio_s_per_s"] = audio_s / (w.t_close - w.t_open)
        w.info.update(batches=len(done), factors=[b.factor for b, _, _ in done],
                      audio_s=audio_s, window_s=w.t_close - w.t_open,
                      batch_ms=[round((t - t0) * 1e3, 3) for (_, _, t0), (_, _, t)
                                in zip([(None, None, w.t_open)] + done[:-1], done)])
        if traced is not None:
            w.info["trace_interval"] = traced
        return w


def planned_rows(mix: dict, seed: int, seconds: float, batches: int) -> List[Row]:
    gen = traffic.offline_batches(mix, seed)
    rows = []
    for _ in range(batches):
        b = next(gen)
        rows += [Row(ids=ids, seed=b.seed, pcm=None, group=b.index) for ids in b.ids]
    return rows


def judged(ref, rows: List[Row], runtime_seed: int) -> None:
    """Nothing to add: a batch's seed and its longest row set its noise."""


def sample(rows: List[Row], mix: dict, seed: int) -> List[int]:
    """One row in each slot of a batch: slot j's from a batch drawn from the
    seed, among the batches of the longest class for every fourth slot."""
    groups = collections.defaultdict(list)
    for i, r in enumerate(rows):
        groups[r.group].append(i)
    batches = [g for g in groups.values()
               if len(g) == mix["rows"] and all(rows[i].pcm is not None for i in g)]
    if not batches:
        return []
    longest = max(len(rows[g[0]].ids) for g in batches)
    top = [g for g in batches if len(rows[g[0]].ids) == longest]
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 98])
    out = []
    for j in range(mix["rows"]):
        pool = top if j % 4 == 0 else batches
        out.append(pool[int(rng.integers(len(pool)))][j])
    return sorted(out)
