"""Loop kind `served`: independent users, open loop, into a BatchingServer.

Poisson arrivals (`traffic.open_loop`, the mix's `rate` and `length_mix`)
into `BatchingServer(rt, **mix["server"])`. The mix's `lead_in_s` of
arrivals runs first and is set-up: the window opens when it ends, with its
backlog in flight. A request's latency runs from its due time to its
future's result; every request due in the window counts, a shed or failed
one as infinitely late.

Every request takes the runtime's own noise seed (the mix's `noise_seed`)
and is decoded at the fused frame budget the batcher derives for its
phoneme bucket, or at the redo's: the judge works both out again from the
reference's calibration of the voice (`judged`).
"""

from __future__ import annotations

import math
import time
from typing import List

from benchmark.core import traffic
from benchmark.core.trace import span
from benchmark.core.window import Window
from benchmark.reference.judge import PHONEME_BUCKETS, Row, bucket, sample_rows


class Loop:
    def __init__(self, rt, mix: dict, seed: int):
        self.rt, self.mix, self.seed = rt, mix, seed

    def buckets(self) -> List[int]:
        return sorted({bucket(len(traffic.PHRASE) * f, PHONEME_BUCKETS)
                       for f, _ in self.mix["length_mix"]})

    def prepare(self) -> dict:
        from piper_tpu_torch.engine.batcher import BatchingServer

        self.server = BatchingServer(self.rt, **self.mix.get("server", {}))
        return self.server.prewarm(p_buckets=self.buckets())

    def _drive(self, arrivals, t0: float, records: list, tracer=None, trace_from=None):
        """Submit each arrival at its due time; start the trace at the first
        arrival due `trace_from` seconds or more into the schedule."""
        from piper_tpu_torch.engine.batcher import ServerOverloaded

        late = []
        traced = None
        for a in arrivals:
            due = t0 + a.due
            if tracer is not None and traced is None and a.due >= trace_from:
                tracer.start()
                traced = [time.perf_counter(), None]
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            rec = {"arrival": a, "due": due, "done": None, "fut": None}
            t_sub = time.perf_counter()
            late.append(t_sub - due)
            try:
                with span(tracer, "bench.submit"):
                    fut = self.server.submit(a.ids)
            except ServerOverloaded as e:
                rec["error"] = e
                records.append(rec)
                continue
            fut.add_done_callback(lambda f, r=rec: r.__setitem__("done", time.perf_counter()))
            rec["fut"] = fut
            records.append(rec)
        return late, traced

    def window(self, seconds: float, tracer=None) -> Window:
        mix, w = self.mix, Window()
        rate = float(mix["rate"])
        sched = mix.get("schedule_seed")
        lead = traffic.open_loop(rate, mix["lead_in_s"], mix["length_mix"], self.seed, stream=1,
                                 schedule_seed=sched)
        arrivals = traffic.open_loop(rate, seconds, mix["length_mix"], self.seed, stream=0,
                                     schedule_seed=sched)
        t_lead = time.perf_counter() + 0.01
        self._drive(lead, t_lead, [])
        t0 = t_lead + mix["lead_in_s"]
        m0 = self.server.metrics()
        w.t_open = t0
        records: list = []
        trace_from = seconds - float(mix.get("trace_slice_s", seconds))
        late, traced = self._drive(arrivals, t0, records, tracer, trace_from)
        w.t_close = t0 + seconds
        deadline = w.t_close + 60.0
        for rec in records:
            if rec["fut"] is None:
                continue
            try:
                rec["pcm"] = rec["fut"].result(timeout=max(0.0, deadline - time.perf_counter()))
            except Exception as e:  # noqa: BLE001 - a failed request is counted, not raised
                rec["error"] = e
        if traced is not None:  # stopped once every request due in the window is answered
            traced[1] = w.t_close
            tracer.stop()
        m1 = self.server.metrics()
        self.server.close()
        lat = []
        hop = self.rt.hparams.hop_length
        for rec in records:
            pcm = rec.get("pcm")
            ok = pcm is not None and rec["done"] is not None
            lat.append((rec["done"] - rec["due"]) if ok else math.inf)
            w.rows.append(Row(ids=list(rec["arrival"].ids), seed=self.rt.options.seed,
                              pcm=pcm if ok else None, group=rec["arrival"].index))
            if ok:
                w.frames.append([len(pcm) // hop])
                w.phonemes.append([len(rec["arrival"].ids)])
        w.attempted = len(records)
        w.failed = sum(1 for x in lat if math.isinf(x))
        w.e2e["latency_ms_p95"] = traffic.percentile(lat, 95) * 1e3
        by_second = [[x for x, r in zip(lat, records) if int(r["arrival"].due) == k]
                     for k in range(int(math.ceil(seconds)))]
        w.info["latency_ms_p50_by_second"] = [traffic.percentile(b, 50) * 1e3 for b in by_second]
        w.info.update(latency_ms_p50=traffic.percentile(lat, 50) * 1e3,
                      latency_ms_p99=traffic.percentile(lat, 99) * 1e3,
                      generator_late_ms_p99=traffic.percentile(late, 99) * 1e3,
                      generator_late_ms_max=max(late) * 1e3 if late else 0.0,
                      requests=len(records), rate=rate,
                      latency_ms_p50_first_half=traffic.percentile(
                          [x for x, r in zip(lat, records) if r["arrival"].due < seconds / 2], 50) * 1e3,
                      latency_ms_p50_second_half=traffic.percentile(
                          [x for x, r in zip(lat, records) if r["arrival"].due >= seconds / 2], 50) * 1e3)
        rows = m1["rows"] - m0["rows"]
        groups = m1["groups"] - m0["groups"]
        waits = m1["wait_ms_mean"] * m1["rows"] - m0["wait_ms_mean"] * m0["rows"]
        w.counters = {"rows": rows, "groups": groups, "wait_ms_sum": waits,
                      "padded_rows": m1["padded_rows"] - m0["padded_rows"],
                      "shed": (m1["shed_overload"] + m1["shed_deadline"]
                               - m0["shed_overload"] - m0["shed_deadline"])}
        if traced is not None:
            w.info["trace_interval"] = traced
        return w


def planned_rows(mix: dict, seed: int, seconds: float, batches: int) -> List[Row]:
    arrivals = traffic.open_loop(float(mix["rate"]), seconds, mix["length_mix"], seed,
                                 schedule_seed=mix.get("schedule_seed"))
    noise = int(mix.get("noise_seed", seed)) & 0xFFFFFFFF
    return [Row(ids=a.ids, seed=noise, pcm=None, group=a.index) for a in arrivals]


def judged(ref, rows: List[Row], runtime_seed: int) -> None:
    """Each row's fused frame budget and its redo's, from the reference's
    own calibration of the voice at the runtime's noise seed."""
    buckets = sorted({bucket(len(r.ids), PHONEME_BUCKETS) for r in rows})
    budgets = ref.calibrated_budgets(runtime_seed, buckets)
    for r in rows:
        r.budget = budgets[bucket(len(r.ids), PHONEME_BUCKETS)]


def sample(rows: List[Row], mix: dict, seed: int) -> List[int]:
    return sample_rows(rows, int(mix.get("judge_rows", 96)), seed)
