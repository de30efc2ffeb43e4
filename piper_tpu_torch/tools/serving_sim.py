"""Realistic serving simulation on the port: Poisson arrivals, mixed
utterance lengths (the port of tools/serving_sim.py: its length mix, flags,
defaults and JSON line).

The headline bench measures saturated uniform batches; production traffic is
neither. This tool drives the continuous BatchingServer with Poisson request
arrivals over a mix of utterance lengths (short prompts to paragraph-length)
and reports end-to-end request latency percentiles, achieved batch grouping,
and aggregate real-time factor — the numbers a capacity plan needs.

Usage (the card by default; the checkout root on PYTHONPATH):
    python -m piper_tpu_torch.tools.serving_sim                  # 60 req/s, 30 s
    python -m piper_tpu_torch.tools.serving_sim --rates 100,200,400 --duration 20
    python -m piper_tpu_torch.tools.serving_sim --unified --stream-rate 4
    python -m piper_tpu_torch.tools.serving_sim --device cpu --quality test --rate 20 --duration 2

The runtime is the bench's: its mixed tiers (encoder "highest", vocoder
and flows "high"), fused mode, int16, built by piper_tpu_torch.bench's
get_runtime. The server is prewarmed over its whole grid, a warm-up pass of
traffic runs, then one measured pass per rate prints one JSON line: the JAX
tool's keys (latency p50/p95/p99/max in ms, rtf_aggregate, the server's
grouping and sheds), plus `device` (the card's name and power limit, as
nvidia-smi gives them), `prewarm` (grid shapes run and seconds) and
`hbm_bytes` (the weights' bytes per voice). `--profile-s S` adds `profile`:
after each measured pass, a second pass of the same traffic whose middle S
seconds run under torch.profiler (behind tools/timing.py's sentinels; the
profiler perturbs the host, so its latencies are not reported): the device
kernels' summed time (device busy) and its share of that window's wall;
with `--stream-rate` the streams run in that pass too.

`--unified` serves the mix through UnifiedServer (batch and stream traffic
on one worker) instead of the batcher; with `--stream-rate R` Poisson
stream arrivals (R streams/s of the fixture phrase x `--stream-factor`)
open beside the batch traffic during each measured pass, and the line
gains `streams` (count, sheds, TTFB p50/p95/max, audio seconds, realtime
factor per stream). `--stream-group-frac` shrinks batch groups while
streams are open.

`--http` drives the same traffic through the door users hit: the port's
PiperHTTPServer (engine/http_server.py) over its MultiVoiceBatchingServer,
on loopback TCP, each request a POST /v1/synthesize with "format": "pcm"
from a pool of client threads in this process (HttpClient below), so the
latency includes JSON, the PCM body and TCP, and the line gains
"http": true and `door`: the pass's failed connections (counted by the
client, left out of the latency). The clients share the interpreter with
the server's handler threads and its worker, so the numbers bound the
door's cost from above.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine.batcher import (BatchingServer, DeadlineExceeded,
                                            MultiVoiceBatchingServer, ServerOverloaded)

# (repeat-factor, weight): 14-phoneme prompts dominate, with a tail of
# paragraph-length requests — a chat/assistant-style mix.
LENGTH_MIX = [(1, 0.45), (2, 0.25), (4, 0.15), (8, 0.10), (16, 0.05)]


class HttpClient:
    """Concurrent clients of a PiperHTTPServer at host:port: a pool of
    `workers` threads, each request on a connection of its own. `post`
    returns a Future of the parsed body: int16 PCM for "format": "pcm",
    float32 samples for a WAV (utils/wav.py's parse_wav_bytes), the JSON
    document otherwise. A 429 resolves to the batcher's ServerOverloaded or
    DeadlineExceeded (the body's message says which), any other status but
    200 to a RuntimeError. A connection that fails (refused, reset, timed
    out) raises its OSError and adds one to `transport_errors`."""

    def __init__(self, host: str, port: int, workers: int):
        from concurrent.futures import ThreadPoolExecutor

        self.host, self.port = host, port
        self.pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="sim-http")
        self.transport_errors = 0
        self._lock = threading.Lock()

    def request(self, path: str, body: dict):
        import http.client

        conn = http.client.HTTPConnection(self.host, self.port, timeout=600)
        try:
            conn.request("POST", path, body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
        except OSError:
            with self._lock:
                self.transport_errors += 1
            raise
        finally:
            conn.close()
        if resp.status == 429:
            # both admission sheds map to 429; the body says which
            msg = data.decode()[:200]
            if "pending" in msg:
                raise ServerOverloaded(msg)
            raise DeadlineExceeded(msg)
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status} on {path}: {data[:200]!r}")
        ctype = resp.getheader("Content-Type") or ""
        if ctype == "audio/x-raw-int16":
            return np.frombuffer(data, "<i2")
        if ctype == "audio/wav":
            from piper_tpu_torch.utils.wav import parse_wav_bytes

            return parse_wav_bytes(data)[0]
        return json.loads(data)

    def post(self, body: dict, path: str = "/v1/synthesize") -> Future:
        return self.pool.submit(self.request, path, body)

    def close(self) -> None:
        self.pool.shutdown(wait=True)


def _merge_voice_metrics(per: dict) -> dict:
    """Aggregate MultiVoiceBatchingServer.metrics() (per-voice dicts) into
    the single-server shape report() expects."""
    m = {k: 0 for k in ("groups", "rows", "padded_rows",
                        "shed_overload", "shed_deadline")}
    m["cache_hits"] = sum(v.get("cache_hits", 0) for v in per.values())
    m["cache_bytes"] = sum(v.get("cache_bytes", 0) for v in per.values())
    wait_sum = wait_max = 0.0
    for v in per.values():
        for k in m:
            m[k] += v[k]
        wait_sum += v["wait_ms_mean"] * v["rows"]
        wait_max = max(wait_max, v["wait_ms_max"])
    m["wait_ms_mean"] = wait_sum / m["rows"] if m["rows"] else 0.0
    m["wait_ms_max"] = wait_max
    m["rows_per_group"] = m["rows"] / m["groups"] if m["groups"] else 0.0
    m["per_voice_rows"] = {k: v["rows"] for k, v in per.items()}
    return m


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rate", type=float, default=60.0, help="requests/second")
    ap.add_argument("--rates", default="",
                    help="comma list of rates to sweep IN ONE PROCESS (one "
                         "prewarm, one JSON line per rate)")
    ap.add_argument("--duration", type=float, default=30.0, help="seconds of traffic")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--max-pending", type=int, default=None,
                    help="admission cap: shed (503) beyond this many queued")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="shed queued requests older than this before dispatch")
    ap.add_argument("--quality", default="medium")
    ap.add_argument("--voices", type=int, default=1,
                    help=">1 serves the mix across N resident voices through "
                         "MultiVoiceBatchingServer (requests pick a voice "
                         "uniformly; the same synthetic checkpoint, so the cost "
                         "being measured is the scheduler splitting traffic into "
                         "per-voice groups)")
    ap.add_argument("--http", action="store_true",
                    help="drive the SAME traffic through PiperHTTPServer "
                         "over loopback TCP (measures the full deployment "
                         "stack: JSON parse + batcher + PCM encode + HTTP)")
    ap.add_argument("--cache-mb", type=float, default=0.0,
                    help="response-cache budget (MB) per voice; see "
                         "BatchingServer(cache_mb=)")
    ap.add_argument("--phrase-pool", type=int, default=0,
                    help="distinct phrase variants per length factor "
                         "(0 = one canonical phrase per factor; with "
                         "--cache-mb that is a near-100%% hit canned-phrase "
                         "workload, larger pools lower the hit rate)")
    ap.add_argument("--unified", action="store_true",
                    help="serve through UnifiedServer (batch + streaming on "
                         "ONE worker) instead of the dedicated batcher — "
                         "run both in one session to measure the "
                         "unification tax")
    ap.add_argument("--stream-rate", type=float, default=0.0,
                    help="with --unified: additionally open low-latency "
                         "streams at this Poisson rate (streams/s) during "
                         "the measured pass; reports stream TTFB p50/p95 "
                         "alongside the batch numbers")
    ap.add_argument("--stream-factor", type=int, default=4,
                    help="stream utterance length (x the 14-phoneme fixture)")
    ap.add_argument("--stream-group-frac", type=float, default=1.0,
                    help="with --unified: batch groups pop at this fraction "
                         "of their size while streams are open (TTFB vs "
                         "batch-efficiency tradeoff; 0.25 = prewarmed mid "
                         "rung)")
    ap.add_argument("--add-voice-at", type=float, default=None,
                    help="seconds into the measured pass to add_voice a new "
                         "voice on the live server (non-pausing warm); "
                         "reports resident-voice p50 before/during/after "
                         "the warm")
    ap.add_argument("--add-voice-quality", default=None,
                    help="architecture of the added voice (default: same "
                         "as --quality)")
    ap.add_argument("--warm-every", type=int, default=2,
                    help="one add_voice warm step per this many traffic "
                         "groups (higher = gentler on resident latency, "
                         "longer warm)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--profile-s", type=float, default=0.0,
                    help="seconds of a second pass at each rate under "
                         "torch.profiler: device busy and its share of the "
                         "window (the card only)")
    return ap


def run_traffic(submit, duration, rng, rate, sample_rate, phrase_pool=0):
    """Poisson arrivals at `rate` for `duration` seconds, each a draw of
    LENGTH_MIX from `rng` handed to `submit(rng, ids)` (a future); then
    waits for every request. Returns ([(latency s, factor, submit time
    from the start)] of the served ones, their audio seconds at
    `sample_rate`, the wall, and the sheds {"overload", "deadline"})."""
    factors = [f for f, _ in LENGTH_MIX]
    weights = np.asarray([w for _, w in LENGTH_MIX])
    weights = weights / weights.sum()
    recs = []
    shed = {"overload": 0, "deadline": 0}
    t_start = time.perf_counter()
    next_at = t_start
    while True:
        now = time.perf_counter()
        if now - t_start >= duration:
            break
        if now < next_at:
            time.sleep(min(next_at - now, 0.005))
            continue
        f = int(rng.choice(factors, p=weights))
        ids = (FIXTURE_IDS * f)[:4096]
        if phrase_pool:
            # rotate the phrase: valid ids, distinct sequence per
            # variant — a cheap stand-in for a phrase pool
            r = int(rng.integers(phrase_pool)) % len(ids)
            ids = ids[r:] + ids[:r]
        t_submit = time.perf_counter()
        try:
            fut = submit(rng, ids)
        except ServerOverloaded:
            shed["overload"] += 1
            next_at += rng.exponential(1.0 / rate)
            continue
        done_at = {}
        fut.add_done_callback(lambda fu, d=done_at: d.setdefault("t", time.perf_counter()))
        recs.append((t_submit, f, fut, done_at))
        next_at += rng.exponential(1.0 / rate)
    out = []
    audio_s = 0.0
    for t_submit, f, fut, done_at in recs:
        try:
            audio = fut.result(timeout=600)
        except DeadlineExceeded:
            shed["deadline"] += 1
            continue
        except ServerOverloaded:  # --http surfaces sheds at result time
            shed["overload"] += 1
            continue
        except OSError:  # --http: the connection failed (HttpClient counts it)
            continue
        audio_s += len(audio) / sample_rate
        out.append(((done_at.get("t", time.perf_counter())) - t_submit, f,
                    t_submit - t_start))
    return out, audio_s, time.perf_counter() - t_start, shed


def run_streams(server, voice, ids, duration, rng, rate, t_start, sample_rate):
    """Poisson stream arrivals at `rate` streams/s on a UnifiedServer's
    `voice` for `duration` seconds from `t_start`, beside the batch traffic;
    one pool thread per stream drains its chunks. Returns per-stream dicts:
    ttfb_ms, audio_s, wall_s (or {"shed": True})."""
    from concurrent.futures import ThreadPoolExecutor

    stats: list = []
    futs = []

    def one_stream():
        t0 = time.perf_counter()
        try:
            handle = server.submit_stream(voice, ids)
        except ServerOverloaded:
            stats.append({"shed": True})
            return
        first = None
        n = 0
        for chunk in handle:
            if first is None:
                first = time.perf_counter() - t0
            n += len(chunk.samples)
        stats.append({"ttfb_ms": first * 1e3, "audio_s": n / sample_rate,
                      "wall_s": time.perf_counter() - t0})

    with ThreadPoolExecutor(max_workers=64, thread_name_prefix="sim-stream") as pool:
        next_at = t_start
        while True:
            now = time.perf_counter()
            if now - t_start >= duration:
                break
            if now < next_at:
                time.sleep(min(next_at - now, 0.005))
                continue
            futs.append(pool.submit(one_stream))
            next_at += rng.exponential(1.0 / rate)
        for f in futs:
            f.result(timeout=600)
    return stats


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.http and args.unified:
        raise SystemExit("--http drives the batcher's door (PiperHTTPServer without "
                         "stream=True); it does not combine with --unified")
    if args.stream_rate > 0 and not args.unified:
        raise SystemExit("--stream-rate requires --unified")
    if args.profile_s and args.device != "cuda":
        raise SystemExit("--profile-s profiles the card: it needs --device cuda")

    import torch

    from piper_tpu_torch import bench as bench_mod
    from piper_tpu_torch.engine.bucketing import bucket_for

    device = bench_mod._device_info(torch, args.device)
    rt_args = argparse.Namespace(
        model=None, config=None, quality=args.quality, precision="highest",
        mode="fused", vocoder_precision="high", flow_precision="high",
        output_dtype="int16", device=args.device,
    )
    rt = bench_mod.get_runtime(rt_args)
    runtimes = {"v0": rt}
    for i in range(1, args.voices):
        # Same synthetic checkpoint, separate runtime instances: the
        # scheduler still has to split traffic into per-voice groups — the
        # multi-voice cost under study.
        runtimes[f"v{i}"] = bench_mod.get_runtime(rt_args)

    factors = [f for f, _ in LENGTH_MIX]

    multi = args.voices > 1 or args.add_voice_at is not None or args.http
    http_srv = client = None
    if args.http:
        # Full-stack mode: requests travel over real (loopback) HTTP into
        # PiperHTTPServer's multi-voice batcher; a thread pool stands in
        # for concurrent clients, one worker per plausibly-in-flight
        # request (a small fixed pool would queue clients at high rates
        # and bill that wait as server latency).
        from piper_tpu_torch.engine.http_server import PiperHTTPServer

        http_srv = PiperHTTPServer(
            runtimes, port=0, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            max_pending=args.max_pending, deadline_ms=args.deadline_ms,
            cache_mb=args.cache_mb, warm_every=args.warm_every)
        http_srv.start()
        server = http_srv.server
        peak_rate = max([float(r) for r in args.rates.split(",")] if args.rates
                        else [args.rate])
        client = HttpClient(http_srv.host, http_srv.port,
                            workers=min(2048, max(256, int(peak_rate * 8))))
        voice_keys = list(runtimes)

        def submit(rng, ids):
            voice = voice_keys[int(rng.integers(len(voice_keys)))]
            return client.post({"voice": voice, "phoneme_ids": list(ids), "format": "pcm"})

        def merged_metrics():
            return _merge_voice_metrics(server.metrics())
    elif args.unified:
        from piper_tpu_torch.engine.unified import UnifiedServer

        server = UnifiedServer(
            runtimes, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            max_pending=args.max_pending, deadline_ms=args.deadline_ms,
            cache_mb=args.cache_mb, warm_every=args.warm_every,
            stream_group_frac=args.stream_group_frac)
        voice_keys = list(runtimes)

        def submit(rng, ids):
            return server.submit(voice_keys[int(rng.integers(len(voice_keys)))],
                                 ids, noise_scale=None)

        def merged_metrics():
            return _merge_voice_metrics(server.batch.metrics())
    elif multi:
        server = MultiVoiceBatchingServer(
            runtimes, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            max_pending=args.max_pending, deadline_ms=args.deadline_ms,
            cache_mb=args.cache_mb, warm_every=args.warm_every)
        voice_keys = list(runtimes)

        def submit(rng, ids):
            return server.submit(voice_keys[int(rng.integers(len(voice_keys)))],
                                 ids, noise_scale=None)

        def merged_metrics():
            return _merge_voice_metrics(server.metrics())
    else:
        server = BatchingServer(rt, max_batch=args.max_batch,
                                max_wait_ms=args.max_wait_ms,
                                max_pending=args.max_pending,
                                deadline_ms=args.deadline_ms,
                                cache_mb=args.cache_mb)

        def submit(rng, ids):
            return server.submit(ids, noise_scale=None)

        merged_metrics = server.metrics
    with (http_srv if http_srv is not None else server):
        # Prewarm the server's ENTIRE fused grid (each phoneme bucket of the
        # mix x its <=3 row rungs, and the overflow shape): a (rows, frames)
        # shape first seen mid-traffic pays its first-run costs there.
        p_buckets = sorted({
            bucket_for(len((FIXTURE_IDS * f)[:4096]),
                       rt.options.phoneme_buckets, "phoneme")
            for f in factors})
        stream_ids = (FIXTURE_IDS * args.stream_factor)[:4096]
        if args.unified:
            warm = server.prewarm(p_buckets=p_buckets, stream=args.stream_rate > 0,
                                  stream_kwargs=dict(phoneme_lengths=(len(stream_ids),)))
            parts = list(warm["batch"].values()) + list(warm.get("stream", {}).values())
            programs = sum(w["programs"] for w in parts)
            secs = sum(w["seconds"] for w in parts)
            fpp = next(iter(warm["batch"].values()))["frames_per_phoneme"]
        elif multi:
            warm = server.prewarm(p_buckets=p_buckets)
            programs = sum(w["programs"] for w in warm.values())
            secs = sum(w["seconds"] for w in warm.values())
            fpp = next(iter(warm.values()))["frames_per_phoneme"]
        else:
            warm = server.prewarm(p_buckets=p_buckets)
            programs, secs, fpp = (warm["programs"], warm["seconds"],
                                   warm["frames_per_phoneme"])
        print(f"[serving_sim] prewarmed {programs} grid programs in "
              f"{secs:.0f}s (fpp {fpp:.2f})", file=sys.stderr)
        extra = {"device": device,
                 "prewarm": {"programs": programs, "seconds": secs,
                             "frames_per_phoneme": fpp},
                 "hbm_bytes": {k: r.hbm_bytes() for k, r in runtimes.items()}}
        add_rt = None
        if args.add_voice_at is not None:
            # Build the new voice's runtime BEFORE the measured pass (the
            # checkpoint build/load is host work; the cost under study is
            # the on-worker warming).
            add_args = argparse.Namespace(**vars(rt_args))
            add_args.quality = args.add_voice_quality or args.quality
            add_rt = bench_mod.get_runtime(add_args)
        rates = ([float(r) for r in args.rates.split(",")] if args.rates
                 else [args.rate])
        if args.profile_s:
            # The profiler's first start (its CUDA tracing set up) before
            # any traffic, on this thread as every later window.
            from piper_tpu_torch.tools.timing import profiled

            profiled(lambda: None)
        # Short warmup traffic pass (steady-state queues), then one measured
        # pass per rate.
        run_traffic(submit, min(args.duration, 10.0), np.random.default_rng(args.seed + 1),
                    rates[0], rt.sample_rate, args.phrase_pool)
        for rate in rates:
            # Each pass reports its own counters, not the warmup's or the
            # previous rates' (the server is shared across the sweep).
            server.reset_metrics()
            errors0 = client.transport_errors if client is not None else 0
            t_start = time.perf_counter()
            stream_stats: list = []
            stream_th = None
            if args.stream_rate > 0:

                def _streams():
                    stream_stats.extend(run_streams(
                        server, "v0", stream_ids, args.duration,
                        np.random.default_rng(args.seed + 7), args.stream_rate, t_start,
                        rt.sample_rate))

                stream_th = threading.Thread(target=_streams)
                stream_th.start()
            add_state: dict = {}
            add_th = None
            if args.add_voice_at is not None:

                def _adder():
                    time.sleep(args.add_voice_at)
                    add_state["t_add"] = time.perf_counter() - t_start
                    fut = server.add_voice(f"vnew_{rate:g}", add_rt, p_buckets=p_buckets,
                                           **({"stream_prewarm": False} if args.unified
                                              else {}))
                    stats = fut.result(timeout=1200)
                    add_state["t_done"] = time.perf_counter() - t_start
                    add_state["stats"] = stats

                add_th = threading.Thread(target=_adder)
                add_th.start()
            results, audio_s, wall, shed = run_traffic(
                submit, args.duration, np.random.default_rng(args.seed), rate, rt.sample_rate,
                args.phrase_pool)
            if add_th is not None:
                add_th.join(timeout=1800)
            if stream_th is not None:
                stream_th.join(timeout=1800)
            metrics = merged_metrics()
            prof = {}
            if client is not None:
                prof["door"] = {"transport_errors": client.transport_errors - errors0}
            if args.profile_s:
                # The same traffic again (streams too) from side threads;
                # this thread profiles its middle.
                side = [threading.Thread(target=run_traffic, args=(
                    submit, args.profile_s + 2.0, np.random.default_rng(args.seed + 2), rate,
                    rt.sample_rate, args.phrase_pool))]
                if args.stream_rate > 0:
                    side.append(threading.Thread(target=run_streams, args=(
                        server, "v0", stream_ids, args.profile_s + 2.0,
                        np.random.default_rng(args.seed + 9), args.stream_rate,
                        time.perf_counter(), rt.sample_rate)))
                for th in side:
                    th.start()
                time.sleep(1.0)
                prof["profile"] = _profile_window(args.profile_s)
                for th in side:
                    th.join(timeout=600)
            report(args, rate, results, audio_s, wall, shed, metrics,
                   factors, stream_stats=stream_stats, add_state=add_state,
                   extra={**extra, **prof})
    if client is not None:
        client.close()


# Fewer device kernels than this in a profiled window of traffic means the
# profiler kept the sentinels but lost the worker's launches: one served
# group alone launches ~1,400-1,900 kernels.
MIN_WINDOW_KERNELS = 1000


def _profile_window(window_s: float, tries: int = 3) -> dict:
    """`window_s` seconds of the card under torch.profiler while traffic
    runs (tools/timing.py::profiled: the sentinels first): the device
    kernels' summed time (device busy) and its share of the window's wall,
    the window ending when the card has done what was queued in it. A
    window that lost its sentinels, or kept fewer than MIN_WINDOW_KERNELS
    kernels, is profiled again, up to `tries` windows; `windows` says how
    many ran."""
    import torch

    from piper_tpu_torch.tools.timing import SENTINELS, device_kernels, profiled

    for n in range(1, tries + 1):
        t = {}

        def run():
            t0 = time.perf_counter()
            time.sleep(window_s)
            torch.cuda.synchronize()
            t["wall_ms"] = (time.perf_counter() - t0) * 1e3

        events = profiled(run)
        count, us = device_kernels(events) if events is not None else (0, 0.0)
        if count >= MIN_WINDOW_KERNELS:
            return {"window_ms": t["wall_ms"], "device_kernels": count,
                    "device_busy_ms": us / 1e3, "busy_share": us / 1e3 / t["wall_ms"],
                    "sentinels": SENTINELS, "windows": n}
    return {"window_ms": t["wall_ms"], "windows": tries,
            "error": f"every window lost its sentinels or kept < {MIN_WINDOW_KERNELS} kernels "
                     f"(the last kept {count})"}


def _pctl(sorted_vals, p):
    if not sorted_vals:
        return None
    k = (len(sorted_vals) - 1) * p / 100.0
    lo, hi = int(np.floor(k)), int(np.ceil(k))
    return sorted_vals[lo] if lo == hi else (
        sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (k - lo))


def report(args, rate, results, audio_s, wall, shed, server_metrics, factors,
           stream_stats=None, add_state=None, extra=None):
    lats_ms = sorted(l * 1e3 for l, _, _ in results)
    if not lats_ms:
        # Tiny rate/--duration (or all requests failed) can leave the
        # measured window empty; report that instead of an IndexError.
        print(json.dumps({
            "metric": "serving_sim", "error": "no completed requests",
            "rate_req_s": rate, "offered_duration_s": args.duration,
            **(extra or {}),
        }), flush=True)
        return

    def pct(p):
        return _pctl(lats_ms, p)

    print(json.dumps({
        "metric": "serving_sim",
        "platform": args.device,
        "rate_req_s": rate,
        "offered_duration_s": args.duration,
        "requests": len(results),
        "length_mix_factors": factors,
        "latency_ms": {"p50": round(pct(50), 1), "p95": round(pct(95), 1),
                       "p99": round(pct(99), 1), "max": round(lats_ms[-1], 1)},
        "audio_s_total": round(audio_s, 1),
        "offered_rtf": round(audio_s / args.duration, 1),
        "wall_s": round(wall, 2),
        "rtf_aggregate": round(audio_s / wall, 1),
        "max_batch": args.max_batch,
        "max_wait_ms": args.max_wait_ms,
        "shed": shed,
        "server": {
            "rows_per_group": round(server_metrics["rows_per_group"], 1),
            "groups": server_metrics["groups"],
            "padded_rows": server_metrics["padded_rows"],
            "wait_ms_mean": round(server_metrics["wait_ms_mean"], 1),
            "wait_ms_max": round(server_metrics["wait_ms_max"], 1),
            "shed_overload": server_metrics["shed_overload"],
            "shed_deadline": server_metrics["shed_deadline"],
            **({"cache_hits": server_metrics.get("cache_hits", 0),
                "cache_bytes": server_metrics.get("cache_bytes", 0)}
               if args.cache_mb else {}),
            **({"per_voice_rows": server_metrics["per_voice_rows"]}
               if "per_voice_rows" in server_metrics else {}),
        },
        **({"voices": args.voices} if args.voices > 1 else {}),
        **({"http": True} if getattr(args, "http", False) else {}),
        **({"unified": True} if getattr(args, "unified", False) else {}),
        **_stream_report(stream_stats),
        **_add_voice_report(results, add_state),
        **(extra or {}),
    }), flush=True)


def _stream_report(stream_stats) -> dict:
    if not stream_stats:
        return {}
    ok = [s for s in stream_stats if "ttfb_ms" in s]
    ttfbs = sorted(s["ttfb_ms"] for s in ok)
    walls = sum(s["wall_s"] for s in ok)
    audio = sum(s["audio_s"] for s in ok)
    return {"streams": {
        "count": len(ok),
        "shed": sum(1 for s in stream_stats if s.get("shed")),
        "ttfb_ms": {"p50": round(_pctl(ttfbs, 50), 1),
                    "p95": round(_pctl(ttfbs, 95), 1),
                    "max": round(ttfbs[-1], 1)} if ttfbs else None,
        "audio_s_total": round(audio, 1),
        "rtf_per_stream_mean": round(audio / walls, 1) if walls else None,
    }}


def _add_voice_report(results, add_state) -> dict:
    """Resident-voice latency windows around a live add_voice: the
    non-pausing criterion is p50(during warm) staying near p50(before)."""
    if not add_state or "t_add" not in add_state:
        return {}
    t_add = add_state["t_add"]
    t_done = add_state.get("t_done")

    def win(lo, hi):
        w = sorted(l * 1e3 for l, _, t in results if lo <= t < hi)
        return ({"p50": round(_pctl(w, 50), 1), "max": round(w[-1], 1),
                 "n": len(w)} if w else None)

    return {"add_voice": {
        "at_s": round(t_add, 2),
        "warm_s": round(t_done - t_add, 2) if t_done else None,
        "programs": (add_state.get("stats") or {}).get("programs"),
        "resident_before": win(0.0, t_add),
        "resident_during_warm": win(t_add, t_done if t_done else 1e9),
        "resident_after": win(t_done, 1e9) if t_done else None,
    }}


if __name__ == "__main__":
    main()
