"""Concurrent-stream serving benchmark (engine/stream_server.py).

Counterpart of the JAX package's tools/streaming_bench.py, on the port's
StreamingServer. Measures what N simultaneous streaming clients see:
per-stream time to first audio and the total, and the aggregate realtime
factor the card sustains while every client streams: the full protocol
behind the bench's `streaming_server` row.

Protocol: build the synthetic voice, prewarm the (bucket x rung) shape grid
(on the card a first-seen shape pays cuDNN's heuristics and the allocator's
growth, not a compile), then for each round launch N client threads that
each stream one utterance to completion; the round is timed wall to wall
from the first submit to the last final chunk. Compare runs only within
one call (the wall moves between calls). `--ab-heads` re-runs the same
workload with batched heads off (head_rungs=(1,)) in the SAME process: an
A/B of burst-TTFB head batching on one card.

The keys are the JAX tool's. The JAX tool also prints each round's line as
it ends; here the rounds are only in the summary's "rows", so the tool
prints one JSON line, which names the card (`device`).

Usage:
    python -m piper_tpu_torch.tools.streaming_bench --streams 8 --rounds 3
    python -m piper_tpu_torch.tools.streaming_bench --streams 8 --ab-heads
    python -m piper_tpu_torch.tools.streaming_bench --device cpu --quality test --quick
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np


def run_config(rt, ids, args, head_rungs=None, label="batched_heads") -> dict:
    from piper_tpu_torch.engine.stream_server import StreamingServer

    sr = rt.sample_rate
    srv = StreamingServer(
        rt,
        **({"emit_frames": args.emit_frames} if args.emit_frames is not None else {}),
        **({"c0": args.c0} if args.c0 is not None else {}),
        **({"head_rungs": head_rungs} if head_rungs is not None else {}),
        max_sessions=max(64, args.streams),
    )
    try:
        cover = next((r for r in srv.row_rungs if r >= args.streams), srv.row_rungs[-1])
        rungs = [r for r in srv.row_rungs if r <= cover]
        h_rungs = [r for r in srv.head_rungs if r <= cover]
        t0 = time.perf_counter()
        warm = srv.prewarm(phoneme_lengths=(args.phonemes,), row_rungs=rungs,
                           head_rungs=h_rungs)
        prewarm_s = time.perf_counter() - t0
        rows = [r for rnd in range(-args.warmup_rounds, args.rounds)
                if (r := _round(srv, ids, args, rnd, sr)) is not None and rnd >= 0]
        m = srv.metrics()
    finally:
        srv.shutdown()
    return {
        "metric": "streaming_server_aggregate_rtf",
        "config": label,
        "value": (round(float(np.median([r["aggregate_rtf"] for r in rows])), 1)
                  if rows else 0.0),
        "unit": "x_realtime",
        "streams": args.streams,
        "phonemes": args.phonemes,
        "emit_frames": srv.emit_frames,
        "arrival_rate": args.arrival_rate,
        "quality": args.quality,
        "prewarm_s": round(prewarm_s, 1),
        "prewarm_programs": warm.get("programs"),
        "ttfb_ms_p50": (round(float(np.median([r["ttfb_ms_p50"] for r in rows])), 1)
                        if rows else None),
        "ttfb_ms_p95": (round(float(np.median([r["ttfb_ms_p95"] for r in rows])), 1)
                        if rows else None),
        "window_rows": m["window_rows"],
        "window_dispatches": m["window_dispatches"],
        "padded_rows": m["padded_rows"],
        "head_dispatches": m["head_dispatches"],
        "head_rows": m["head_rows"],
        "padded_head_rows": m["padded_head_rows"],
        "rows": rows,
    }


def _round(srv, ids, args, rnd: int, sr: int):
    """One round of N client threads; its row, or None (with the errors
    printed to stderr) when a client failed."""
    ttfbs, totals, samples, errors = [], [], [], []
    lock = threading.Lock()

    def client(i):
        try:
            t_start = time.perf_counter()
            n, first = 0, None
            for chunk in srv.submit(ids, seed=rnd * 1000 + i):
                if first is None:
                    first = time.perf_counter() - t_start
                n += len(chunk.samples)
            total = time.perf_counter() - t_start
            with lock:
                ttfbs.append(first * 1e3)
                totals.append(total * 1e3)
                samples.append(n)
        except Exception as e:  # noqa: BLE001 - a client's failure is reported, not raised
            with lock:
                errors.append(repr(e))

    t_round = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(args.streams)]
    rng = np.random.default_rng(abs(rnd) + 1)
    for t in threads:
        t.start()
        if args.arrival_rate:
            # Poisson arrivals instead of a simultaneous burst: TTFB of a
            # lone arrival joining live traffic.
            time.sleep(float(rng.exponential(1.0 / args.arrival_rate)))
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_round
    if errors or not samples:
        print(json.dumps({"error": errors[:3], "round": rnd}), file=sys.stderr)
        return None
    audio_s = sum(samples) / sr
    return {
        "round": rnd,
        "streams": args.streams,
        "wall_s": round(wall, 3),
        "audio_s": round(audio_s, 2),
        "aggregate_rtf": round(audio_s / wall, 1),
        "per_stream_rtf": round(audio_s / args.streams / (np.median(totals) / 1e3), 1),
        "ttfb_ms_p50": round(float(np.median(ttfbs)), 1),
        "ttfb_ms_p95": round(float(np.percentile(ttfbs, 95)), 1),
        "total_ms_p50": round(float(np.median(totals)), 1),
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--warmup-rounds", type=int, default=1,
                    help="untimed rounds before measurement")
    ap.add_argument("--phonemes", type=int, default=224)
    ap.add_argument("--emit-frames", type=int, default=None,
                    help="steady-state window frames (default: the server's, 512)")
    ap.add_argument("--c0", type=int, default=None)
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="streams/second Poisson arrivals (0 = the default simultaneous "
                         "burst)")
    ap.add_argument("--head-rungs", default=None,
                    help="comma-separated batched-head rung ladder ('1' = solo heads)")
    ap.add_argument("--ab-heads", action="store_true",
                    help="after the main run, re-run the same workload with solo heads "
                         "(head_rungs=1) in the same process")
    ap.add_argument("--ab-rungs", default=None,
                    help="semicolon-separated head-rung caps to A/B in one process "
                         "(e.g. '8;16')")
    ap.add_argument("--quality", default="medium")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--precision", default=None)
    ap.add_argument("--mode", default=None)
    ap.add_argument("--vocoder-precision", default=None)
    ap.add_argument("--flow-precision", default=None)
    ap.add_argument("--output-dtype", default=None)
    ap.add_argument("--model", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="2 streams, 1 round, short utterance")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    if args.quick:
        args.streams, args.rounds, args.phonemes = 2, 1, 56
        args.warmup_rounds = 0

    from piper_tpu_torch import bench as bench_mod
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
    from piper_tpu_torch.tools.timing import card

    # the bench's serving defaults where unset
    for name, default in (("precision", "highest"), ("mode", "fused"),
                          ("output_dtype", "int16")):
        if getattr(args, name) is None:
            setattr(args, name, default)
    rt = bench_mod.get_runtime(args)
    ids = (FIXTURE_IDS * (-(-args.phonemes // len(FIXTURE_IDS))))[: args.phonemes]
    device = card(args.device) or {"name": "cpu", "power_limit": None}

    if args.ab_rungs:
        runs = []
        for cap in (int(c) for c in args.ab_rungs.split(";")):
            ladder = [r for r in (1, 2, 4, 8, 16, 32) if r <= cap]
            runs.append(run_config(rt, ids, args, head_rungs=ladder, label=f"head_cap_{cap}"))
        summary = {"metric": runs[0]["metric"], "value": runs[0]["value"],
                   "unit": runs[0]["unit"], "ab": runs}
    else:
        rungs = [int(r) for r in args.head_rungs.split(",")] if args.head_rungs else None
        summary = run_config(rt, ids, args, head_rungs=rungs)
        if args.ab_heads:
            solo = run_config(rt, ids, args, head_rungs=[1], label="solo_heads")
            summary = {"metric": summary["metric"], "value": summary["value"],
                       "unit": summary["unit"], "ab": [summary, solo]}
    summary["device"] = device
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
