"""The port's benchmark: the JAX bench's rows (`bench.py` at the checkout's
root, which stays the JAX package's bench) on the PyTorch/CUDA port.

    python -m piper_tpu_torch.bench [--device cuda|cpu] [--quick] [--mode fused|split] ...

Prints ONE JSON line with the root bench's keys: the headline
`{"metric": "rtf_per_chip", "value", "unit", "vs_baseline"}` (the best
batch throughput, audio seconds per wall second, and the factor-1 ms
against the reference's published Swift/Metal 147.39 ms), the factor rows
(the 14-id fixture phrase repeated f times), `throughput` (one batch of
f=8 utterances, blocking), `throughput_pipelined` (the same batches through
`ServingPipeline.submit_batch`), `batch_sweep`, `pipeline` (32 single
utterances through `ServingPipeline.submit`), `multispeaker` (a synthetic
N-speaker voice, gin 512, B rows of f=8 with speaker ids 0..B-1 mod N
through `submit_batch`: the en_US-libritts-high class, N=904 by default,
8 under --quick), `high` (the five-level `high` preset) and, unless
--quick, `streaming` (incremental streams of the 224-id fixture utterance:
time to the first chunk and to the last, p50) and `streaming_server`
(`--streams` clients, 8 by default, streaming that utterance at once
through one StreamingServer: aggregate audio seconds per wall second, TTFB
p50/p95, total p50, window rows per dispatch). `--roofline` embeds the
per-stage roofline report (`utils/roofline.py`) as the root bench does: B =
`--batch` (or 32), P = 128, T = 768, 3 iterations with --quick and 8
without, the per-level rows unless --quick; it is null without the flag.

`--device` takes `--platform`'s place: the card by default, or the CPU.
On the card the wall is launch-bound and noisy, so each factor row, the
throughput batch and the streaming rows also carry, from one call (a round
of streams for `streaming_server`) under torch.profiler after the timed
ones, the device's kernels, their summed time (`device_busy_ms`) and its
share of the row's unprofiled wall, with the voice's vocoder kernels
(K2+K3 `resblock1_kernel`, or K1 `conv1d_same`) checked against their
launch counters; the throughput rows carry `torch.cuda.max_memory_allocated`.
On the CPU those keys are null (not measured).

Correctness in the same run: where the voice has committed JAX goldens
(`piper_tpu_torch/golden/`: synthetic medium and x_low, f=1 and f=8; the
904-speaker medium voice's speaker 903 and mix {0: 0.6, 903: 0.4}, f=1), a
float32 split-mode runtime with the bench's tiers is held to them with the
goldens' injected noise: `w_ceil` equal, the waveform within 1e-4 at fp32
and 1e-3 at a lowered tier. The rows go into `golden`; an excess exits
non-zero after the line is printed.

No network: unless --model/--config point at a real voice, a synthetic
checkpoint at the preset's full widths with random weights from seed 0 is
written under the checkout's `build/bench_voices/` (or $PIPER_TPU_CACHE).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

from piper_tpu_torch import golden
from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS

ROOT = Path(__file__).resolve().parent.parent
BASELINE_MS_FACTOR1 = 147.39  # reference Swift/Metal ms_mean @ factor 1 (BASELINE.md)


class _Unset(str):
    """A stage tier the command line left at its default (argparse keeps
    the default object, so `stage_tiers` can tell it from an explicit
    value)."""


_STAGE_DEFAULT = _Unset("high")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", help="real voice checkpoint (.onnx)")
    parser.add_argument("--config", help="voice config (.onnx.json)")
    parser.add_argument("--quality", default="medium")
    parser.add_argument("--precision", default="highest",
                        choices=["highest", "high", "default", "bfloat16"])
    parser.add_argument("--factors", default="1,2,4,8")
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--mode", default="fused", choices=["split", "fused"])
    parser.add_argument("--batch", type=int, default=32,
                        help="batch size for the throughput measurement (0 = skip)")
    parser.add_argument("--batch-sweep", default="",
                        help="comma-separated batch sizes to sweep for throughput "
                             "(e.g. 16,32,64,128); headline uses the best point")
    parser.add_argument("--vocoder-precision", default=_STAGE_DEFAULT,
                        help="vocoder tier: highest/high/default, 'none' (= --precision) "
                             "or comma-separated per-level tiers (default: high; none "
                             "under --precision bfloat16, whose activations carry "
                             "'default' only)")
    parser.add_argument("--flow-precision", default=_STAGE_DEFAULT,
                        help="decode-flow tier ('none' = inherit --precision); the "
                             "encoder and duration path always run at --precision "
                             "(default: high; none under --precision bfloat16)")
    parser.add_argument("--output-dtype", default="int16", choices=["int16", "float32"],
                        help="PCM format; int16 is converted on the device")
    parser.add_argument("--pipeline", action="store_true", default=True,
                        help="measure pipelined serving throughput")
    parser.add_argument("--no-pipeline", dest="pipeline", action="store_false")
    parser.add_argument("--multi-speaker", type=int, default=904, metavar="N",
                        help="bench an N-speaker voice with batched mixed-sid serving "
                             "(the en_US-libritts-high-class config; 0 = skip)")
    parser.add_argument("--high", action="store_true", default=True,
                        help="bench the high-quality (five upsample levels) config")
    parser.add_argument("--no-high", dest="high", action="store_false")
    parser.add_argument("--roofline", action="store_true",
                        help="embed the per-stage roofline report (tools/roofline.py) in "
                             "the result JSON")
    parser.add_argument("--streams", type=int, default=8,
                        help="concurrent streaming clients for the multi-stream serving row "
                             "(0 = skip)")
    parser.add_argument("--quick", action="store_true", help="fast smoke (small sweep)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser


def stage_tiers(args):
    """(vocoder, flow) tier specs of the args: left at the default (or None,
    for args not from the parser), "high", or "none" (inherit) under
    --precision bfloat16, whose bf16 activations carry the "default" tier
    only."""
    unset = "none" if args.precision == "bfloat16" else "high"
    return tuple(unset if v is None or isinstance(v, _Unset) else v
                 for v in (args.vocoder_precision, args.flow_precision))


def get_runtime(args, quality: str = None, n_speakers: int = 1, gin: int = 0):
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions, parse_precision_spec
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

    quality = quality or args.quality
    vocoder, flow = stage_tiers(args)
    options = RuntimeOptions(
        precision=args.precision, mode=args.mode,
        vocoder_precision=parse_precision_spec(vocoder),
        flow_precision=parse_precision_spec(flow),
        output_dtype=args.output_dtype,
    )
    if args.model and quality == args.quality and n_speakers <= 1:
        return PiperRuntime(args.model, args.config, options, device=args.device)
    cache = Path(os.environ.get("PIPER_TPU_CACHE", ROOT / "build" / "bench_voices"))
    tag = quality if n_speakers <= 1 else f"{quality}-ms{n_speakers}"
    name = f"synthetic-{tag}"
    voice_dir = cache / "synthetic" / tag
    model = voice_dir / f"{name}.onnx"
    if not model.exists():
        make_synthetic_voice(voice_dir, quality=quality, seed=0, n_speakers=n_speakers,
                             gin_channels=gin, voice_name=name if n_speakers > 1 else None)
    return PiperRuntime(model, None, options, device=args.device)


def _device_info(torch, device: str) -> dict:
    from piper_tpu_torch.tools.timing import card

    return card(device) or {"name": "cpu", "power_limit": None}


def _vocoder_kernels(rt):
    """The device symbol and launch counters of the voice's vocoder kernels."""
    from piper_tpu_torch.ops.kernels import conv as K1
    from piper_tpu_torch.ops.kernels import resblock as R

    if rt.hparams.resblock == "2":
        return "conv1d_same", [K1.conv1d_same]
    return "resblock1_kernel", [R.resblock1_branch, R.resblock1_mrf]


def _profile(rt, fn, wall_ms: float) -> dict:
    """fn() once under torch.profiler on the card; null keys on the CPU."""
    if rt.device.type != "cuda":
        return {"kernels": None, "device_busy_ms": None, "busy_share": None}
    from piper_tpu_torch.tools.timing import profile_call

    symbol, counters = _vocoder_kernels(rt)
    row = profile_call(fn, symbol, counters)
    return {"kernels": row["device_kernels"], "device_busy_ms": row["device_busy_ms"],
            "busy_share": row["device_busy_ms"] / wall_ms,
            "vocoder_kernel_ms": row["kernel_ms"],
            "vocoder_kernel_launches": row["kernel_launches"]}


def _peak_memory(torch, rt, fn):
    """fn()'s result and the device's peak allocated bytes during it (None
    on the CPU)."""
    if rt.device.type != "cuda":
        return fn(), None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    return out, torch.cuda.max_memory_allocated()


def measure_throughput(runtime, bsz: int, iters: int) -> dict:
    """Batched throughput, the "per-chip" serving metric: `iters` blocking
    synthesize_batch calls of `bsz` factor-8 utterances after one warm-up
    at the timed shapes; aggregate audio seconds per wall second, the
    device's peak memory, and one profiled batch (`_profile`)."""
    import torch

    ids8 = (FIXTURE_IDS * 8)[:4096]
    batch = [ids8] * bsz
    runtime.synthesize_batch(batch)

    def timed():
        t0 = time.perf_counter()
        audio_s = 0.0
        for _ in range(iters):
            audios = runtime.synthesize_batch(batch)
            audio_s += sum(len(a) for a in audios) / runtime.sample_rate
        return audio_s, time.perf_counter() - t0

    (total_audio_s, wall), peak = _peak_memory(torch, runtime, timed)
    return {
        "batch": bsz,
        "phonemes_per_utt": len(ids8),
        "iters": iters,
        "audio_s_total": round(total_audio_s, 2),
        "wall_s": round(wall, 3),
        "rtf_throughput": round(total_audio_s / wall, 1),
        "max_memory_allocated": peak,
        **_profile(runtime, lambda: runtime.synthesize_batch(batch), wall * 1e3 / iters),
    }


def measure_throughput_pipelined(runtime, bsz: int, n_batches: int = 8, sids=None) -> dict:
    """`n_batches` batches of `bsz` factor-8 utterances through
    ServingPipeline.submit_batch, row i with speaker id sids[i] where given:
    batch i's copy and slicing overlap batch i+1's work. Warmed up with the
    exact seeds the timed loop uses (the seed changes the durations, hence
    the frame bucket)."""
    import torch

    from piper_tpu_torch.engine.pipeline import ServingPipeline

    ids8 = (FIXTURE_IDS * 8)[:4096]
    batch = [ids8] * bsz
    kw = {"speaker_ids": sids} if sids is not None else {}
    with ServingPipeline(runtime, max_inflight=4, num_fetchers=4) as pipe:
        for f in [pipe.submit_batch(batch, seed=i, **kw) for i in range(n_batches)]:
            f.result()

        def timed():
            t0 = time.perf_counter()
            futs = [pipe.submit_batch(batch, seed=i, **kw) for i in range(n_batches)]
            audio_s = sum(sum(len(a) for a in f.result()) for f in futs)
            return audio_s / runtime.sample_rate, time.perf_counter() - t0

        (total_audio_s, wall), peak = _peak_memory(torch, runtime, timed)
    return {
        "batch": bsz,
        "n_batches": n_batches,
        "audio_s_total": round(total_audio_s, 2),
        "wall_s": round(wall, 3),
        "rtf_throughput": round(total_audio_s / wall, 1),
        "max_memory_allocated": peak,
    }


def measure_streaming(runtime, iters: int) -> dict:
    """Time to first audio of incremental streaming, as the root bench
    measures it: the fixture phrase repeated to 224 ids, one warm stream
    over every window size of the growing schedule, then max(3, iters // 2)
    seeded streams, each timed to its first chunk (`ttfb`) and to its last
    (`total`); p50 of each, and one profiled stream (`_profile`)."""
    ids_long = (FIXTURE_IDS * 16)[:4096]
    for _ in runtime.synthesize_stream(ids_long, incremental=True):
        pass
    ttfbs, totals = [], []
    for i in range(max(3, iters // 2)):
        t0 = time.perf_counter()
        it = runtime.synthesize_stream(ids_long, incremental=True, seed=i)
        first = next(it)
        ttfbs.append((time.perf_counter() - t0) * 1e3)
        n = len(first.samples) + sum(len(c.samples) for c in it)
        totals.append((time.perf_counter() - t0) * 1e3)
    total_p50 = float(np.percentile(totals, 50))
    return {
        "phonemes": len(ids_long),
        "utterance_s": round(n / runtime.sample_rate, 2),
        "ttfb_ms_p50": round(float(np.percentile(ttfbs, 50)), 1),
        "total_ms_p50": round(total_p50, 1),
        **_profile(runtime, lambda: [c for c in runtime.synthesize_stream(
            ids_long, incremental=True, seed=0)], total_p50),
    }


def measure_streaming_server(runtime, streams: int) -> dict:
    """Concurrent streams, as the root bench measures them: `streams`
    clients stream the 224-id utterance at once through one StreamingServer
    (each stream's own fused head, the steady-state windows of all of them
    batched in one call a tick), prewarmed at the row rungs up to
    `streams`. One untimed warm-up round, then two timed rounds, client i
    of round r at seed 100 r + i: the aggregate audio seconds per wall
    second (median of the rounds), TTFB p50/p95 and total p50 over every
    timed stream, the window rows per dispatch in the timed rounds, and the
    last round's samples per stream; then one more round under
    torch.profiler (`_profile`). A client's error makes the row
    {"error": [...]}, as in the root bench."""
    import threading

    from piper_tpu_torch.engine.stream_server import StreamingServer

    ids_long = (FIXTURE_IDS * 16)[:4096]
    srv = StreamingServer(runtime, max_sessions=max(16, streams))

    def one_round(rnd):
        ttfbs, totals, samples = [None] * streams, [None] * streams, [None] * streams
        errs = []

        def client(i):
            try:
                t0c = time.perf_counter()
                first, n = None, 0
                for chunk in srv.submit(ids_long, seed=rnd * 100 + i):
                    if first is None:
                        first = time.perf_counter() - t0c
                    n += len(chunk.samples)
                ttfbs[i], samples[i] = first * 1e3, n
                totals[i] = (time.perf_counter() - t0c) * 1e3
            except Exception as e:  # noqa: BLE001 — report, don't crash the bench
                errs.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return ttfbs, totals, samples, time.perf_counter() - t0, errs

    try:
        rungs = [r for r in srv.row_rungs if r <= streams] or [srv.row_rungs[0]]
        srv.prewarm(phoneme_lengths=(len(ids_long),), row_rungs=rungs)
        agg, ttfb_all, total_all, walls = [], [], [], []
        m0 = None
        # Round -1 is an untimed warm-up: the first rounds with several
        # streams in flight meet shapes and allocator growth the prewarm
        # did not.
        for rnd in range(-1, 2):
            ttfbs, totals, samples, wall, errs = one_round(rnd)
            if errs:
                return {"error": errs[:3]}
            if rnd < 0:
                m0 = srv.metrics()
                continue
            agg.append(sum(samples) / runtime.sample_rate / wall)
            ttfb_all += ttfbs
            total_all += totals
            walls.append(wall * 1e3)
        m1 = srv.metrics()
        rows, dispatches = (m1[k] - m0[k] for k in ("window_rows", "window_dispatches"))
        row = {
            "streams": streams,
            "aggregate_rtf": round(float(np.median(agg)), 1),
            "ttfb_ms_p50": round(float(np.percentile(ttfb_all, 50)), 1),
            "ttfb_ms_p95": round(float(np.percentile(ttfb_all, 95)), 1),
            "total_ms_p50": round(float(np.percentile(total_all, 50)), 1),
            "phonemes": len(ids_long),
            "window_rows_per_dispatch": rows / dispatches if dispatches else None,
            "samples": samples,
        }
        row.update(_profile(runtime, lambda: one_round(2), float(np.median(walls))))
        return row
    finally:
        srv.shutdown()


def _golden_rows(args, rt, speakers: bool = False):
    """The voice against its committed JAX goldens, or None where it has
    none; with `speakers`, the multi-speaker voice against the speaker
    goldens (those exist for the 904-speaker voice only). None under
    --precision bfloat16: the capacity tier diverges audibly from fp32 by
    design, so no golden bar applies to it."""
    if args.precision == "bfloat16":
        return None
    if speakers:
        keys = ([k for k in golden.SPEAKER_GOLDENS if k[0] == args.quality]
                if args.multi_speaker == golden.N_SPEAKERS else [])
    else:
        keys = [] if args.model else [(args.quality, f, None)
                                      for f in golden.factors(args.quality)]
    if not keys:
        return None
    from piper_tpu_torch.engine.runtime import PiperRuntime

    checker = PiperRuntime(rt.model_path, rt.config_path,
                           replace(rt.options, mode="split", output_dtype="float32"),
                           device=args.device)
    return [golden.compare(checker, *key) for key in keys]


def main(argv=None) -> dict:
    """Run the bench; print its one JSON line and return it as a dict."""
    args = _parser().parse_args(argv)
    if args.quick:
        args.factors = "1,2"
        args.warmup, args.iters = 1, 2
        args.multi_speaker = min(args.multi_speaker, 8)
        args.high = False
    args.iters = max(1, args.iters)

    import torch

    from piper_tpu_torch.engine.pipeline import ServingPipeline

    device = _device_info(torch, args.device)
    rt = get_runtime(args)
    factors = [int(x) for x in args.factors.split(",")]
    rows = []
    for f in factors:
        ids = (FIXTURE_IDS * f)[:4096]
        t0 = time.perf_counter()
        for _ in range(args.warmup):  # the first call per shape pays cuDNN's heuristics
            rt.synthesize(ids)
        warm_s = time.perf_counter() - t0
        wall, rtfs = [], []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            audio = rt.synthesize(ids)
            wall.append((time.perf_counter() - t0) * 1e3)
            rtfs.append((len(audio) / rt.sample_rate) / (wall[-1] / 1e3))
        rows.append({
            "factor": f,
            "phoneme_count": len(ids),
            "ms_mean": float(np.mean(wall)),
            "ms_p50": float(np.percentile(wall, 50)),
            "ms_p95": float(np.percentile(wall, 95)),
            "rtf_mean": float(np.mean(rtfs)),
            "audio_s": len(audio) / rt.sample_rate,
            "warmup_s": warm_s,
            **_profile(rt, lambda: rt.synthesize(ids), float(np.percentile(wall, 50))),
        })

    tp_iters = max(2, args.iters // 2)
    throughput = None
    batch_sweep_rows = None
    if args.batch_sweep:
        batch_sweep_rows = [measure_throughput(rt, int(b), tp_iters)
                            for b in args.batch_sweep.split(",")]
        throughput = max(batch_sweep_rows, key=lambda r: r["rtf_throughput"])
    elif args.batch:
        throughput = measure_throughput(rt, args.batch, tp_iters)
    throughput_pipelined = None
    if throughput or args.batch:
        throughput_pipelined = measure_throughput_pipelined(
            rt, throughput["batch"] if throughput else args.batch,
            n_batches=4 if args.quick else 8)

    # Pipelined single-utterance serving (fused dispatches, fetcher pool).
    pipeline_row = None
    if args.pipeline:
        with ServingPipeline(rt, max_inflight=16, num_fetchers=8) as pipe:
            [f.result() for f in [pipe.submit(FIXTURE_IDS, seed=i) for i in range(4)]]
            n_req = 32
            t0 = time.perf_counter()
            futs = [pipe.submit(FIXTURE_IDS, seed=i) for i in range(n_req)]
            audios = [f.result() for f in futs]
            wall = time.perf_counter() - t0
        audio_s = sum(len(a) for a in audios) / rt.sample_rate
        pipeline_row = {
            "requests": n_req,
            "ms_per_utt": round(wall / n_req * 1e3, 2),
            "rtf": round(audio_s / wall, 1),
        }

    # Streaming time to first audio (incremental windowed decode), one
    # stream, then `--streams` at once through the streaming server.
    streaming_row = None if args.quick else measure_streaming(rt, args.iters)
    streaming_server_row = (measure_streaming_server(rt, args.streams)
                            if args.streams and not args.quick else None)

    # Multi-speaker batched serving (the en_US-libritts-high class: 900+
    # speaker embeddings, a batch of rows with different speaker ids),
    # always on a synthetic N-speaker voice: a --model is usually
    # single-speaker and would ignore the ids.
    multispeaker_row = ms_golden_rows = None
    if args.multi_speaker:
        rt_ms = get_runtime(args, n_speakers=args.multi_speaker, gin=512)
        bsz = max(2, args.batch or 8)
        sids = [i % args.multi_speaker for i in range(bsz)]
        row = measure_throughput_pipelined(rt_ms, bsz, n_batches=4 if args.quick else 8,
                                           sids=sids)
        batch = [(FIXTURE_IDS * 8)[:4096]] * bsz
        multispeaker_row = {
            "n_speakers": args.multi_speaker,
            "batch": bsz,
            "rtf_throughput": row["rtf_throughput"],
            "max_memory_allocated": row["max_memory_allocated"],
            **_profile(rt_ms, lambda: rt_ms.synthesize_batch(batch, speaker_ids=sids),
                       row["wall_s"] * 1e3 / row["n_batches"]),
        }
        ms_golden_rows = _golden_rows(args, rt_ms, speakers=True)
        del rt_ms

    # High-quality config (en_US-ryan-high class: five upsample levels, the
    # last at 16 channels through K3, same 22.05 kHz output).
    high_row = None
    if args.high:
        rt_high = get_runtime(args, quality="high")
        t0 = time.perf_counter()
        rt_high.synthesize(FIXTURE_IDS)  # warm-up
        warm_s = time.perf_counter() - t0
        wall = []
        for _ in range(max(2, args.iters // 2)):
            t0 = time.perf_counter()
            rt_high.synthesize(FIXTURE_IDS)
            wall.append((time.perf_counter() - t0) * 1e3)
        hi_batch = max(2, (args.batch or 8) // 2)
        hi_tp = measure_throughput_pipelined(rt_high, hi_batch, n_batches=4 if args.quick else 8)
        high_row = {
            "quality": "high",
            "num_upsamples": rt_high.hparams.num_upsamples,
            "ms_mean_factor1": round(float(np.mean(wall)), 3),
            "warmup_s": round(warm_s, 2),
            "batch": hi_tp["batch"],
            "rtf_throughput": hi_tp["rtf_throughput"],
        }
        del rt_high

    roofline = None
    if args.roofline:
        from piper_tpu_torch.utils.roofline import roofline_report

        roofline = roofline_report(rt, args.batch or 32, 128, 768,
                                   iters=3 if args.quick else 8, per_level=not args.quick)

    golden_rows = (_golden_rows(args, rt) or []) + (ms_golden_rows or []) or None

    f1 = next((r for r in rows if r["factor"] == 1), rows[0])
    serving_rows = [r for r in (throughput, throughput_pipelined) if r]
    headline_rtf = (max(r["rtf_throughput"] for r in serving_rows)
                    if serving_rows else f1["rtf_mean"])
    result = {
        "metric": "rtf_per_chip",
        "value": round(headline_rtf, 2),
        "unit": "x_realtime",
        "vs_baseline": round(BASELINE_MS_FACTOR1 / f1["ms_mean"], 2),
        "baseline_ms_factor1": BASELINE_MS_FACTOR1,
        "ms_mean_factor1": round(f1["ms_mean"], 3),
        "rtf_single_stream_factor1": round(f1["rtf_mean"], 2),
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "device": device,
        "precision": args.precision,
        "output_dtype": args.output_dtype,
        "mode": args.mode,
        "quality": args.quality,
        "compile_count": rt.last_run_timings.compile_count,
        "vocoder_precision": (None if stage_tiers(args)[0] in ("", "none")
                              else stage_tiers(args)[0]),
        "flow_precision": (None if stage_tiers(args)[1] in ("", "none")
                           else stage_tiers(args)[1]),
        "throughput": throughput,
        "throughput_pipelined": throughput_pipelined,
        "batch_sweep": batch_sweep_rows,
        "pipeline": pipeline_row,
        "streaming": streaming_row,
        "streaming_server": streaming_server_row,
        "multispeaker": multispeaker_row,
        "high": high_row,
        "roofline": roofline,
        "rows": rows,
        "golden": golden_rows,
    }
    print(json.dumps(result), flush=True)
    bad = [r for r in golden_rows or () if not r["ok"]]
    if bad:
        print(f"piper_tpu_torch.bench: the voice misses its JAX goldens: {bad}", file=sys.stderr)
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main()
