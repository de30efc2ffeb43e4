"""Measure the batch-bucket dummy-row tax.

Counterpart of the JAX package's tools/padding_tax.py. The runtime pads a
batch's rows up to the `batch_buckets` ladder (dummy rows copy row 0), so
varying group sizes reuse a bounded set of shapes. This tool measures what
those dummy rows cost: synthesize_batch's wall (and, on the card, one
profiled call's device time) across group sizes straddling each rung
(e.g. 17 rows padded to 32), the implied waste against the ideal cost of
the real rows (interpolated between measured rungs), and the waste expected
over serving_sim's group sizes.

On the card the shapes compile nothing: what a rung costs is its rows'
device work and cuDNN's first-run heuristics, paid in the warm-up call. The
keys are the JAX tool's, plus per row `device_busy_ms` (cuda only; the
profiled call's kernels' summed time) and `expected`: serving_sim's
BatchingServer fills a group during its wait window, so at --rate req/s
and --max-wait-ms a group holds 1 + Poisson(rate * wait) rows, capped at
--max-batch; `expected.waste_pct` is the measured waste averaged over that
distribution (group sizes whose rungs were not measured are left out, and
`expected.coverage` says what share of the distribution remained).

Usage:
    python -m piper_tpu_torch.tools.padding_tax                      # the card
    python -m piper_tpu_torch.tools.padding_tax --device cpu --quality test --iters 2

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quality", default="medium")
    ap.add_argument("--factor", type=int, default=1,
                    help="utterance length factor (1 = the 14-phoneme fixture: short "
                         "prompts are where wide groups and the widest ladder gaps live)")
    ap.add_argument("--sizes", default="1,2,3,4,8,9,12,16,17,24,32,33,48,64",
                    help="real group sizes to measure (each pads to the next ladder rung)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="serving_sim's offered rate (req/s) for the expected waste")
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def group_size_pmf(rate: float, wait_ms: float, max_batch: int) -> dict:
    """{rows: probability} of a group that opens with one request and takes
    the Poisson(rate * wait) arrivals of its wait window, capped."""
    lam = rate * wait_ms / 1e3
    pmf = {}
    for k in range(max_batch - 1):
        pmf[k + 1] = math.exp(-lam) * lam ** k / math.factorial(k)
    pmf[max_batch] = max(0.0, 1.0 - sum(pmf.values()))
    return pmf


def ideal_ms(b: int, rung_ms: dict):
    """The cost of b real rows with no dummy rows: interpolated between the
    measured rungs around b; None where there are none."""
    xs = sorted(rung_ms)
    lo = max((x for x in xs if x <= b), default=None)
    hi = min((x for x in xs if x >= b), default=None)
    if lo is None or hi is None:
        return None
    return rung_ms[lo] if lo == hi else (
        rung_ms[lo] + (rung_ms[hi] - rung_ms[lo]) * (b - lo) / (hi - lo))


def waste_pct(measured: float, ideal: float) -> float:
    return 100 * (measured - ideal) / measured


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    from piper_tpu_torch import bench as bench_mod
    from piper_tpu_torch.tools import timing

    rt_args = argparse.Namespace(
        model=None, config=None, quality=args.quality, precision="highest",
        mode="fused", vocoder_precision="high", flow_precision="high",
        output_dtype="int16", device=args.device,
    )
    rt = bench_mod.get_runtime(rt_args)
    ids = (FIXTURE_IDS * args.factor)[:4096]
    ladder = rt.batch_ladder
    symbol, counters = bench_mod._vocoder_kernels(rt)

    rows = []
    for b in (int(s) for s in args.sizes.split(",")):
        bp = next((x for x in ladder if x >= b), b)
        batch = [ids] * b
        rt.synthesize_batch(batch)  # first run of this (rows, bucket): cuDNN, allocator
        wall = []
        for _ in range(max(1, args.iters)):
            t0 = time.perf_counter()
            audios = rt.synthesize_batch(batch)
            wall.append(time.perf_counter() - t0)
        ms = float(np.median(wall)) * 1e3
        audio_s = sum(len(a) for a in audios) / rt.sample_rate
        row = {
            "rows": b, "padded_to": bp,
            "dummy_rows": bp - b,
            "ms_p50": round(ms, 1),
            "ms_per_real_row": round(ms / b, 2),
            "rtf": round(audio_s / (ms / 1e3), 1),
        }
        if args.device == "cuda":
            prof = timing.profile_call(lambda: rt.synthesize_batch(batch), symbol, counters)
            row["device_busy_ms"] = round(prof["device_busy_ms"], 2)
        rows.append(row)

    # Waste model: ms(rung) is the full-rung cost; a group of b real rows
    # pays ms(rung(b)), against the ideal cost of b rows.
    rung_ms = {r["rows"]: r["ms_p50"] for r in rows if r["dummy_rows"] == 0}
    waste_rows = []
    for r in rows:
        ideal = ideal_ms(r["rows"], rung_ms)
        if r["dummy_rows"] and r["padded_to"] in rung_ms and ideal is not None:
            waste_rows.append({"rows": r["rows"], "padded_to": r["padded_to"],
                               "measured_ms": r["ms_p50"], "ideal_ms": round(ideal, 1),
                               "waste_pct": round(waste_pct(r["ms_p50"], ideal), 1)})
    pmf = group_size_pmf(args.rate, args.max_wait_ms, args.max_batch)
    known = {}
    for b in pmf:
        bp = next((x for x in ladder if x >= b), None)
        ideal = ideal_ms(b, rung_ms)
        known[b] = (waste_pct(rung_ms[bp], ideal)
                    if bp in rung_ms and ideal is not None else None)
    covered = sum(p for b, p in pmf.items() if known[b] is not None)
    expected = sum(p * known[b] for b, p in pmf.items() if known[b] is not None)

    out = {
        "metric": "padding_tax",
        "quality": args.quality,
        "phonemes_per_utt": len(ids),
        "ladder": list(ladder),
        "rows": rows,
        "waste": waste_rows,
        "expected": {"rate_req_s": args.rate, "max_wait_ms": args.max_wait_ms,
                     "max_batch": args.max_batch,
                     "mean_rows": round(sum(b * p for b, p in pmf.items()), 2),
                     "coverage": round(covered, 3),
                     "waste_pct": round(expected / covered, 2) if covered else None},
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "device": timing.card(args.device) or {"name": "cpu", "power_limit": None},
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
