"""Where does the bench's serving batch spend its device time, stage by stage?

For each voice configuration (medium at the bench's mixed tiers, medium at
fp32, x_low at fp32), built as the port's bench builds its runtime: one
profiled `synthesize_batch` of the bench's B=32 batch of f=8 phrases (its
device kernels and device busy time, tools/timing.py's sentinels; the
unprofiled wall of 5 more), then `utils/roofline.py::roofline_report` at
B=32 at that batch's own (phoneme bucket, frame bucket) and at the JAX
package's defaults (128, 768), every level's row. The stage sum (encode +
flow + vocoder) is read against the profiled batch: the rows charge the
whole frame bucket on every row, the batch's rows end where their frames
do (K2, K3 and K1 skip the dead tiles, cuDNN does not). The card only.

    python -m piper_tpu_torch.tools.layer_split [--configs medium_mixed,medium_fp32,x_low_fp32]
        [--batch 32] [--iters 8] [--out DIR]

`medium_bf16` (the bench's `--precision bfloat16`: bf16 weights and
activations, the kernels at "default") is a configuration to name in
`--configs`, profiled as a batch only.

Prints one JSON line per batch profile and per report, and writes each
configuration's whole record to DIR/<config>.json.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path
from typing import List, Optional

CONFIGS = {"medium_mixed": ["--quality", "medium"],
           "medium_fp32": ["--quality", "medium", "--vocoder-precision", "none",
                           "--flow-precision", "none"],
           "x_low_fp32": ["--quality", "x_low", "--vocoder-precision", "none",
                          "--flow-precision", "none"]}
# Named in --configs only, and profiled as a batch only (utils/roofline's
# stage drivers feed fp32 activations): the bench's bfloat16 capacity tier
# on medium.
OPT_IN_CONFIGS = {"medium_bf16": ["--quality", "medium", "--precision", "bfloat16"]}
JAX_DEFAULTS = (128, 768)  # the (P, T) of the root bench's --roofline


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--out", default="build/layer_split")
    return ap


def profile_batch(rt, batch) -> dict:
    """One synthesize_batch under torch.profiler (after two warm-ups):
    the buckets, the real frames, the device kernels and busy ms, and the
    top kernels by device time; the unprofiled wall of 5 more calls."""
    from piper_tpu_torch.tools.timing import SENTINEL, device_kernels, profiled

    rt.synthesize_batch(batch)
    rt.synthesize_batch(batch)
    t = rt.last_run_timings
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        rt.synthesize_batch(batch)
        walls.append((time.perf_counter() - t0) * 1e3)
    for _ in range(5):  # a window that lost its sentinels is profiled again
        events = profiled(lambda: rt.synthesize_batch(batch))
        if events is not None:
            break
    else:
        raise RuntimeError("layer_split: 5 profiled windows of the batch lost their sentinels")
    kernels, us = device_kernels(events)
    top = sorted(((e.key, e.count, getattr(e, "device_time_total", 0) / 1e3) for e in events
                  if e.device_type.name == "CUDA" and SENTINEL not in e.key),
                 key=lambda r: -r[2])[:30]
    return {"p_bucket": t.phoneme_bucket, "f_bucket": t.frame_bucket, "frames": t.frames,
            "device_kernels": kernels, "device_busy_ms": us / 1e3,
            "wall_ms_median": statistics.median(walls), "wall_ms": walls, "top_kernels": top}


def main(argv: Optional[List[str]] = None) -> dict:
    args = _parser().parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("layer_split: no CUDA device; this tool measures the card and has "
                         "no CPU path")
    from piper_tpu_torch import bench
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.tools.timing import card
    from piper_tpu_torch.utils import roofline as rl

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    ceilings = rl.measure_ceilings()
    print(json.dumps({"ceilings": ceilings, "peaks": rl.published_peaks(),
                      "device": card("cuda")}), flush=True)
    batch = [(FIXTURE_PHONEME_IDS * 8)[:4096]] * args.batch
    records = {}
    for name in args.configs.split(","):
        rt = bench.get_runtime(bench._parser().parse_args({**CONFIGS, **OPT_IN_CONFIGS}[name]))
        prof = profile_batch(rt, batch)
        print(json.dumps({"config": name, "batch_profile": {
            k: v for k, v in prof.items() if k != "top_kernels"}}), flush=True)
        reports = {}
        shapes = [] if name in OPT_IN_CONFIGS else [(prof["p_bucket"], prof["f_bucket"]),
                                                     JAX_DEFAULTS]
        for p, t in shapes:
            rep = rl.roofline_report(rt, args.batch, p, t, iters=args.iters, ceilings=ceilings)
            st = {s["stage"]: s["ms"] for s in rep["stages"]}
            rep["stage_sum_ms"] = st["encode(enc+dp)"] + st["flow"] + st["vocoder"]
            reports[f"{p}x{t}"] = rep
            print(json.dumps({"config": name, "P": p, "T": t,
                              "stage_sum_ms": rep["stage_sum_ms"], "stages": [
                                  {k: s[k] for k in ("stage", "ms", "kernels", "gflops", "gb",
                                                     "mfu", "hbm_frac", "tier")}
                                  for s in rep["stages"]]}), flush=True)
        records[name] = {"batch_profile": prof, "reports": reports}
        (out / f"{name}.json").write_text(json.dumps(records[name], indent=1))
        rt.close()
        del rt
        torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
