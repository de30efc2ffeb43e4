"""Time the folded-layout MRF kernel against the MRF and branch kernels on a
CUDA card.

Port of tools/folded_probe.py. The same cases and flags: the two narrow
vocoder levels of the medium voice at a batch of 32 (ch=32, n=16384 and
ch=64, n=4096), three branches (kernels 3/7/11, dilations 1/3/5), weights
and input from numpy's generator seeded 0, bounds at the full length. Three
ways to run the stage, each called `--iters` times per timed window:

  mrf           K3, every branch and the mean in one launch;
  per_branch    K2 once per branch, then the mean;
  folded_f{F}   K4 at fold F, with its fold and unfold (skipped where
                F*ch > 512, as on the TPU).

The time per call is the card's: the sum of the kernels' device times under
torch.profiler over the `--iters` calls, divided by `--iters`, the median of
`--reps` such windows (CUDA events around small launches would time the
host's enqueue; `event_ms_per_call`, the median CUDA-event time of one
call, gives that time beside it). One JSON line per (shape, kernel, tier).
It needs a CUDA device and has no other path; a kernel that fails raises.

    python -m piper_tpu_torch.tools.folded_probe [--b 32] [--iters 20]
        [--reps 3] [--precision high] [--shapes 32:16384,64:4096]
        [--folds 2,4] [--tile 512]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import List, Optional

import numpy as np

DILATIONS = (1, 3, 5)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--precision", default="high")
    ap.add_argument("--shapes", default="32:16384,64:4096", help="comma list of ch:n")
    ap.add_argument("--folds", default="2,4")
    ap.add_argument("--tile", type=int, default=512)
    return ap


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Run the probe; print and return one row per (shape, kernel)."""
    args = _parser().parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("folded_probe: no CUDA device; this probe times the kernels on a "
                         "card and has no CPU path")
    from piper_tpu_torch.ops.kernels.folded import resblock1_mrf_folded
    from piper_tpu_torch.ops.kernels.resblock import resblock1_branch, resblock1_mrf
    from piper_tpu_torch.tools.timing import device_ms, event_ms

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(dev)
    rng = np.random.default_rng(0)
    m = len(DILATIONS)
    rows = []

    def cuda(a: np.ndarray):
        return torch.from_numpy(a).to(dev)

    for spec in args.shapes.split(","):
        ch, n = (int(v) for v in spec.split(":"))
        x = cuda(rng.standard_normal((args.b, ch, n)).astype(np.float32) * 0.3)
        branches = []
        for k in (3, 7, 11):
            w1 = (rng.standard_normal((m, ch, ch, k)) / np.sqrt(ch * k)).astype(np.float32)
            b1 = (rng.standard_normal((m, ch)) * 0.02).astype(np.float32)
            w2 = (rng.standard_normal((m, ch, ch, k)) / np.sqrt(ch * k)).astype(np.float32)
            b2 = (rng.standard_normal((m, ch)) * 0.02).astype(np.float32)
            branches.append((cuda(w1), cuda(b1), cuda(w2), cuda(b2), k, DILATIONS))
        bounds = torch.full((args.b,), n, dtype=torch.int32, device=dev)

        def per_branch():
            ys = [resblock1_branch(x, w1, b1, w2, b2, kernel=k, dilations=d, bounds=bounds,
                                   precision=args.precision)
                  for (w1, b1, w2, b2, k, d) in branches]
            return sum(ys) / len(ys)

        cases = [("mrf", lambda: resblock1_mrf(x, branches, bounds=bounds,
                                               precision=args.precision)),
                 ("per_branch", per_branch)]
        for f in (int(v) for v in args.folds.split(",")):
            if f * ch > 512:
                continue
            cases.append((f"folded_f{f}", lambda f=f: resblock1_mrf_folded(
                x, branches, fold=f, bounds=bounds, tile=args.tile, precision=args.precision)))

        with torch.inference_mode():
            for kernel, call in cases:
                row = {"ch": ch, "n": n, "b": args.b, "kernel": kernel,
                       "ms_per_call": statistics.median(
                           device_ms(call, args.iters) for _ in range(args.reps)),
                       "event_ms_per_call": event_ms(call, args.iters, warmup=1),
                       "precision": args.precision, "timer": "torch.profiler device time",
                       "device": name}
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
