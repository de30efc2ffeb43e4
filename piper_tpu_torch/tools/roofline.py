"""Roofline report of the synthesis pipeline on the port's device.

Port of tools/roofline.py, with its flags (`--device cuda|cpu` in place of
`--platform`; the card by default). It builds the runtime as the port's
bench builds it (a synthetic voice of `--quality` at full width, random
weights from seed 0, unless `--model` names a checkpoint), measures the
device's ceilings (square-GEMM TFLOP/s per tier, streaming HBM GB/s), then
times each stage alone: the encode, the flow decoder, the whole vocoder
and, unless `--no-levels`, every vocoder upsample level through
production's routing (piper_tpu_torch/utils/roofline.py). Each stage's row
holds its analytic GFLOP and GB at (`--batch`, `--phonemes`, `--frames`),
its ms (device time on the card, with its kernels per call; wall time on
the CPU), achieved TFLOP/s and GB/s, and `mfu` and `hbm_frac` against the
H100's published peaks; the report names the card and its power limit.

Usage:
    python -m piper_tpu_torch.tools.roofline                 # the card, medium voice
    python -m piper_tpu_torch.tools.roofline --batch 32 --frames 768
    python -m piper_tpu_torch.tools.roofline --device cpu --quality test --iters 3

Prints one JSON document (indented; pass --compact for one line).
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", help="real voice checkpoint (.onnx)")
    ap.add_argument("--config")
    ap.add_argument("--quality", default="medium")
    ap.add_argument("--precision", default="highest")
    ap.add_argument("--vocoder-precision", default="high")
    ap.add_argument("--flow-precision", default="high")
    ap.add_argument("--mode", default="fused")
    ap.add_argument("--output-dtype", default="int16")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--phonemes", type=int, default=128,
                    help="phoneme bucket for the encode stage")
    ap.add_argument("--frames", type=int, default=768,
                    help="frame bucket for the decode stages")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--no-levels", dest="levels", action="store_false",
                    default=True, help="skip the per-vocoder-level rows")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the runtime runs (default: the card; raises without one)")
    ap.add_argument("--compact", action="store_true")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    args = _parser().parse_args(argv)

    from piper_tpu_torch import bench as bench_mod
    from piper_tpu_torch.utils.roofline import roofline_report

    rt = bench_mod.get_runtime(args)
    report = roofline_report(rt, args.batch, args.phonemes, args.frames,
                             iters=args.iters, per_level=args.levels)
    report["platform"] = "gpu" if args.device == "cuda" else "cpu"
    report["quality"] = args.quality
    print(json.dumps(report) if args.compact else json.dumps(report, indent=2), flush=True)
    return report


if __name__ == "__main__":
    main()
