"""Where does a late vocoder level's time go: conv-transpose, MRF or leaky ReLU?

Port of tools/level_probe.py. The same flags, defaults and shapes: the
medium voice's upsample level `--level` (rates 8/8/2/2, kernels 16/16/4/4,
512 channels halving per level) at a batch of `--b` and the `--frames`
decode bucket, weights and inputs from numpy's generator seeded 0 in the
same order. It times four pieces of the level at `--precision`:

  lrelu_only            leaky_relu(x, 0.1) on the level's input
  lrelu+conv_transpose  the level's upsampling, F.conv_transpose1d (cuDNN on
                        the card) of leaky_relu(x)
  mrf_fused             the whole MRF stage through K3, the port's
                        ops/kernels/resblock.py::resblock1_mrf, rows live
                        to the end
  whole_level           the conv-transpose, then K3

A piece's time is its device time on the card (torch.profiler,
tools/timing.py::device_ms, with the kernels one call launches required in
every window and printed beside it), the median of `--reps` windows of
`--iters` calls; on the CPU (`--device cpu`, where the kernel wrapper runs
its plain version) the wall clock. No piece feeds its output back, so there
is no fold-back reducer and no host-time correction. Where K3 refuses the
level's channels (it takes C a multiple of 16 whose buffers fit the block's
shared memory), the piece prints its error line, as the JAX probe does; it
never falls back to the plain version. One JSON line per piece.

    python -m piper_tpu_torch.tools.level_probe [--b 32] [--frames 768]
        [--level 3] [--iters 10] [--reps 3] [--precision high] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import List, Optional

import numpy as np

RATES = (8, 8, 2, 2)
KERNELS = (16, 16, 4, 4)
CH0 = 512
LRELU_SLOPE = 0.1  # HiFi-GAN's
DILATIONS = (1, 3, 5)
BRANCH_KERNELS = (3, 7, 11)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=32)
    ap.add_argument("--frames", type=int, default=768)
    ap.add_argument("--level", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--precision", default="high")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def build(b: int, frames: int, level: int, dev):
    """(shapes, x, (wct, bct), z, branches, bounds) of the level, drawn as
    the JAX probe draws them."""
    import torch

    t_in = frames
    for r in RATES[:level]:
        t_in *= r
    c_in = CH0 // (2 ** level)
    c_out = c_in // 2
    u, k = RATES[level], KERNELS[level]
    n_out = t_in * u
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    x = put(rng.standard_normal((b, c_in, t_in)).astype(np.float32) * 0.3)
    wct = put(rng.standard_normal((c_in, c_out, k)) / np.sqrt(c_in * k))
    bct = put(rng.standard_normal((c_out,)) * 0.02)
    z = put(rng.standard_normal((b, c_out, n_out)).astype(np.float32) * 0.3)
    m = len(DILATIONS)
    branches = []
    for kk in BRANCH_KERNELS:
        w1 = rng.standard_normal((m, c_out, c_out, kk)) / np.sqrt(c_out * kk)
        b1 = rng.standard_normal((m, c_out)) * 0.02
        w2 = rng.standard_normal((m, c_out, c_out, kk)) / np.sqrt(c_out * kk)
        b2 = rng.standard_normal((m, c_out)) * 0.02
        branches.append((put(w1), put(b1), put(w2), put(b2), kk, DILATIONS))
    bounds = torch.full((b,), n_out, dtype=torch.int32, device=dev)
    shapes = {"level": level, "b": b, "c_in": c_in, "c_out": c_out, "t_in": t_in,
              "n_out": n_out, "u": u, "k": k}
    return shapes, x, (wct, bct), z, branches, bounds


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Run the probe: print the shapes, then one JSON line per piece, and
    return the piece lines."""
    args = _parser().parse_args(argv)
    import torch

    from piper_tpu_torch.ops.conv import conv_transpose1d
    from piper_tpu_torch.ops.kernels.precision import tier_scope
    from piper_tpu_torch.ops.kernels.resblock import resblock1_mrf
    from piper_tpu_torch.ops.nn import leaky_relu

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("level_probe: no CUDA device (pass --device cpu for the CPU)")
    dev = torch.device(args.device)
    shapes, x, (wct, bct), z, branches, bounds = build(args.b, args.frames, args.level, dev)
    u, k = shapes["u"], shapes["k"]
    print(json.dumps({**shapes, "precision": args.precision, "device": args.device,
                      "what": "shapes"}), flush=True)

    def conv_t(y):
        return conv_transpose1d(leaky_relu(y, LRELU_SLOPE), wct, bct, stride=u,
                                padding=(k - u) // 2)

    def mrf(y):
        return resblock1_mrf(y, branches, bounds=bounds, slope=LRELU_SLOPE,
                             precision=args.precision)

    pieces = (("lrelu_only", lambda: leaky_relu(x, LRELU_SLOPE)),
              ("lrelu+conv_transpose", lambda: conv_t(x)),
              ("mrf_fused", lambda: mrf(z)),
              ("whole_level", lambda: mrf(conv_t(x))))
    rows = []
    with torch.inference_mode(), tier_scope(args.precision, dev):
        for name, fn in pieces:
            try:
                row = {"piece": name, "level": args.level, **_time(fn, args, dev)}
            except ValueError as e:  # K3 refuses the level's shapes
                row = {"piece": name, "error": f"{type(e).__name__}: {e}"[:300]}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def _time(fn, args, dev) -> dict:
    """{"ms_per_call", "kernels"}: the median of `reps` device-time windows of
    `iters` calls with the call's kernels required (the card), or the wall
    clock (the CPU, kernels None)."""
    from piper_tpu_torch.utils.roofline import wall_s

    if dev.type != "cuda":
        return {"ms_per_call": wall_s(fn, args.iters) * 1e3, "kernels": None,
                "timer": "wall clock"}
    from piper_tpu_torch.tools.timing import call_kernels, device_ms

    kernels, _ = call_kernels(fn, reps=2)
    ms = statistics.median(device_ms(fn, reps=args.iters, expected=kernels)
                           for _ in range(args.reps))
    return {"ms_per_call": ms, "kernels": kernels, "timer": "torch.profiler device time"}


if __name__ == "__main__":
    main()
