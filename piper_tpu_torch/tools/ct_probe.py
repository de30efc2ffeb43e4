"""Where does a vocoder upsampling conv-transpose's time go on a CUDA card?

Port of tools/ct_probe.py. The same flags, defaults and shapes: the medium
voice's upsample level `--level` (rates 8/8/2/2, kernels 16/16/4/4, 512
channels halving per level) at a batch of `--b` and `--frames` input frames,
weights and inputs from numpy's generator seeded 0 in the same order. It
times each piece of the conv-transpose and its alternatives:

  poly_conv_folded_out   the polyphase conv alone (F.conv1d with the phase
                         weights), output left phase-major: no interleave
  interleave_pair(2x)    the (B, r, c, q) -> (B, c, q*r) interleave in plain
                         PyTorch and its inverse: the ms is for the pair
  full_ct                the port's production conv_transpose1d
                         (F.conv_transpose1d, cuDNN on the card)
  poly_ct                conv_transpose1d_polyphase, the JAX package's
                         production lowering, with K5 as its interleave
  native_ct_lhs_dilated  the zero-stuffed input through F.conv1d with the
                         flipped weight (the counterpart of lhs_dilation)
  mosaic_interleave      K5 (csrc/interleave.cu), one interleave per call,
                         with its plain version's time beside it

The conv-transpose pieces take leaky_relu(x) as HiFi-GAN does. No piece
feeds its output back (PyTorch has no fori_loop), so there is no fold-back
reducer and no host-time correction: the time per call is the card's, the
sum of the kernels' device times under torch.profiler over `--iters` calls,
divided by `--iters`, the median of `--reps` such windows, with the median
CUDA-event time of one call beside it. `--precision` is the tier of
tier_scope (TF32 for cuDNN at "default" only). Before timing, the probe holds
poly_ct and native_ct against full_ct (max-abs) and K5 against the plain
interleave (bit-equal). It needs a CUDA device and has no other path; a
piece that fails raises.

    python -m piper_tpu_torch.tools.ct_probe [--b 32] [--frames 768]
        [--level 3] [--iters 10] [--reps 3] [--precision high]
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np

RATES = (8, 8, 2, 2)
KERNELS = (16, 16, 4, 4)
CH0 = 512
LRELU_SLOPE = 0.1  # HiFi-GAN's


class Piece(NamedTuple):
    name: str
    fn: Callable
    nbytes: int  # each input read once, each output written once
    flops: int   # the products and sums the piece's function needs
    plain: Optional[Callable] = None  # a kernel's plain version, timed beside it


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=32)
    ap.add_argument("--frames", type=int, default=768)
    ap.add_argument("--level", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--precision", default="high")
    return ap


def level_shape(level: int, frames: int) -> dict:
    """The shapes of upsample level `level` at `frames` input frames."""
    u, k = RATES[level], KERNELS[level]
    c_in = CH0 // (2 ** level)
    return {"level": level, "c_in": c_in, "c_out": c_in // 2,
            "t_in": frames * math.prod(RATES[:level]), "u": u, "k": k, "kr": -(-k // u)}


def build_pieces(b: int, frames: int, level: int, device) -> Tuple[dict, List[Piece]]:
    """The level's shapes and the probe's pieces on `device`, inputs from
    numpy's generator seeded 0 (x, the weight, the bias, then the
    interleave's input, as the JAX probe draws them)."""
    import torch
    import torch.nn.functional as F

    from piper_tpu_torch.ops.conv import (
        conv_transpose1d,
        conv_transpose1d_polyphase,
        polyphase_weight,
    )
    from piper_tpu_torch.ops.kernels.interleave import interleave, interleave_plain
    from piper_tpu_torch.ops.nn import leaky_relu

    s = level_shape(level, frames)
    c_in, c_out, t_in, u, k, kr = (s[n] for n in ("c_in", "c_out", "t_in", "u", "k", "kr"))
    rng = np.random.default_rng(0)

    def dev(a: np.ndarray):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    x = dev(rng.standard_normal((b, c_in, t_in)).astype(np.float32) * 0.3)
    wct = dev(rng.standard_normal((c_in, c_out, k)) / np.sqrt(c_in * k))
    bct = dev(rng.standard_normal((c_out,)) * 0.02)
    q = t_in + kr - 1
    y4 = dev(rng.standard_normal((b, u, c_out, q)))
    wp, _ = polyphase_weight(wct, u)
    pad = (k - u) // 2
    t_out = (t_in - 1) * u + k - 2 * pad
    wnat = wct.flip(-1).transpose(0, 1).contiguous()  # (c_out, c_in, k)

    def poly_conv():
        return F.conv1d(leaky_relu(x, LRELU_SLOPE), wp, padding=kr - 1)

    def interleave_pair():
        o = interleave_plain(y4)
        return o.reshape(b, c_out, q, u).permute(0, 3, 1, 2).contiguous()

    def full_ct():
        return conv_transpose1d(leaky_relu(x, LRELU_SLOPE), wct, bct, stride=u, padding=pad)

    def poly_ct():
        return conv_transpose1d_polyphase(leaky_relu(x, LRELU_SLOPE), wct, bct, stride=u,
                                          padding=pad)

    def native_ct():
        xs = x.new_zeros(b, c_in, (t_in - 1) * u + 1)
        xs[:, :, ::u] = leaky_relu(x, LRELU_SLOPE)
        return F.conv1d(xs, wnat, bct, padding=k - 1 - pad)

    f32 = 4
    ct_bytes = f32 * (x.numel() + wct.numel() + bct.numel() + b * c_out * t_out)
    ct_flops = 2 * b * c_in * c_out * k * t_in
    y4_bytes = 2 * f32 * y4.numel()
    pieces = [
        Piece("poly_conv_folded_out", poly_conv,
              f32 * (x.numel() + wp.numel() + b * u * c_out * q),
              2 * b * u * c_out * c_in * kr * q),
        Piece("interleave_pair(2x)", interleave_pair, 2 * y4_bytes, 0),
        Piece("full_ct", full_ct, ct_bytes, ct_flops),
        Piece("poly_ct", poly_ct, ct_bytes, ct_flops),
        Piece("native_ct_lhs_dilated", native_ct, ct_bytes, ct_flops),
        Piece("mosaic_interleave", lambda: interleave(y4), y4_bytes, 0,
              plain=lambda: interleave_plain(y4)),
    ]
    return {**s, "b": b, "q": q, "t_out": t_out}, pieces


def agreement(pieces: List[Piece]) -> dict:
    """poly_ct and native_ct against full_ct (max-abs), and K5 against its
    plain version (bit-equal, or raise), on the pieces' own inputs."""
    import torch

    by = {p.name: p for p in pieces}
    want = by["full_ct"].fn()
    errs = {}
    for name in ("poly_ct", "native_ct_lhs_dilated"):
        got = by[name].fn()
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} != full_ct's "
                                 f"{tuple(want.shape)}")
        errs[f"{name}_vs_full_ct"] = float((got - want).abs().max())
    k5 = by["mosaic_interleave"]
    if not torch.equal(k5.fn(), k5.plain()):
        raise AssertionError("mosaic_interleave differs from the plain interleave")
    errs["mosaic_interleave_equal"] = True
    return errs


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the probe; print the shapes, the agreement and one row per
    piece, and return them."""
    args = _parser().parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ct_probe: no CUDA device; this probe times the pieces on a card "
                         "and has no CPU path")
    from piper_tpu_torch.ops.kernels.precision import kernel_tier, tier_scope
    from piper_tpu_torch.tools.timing import PEAK_FLOPS, bound_ms, device_ms, event_ms

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(dev)
    shape, pieces = build_pieces(args.b, args.frames, args.level, dev)
    print(json.dumps({**shape, "what": "shapes"}), flush=True)
    # cuDNN's fp32 convs run in TF32 at "default" only (tier_scope).
    conv_rate = PEAK_FLOPS["tf32" if kernel_tier(args.precision) == "default" else "fp32"]
    rows = []
    with torch.inference_mode(), tier_scope(args.precision, dev):
        agree = {"what": "agreement", "level": args.level, "precision": args.precision,
                 **agreement(pieces)}
        print(json.dumps(agree), flush=True)
        for p in pieces:
            bound, by = bound_ms(p.nbytes, p.flops, conv_rate)
            row = {"level": args.level, "piece": p.name, "b": args.b,
                   "ms_per_call": statistics.median(
                       device_ms(p.fn, args.iters) for _ in range(args.reps)),
                   "event_ms_per_call": event_ms(p.fn, args.iters, warmup=1),
                   "bound_ms": bound, "bound_by": by, "bytes": p.nbytes, "flops": p.flops,
                   "precision": args.precision, "timer": "torch.profiler device time",
                   "device": name}
            if p.plain is not None:  # K5's plain version, also its library call
                row["plain_ms_per_call"] = statistics.median(
                    device_ms(p.plain, args.iters) for _ in range(args.reps))
                row["plain_event_ms_per_call"] = event_ms(p.plain, args.iters, warmup=1)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return {"shapes": shape, "agreement": agree, "rows": rows}


if __name__ == "__main__":
    main(sys.argv[1:])
