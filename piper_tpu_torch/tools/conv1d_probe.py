"""Time the conv1d_same kernel (K1) at the x_low voice's shapes on a CUDA card.

The main path's K1 calls: x_low's two narrow vocoder levels at `--frames`
frames and a batch of 1 (level 1: C=64, N = 64 * frames; level 2: C=32,
N = 256 * frames), the six ResBlock2 convs of each, (k, d) = (3, 1), (3, 2),
(5, 2), (5, 6), (7, 3), (7, 12), act_slope 0.1, no bounds; weights, bias
and input from torch's generator seeded 0. Per tier and level, the device
time of the six calls under torch.profiler (`tools/timing.py::device_ms`):
the whole wrapper (`wrapper_ms`, with any weight layout it launches) and
the K1 kernels alone (`kernel_ms`, by the symbol "conv1d_same", six of
them per call or the window is profiled again). One JSON line per (tier,
level), then one with the sums over the levels.

It uses only the public `conv1d_same` wrapper, so it times any tree whose
package is first on the path: run it as a file with PYTHONPATH at another
checkout's root to time that checkout's kernel on the same card.

`--sweep` also times the kernel at every (time tile, warpgroups, weight
slots, units a slot holds) that fits every conv of the level
(`conv.configs`, with a slot of one or two units or the whole conv; a
slot's units cut to each conv's), at B=1 and at B=32, at every tier, each
held bit-equal to the wrapper's own choice (the output depends on none of
them), and lists the wrapper's choice per conv (`conv.pick_config`).

`--utterances` also profiles whole x_low utterances (the synthetic x_low
voice, seed 0, written under build/conv1d_probe_voice/ beside the package)
at the fp32 configuration and at the JAX bench's mixed one (vocoder and
flows "high"), phoneme factors 1 and 8: one utterance under torch.profiler
after the median wall of `--reps` unprofiled ones (`profile_utterance`):
device kernels, device-busy ms, and K1's kernels, ms and count (checked
against the launch counter). It needs the card and has no other path.

At every tier each level's row also gives K1 alone at a batch of 32
(`b32_kernel_ms`: 32 rows of `--b32-frames` frames, 384 by default, the
x_low serving batch's frame bucket). Beside K1 at "highest" it prints the
yardsticks: `library_ms` and `b32_library_ms`, the same function by the
library route (leaky_relu, then F.conv1d: two PyTorch calls per conv, TF32
off), and `host_tf32_layout_ms`, the device time of laying the six weights
out as the tensor cores' tf32 image on every call
(`resblock.wgmma_tf32_weights`, as K2-K4 take theirs; K1 lays its image out
once per weight tensor and tier). Beside K1 at "default" it prints
`library_bf16_ms`: the library route on bf16 operands (x, weights and bias
cast once, outside the timed calls; bf16 products summed in fp32 as K1's
"default" forms them), the one PyTorch route with that tier's arithmetic.
"high" (bf16x3) has no single-call counterpart.

    python -m piper_tpu_torch.tools.conv1d_probe [--precision highest,high,default]
        [--frames 128] [--b32-frames 384] [--reps 10] [--sweep] [--utterances]
"""

from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path
from typing import Callable, List, Optional, Sequence

X_LOW_CONVS = ((3, 1), (3, 2), (5, 2), (5, 6), (7, 3), (7, 12))
LEVELS = ((1, 64, 64), (2, 32, 256))  # (level, C, samples per frame)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--precision", default="highest,high,default")
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--b32-frames", type=int, default=384)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--utterances", action="store_true")
    return ap


def profile_utterance(rt, ids: Sequence[int], symbol: str, counters: Sequence[Callable],
                      reps: int) -> dict:
    """The median wall of `reps` unprofiled rt.synthesize(ids), then one
    under torch.profiler (`tools/timing.py::profile_call`): its device
    kernels and their summed device time (device busy), and the kernels
    whose symbol holds `symbol`, their time and count, checked against the
    launches the wrappers `counters` saw."""
    from piper_tpu_torch.tools.timing import profile_call

    walls = []
    for _ in range(reps):
        rt.synthesize(ids)
        walls.append(rt.last_run_timings.wall_ms)
    wall = statistics.median(walls)
    row = profile_call(lambda: rt.synthesize(ids), symbol, counters)
    return {**row, "ms_per_utterance": wall, "busy_share": row["device_busy_ms"] / wall}


def _utterances(torch, reps: int) -> List[dict]:
    """x_low utterances at fp32 and at the bench's mixed tiers, f = 1 and 8."""
    import piper_tpu_torch
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice
    from piper_tpu_torch.ops.kernels import conv as K1

    root = Path(piper_tpu_torch.__file__).resolve().parents[1]
    model, config = make_synthetic_voice(root / "build" / "conv1d_probe_voice", quality="x_low",
                                         seed=0)
    rows = []
    for name, opts in (("x_low", None), ("x_low_mixed", RuntimeOptions(
            precision="highest", vocoder_precision="high", flow_precision="high"))):
        rt = PiperRuntime(model, config, opts, device="cuda")
        for f in (1, 8):
            ids = FIXTURE_PHONEME_IDS * f
            rt.synthesize(ids)  # first call per shape: cuDNN heuristics, allocator
            row = {"path": name, "factor": f,
                   **profile_utterance(rt, ids, "conv1d_same", [K1.conv1d_same], reps)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def _sweep(torch, K1, x, convs, tier: str, reps: int) -> dict:
    """The kernel's (tile, warpgroups, ring, chunk) choices at one level,
    one for all six convs (a chunk cut to each conv's units), and the
    wrapper's choice per conv."""
    from piper_tpu_torch.ops.kernels.precision import tier_code
    from piper_tpu_torch.tools.timing import device_ms

    code = tier_code(tier)
    pads = [(k - 1) // 2 * d for _, _, k, d in convs]
    want = [K1.conv1d_same(x, w, bias, dilation=d, act_slope=0.1, precision=tier)
            for w, bias, k, d in convs]
    fits = [set(K1.configs(x, k, p, 4096, code)) for (_, _, k, _), p in zip(convs, pads)]
    units = [k * K1._tap_units(K1._padded(x.shape[1]), code) for _, _, k, _ in convs]

    def per_conv(config, u):
        t, g, ring, chunk = config
        chunk = min(chunk, u)
        return t, g, min(ring, -(-u // chunk)), chunk

    rows = []
    for config in sorted(set().union(*fits)):
        cfgs = [per_conv(config, u) for u in units]
        if (cfgs[-1] != config or config[3] not in (1, 2, units[-1])
                or not all(c in f for c, f in zip(cfgs, fits))):
            continue  # each config once, as the level's widest conv takes it

        def run():
            return [K1._launch(x, w, k, bias, None, d, 0.1, code, c)
                    for (w, bias, k, d), c in zip(convs, cfgs)]

        if not all(torch.equal(g, h) for g, h in zip(run(), want)):
            raise AssertionError(f"conv1d_same {tier} C={x.shape[1]} {config}: differs from "
                                 f"the wrapper's choice")
        rows.append({"tile": config[0], "warpgroups": config[1], "ring": config[2],
                     "chunk": config[3],
                     "kernel_ms": device_ms(run, reps=reps, name="conv1d_same",
                                            expected=len(convs))})
    return {"rows": rows, "chosen": [list(K1.pick_config(x, k, p, 4096, code))
                                     for (_, _, k, _), p in zip(convs, pads)]}


def _library(x, convs):
    """The level's six convs by the library route: leaky_relu, then F.conv1d."""
    import torch.nn.functional as F

    return [F.conv1d(F.leaky_relu(x, 0.1), w, b, padding=(k - 1) // 2 * d, dilation=d)
            for w, b, k, d in convs]


def _yardsticks(torch, x, x32, convs, reps: int) -> dict:
    """At "highest": the library route's device time for the level's six
    convs (TF32 off), at B=1 and at B=32, and the host tf32 layout's for
    their weights (as K2-K4 lay theirs out on every call)."""
    from piper_tpu_torch.ops.kernels.resblock import wgmma_tf32_weights
    from piper_tpu_torch.tools.timing import call_kernels, device_ms

    def layout():
        return [wgmma_tf32_weights(w[None]) for w, _, _, _ in convs]

    return {"library_ms": device_ms(lambda: _library(x, convs), reps=reps),
            "host_tf32_layout_ms": device_ms(layout, reps=reps),
            "host_tf32_layout_kernels": call_kernels(layout)[0],
            "b32_library_ms": device_ms(lambda: _library(x32, convs), reps=reps)}


def _library_bf16_ms(torch, x, convs, reps: int) -> float:
    """The device time of the level's six convs by the library route on
    bf16 operands (leaky_relu, then F.conv1d), the operands cast first."""
    import torch.nn.functional as F

    from piper_tpu_torch.tools.timing import device_ms

    xb = x.to(torch.bfloat16)
    cb = [(w.to(torch.bfloat16), b.to(torch.bfloat16), k, d) for w, b, k, d in convs]
    return device_ms(lambda: [F.conv1d(F.leaky_relu(xb, 0.1), w, b, padding=(k - 1) // 2 * d,
                                       dilation=d) for w, b, k, d in cb], reps=reps)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Run the probe; print and return one row per (tier, level) and the sums."""
    args = _parser().parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("conv1d_probe: no CUDA device; this probe times the kernel on a "
                         "card and has no CPU path")
    import piper_tpu_torch
    from piper_tpu_torch.ops.kernels import conv as K1
    from piper_tpu_torch.ops.kernels.precision import fp32_exact
    from piper_tpu_torch.tools.timing import device_ms

    gen = torch.Generator().manual_seed(0)
    levels = []
    for level, c, per_frame in LEVELS:
        convs = [((torch.randn(c, c, k, generator=gen) * (c * k) ** -0.5).cuda(),
                  (torch.randn(c, generator=gen) * 0.02).cuda(), k, d) for k, d in X_LOW_CONVS]
        x = (torch.randn(1, c, per_frame * args.frames, generator=gen) * 0.3).cuda()
        x32 = (torch.randn(32, c, per_frame * args.b32_frames, generator=gen) * 0.3).cuda()
        levels.append((level, x, x32, convs))
    rows, sums = [], {}
    with torch.inference_mode(), fp32_exact():
        for tier in args.precision.split(","):
            total = {"wrapper_ms": 0.0, "kernel_ms": 0.0, "b32_kernel_ms": 0.0}
            for level, x, x32, convs in levels:

                def call(xx=x, convs=convs):
                    return [K1.conv1d_same(xx, w, b, dilation=d, act_slope=0.1, precision=tier)
                            for w, b, k, d in convs]

                row = {"precision": tier, "level": level, "channels": x.shape[1],
                       "samples": x.shape[2], "wrapper_ms": device_ms(call, reps=args.reps),
                       "kernel_ms": device_ms(call, reps=args.reps, name="conv1d_same",
                                              expected=len(convs)),
                       "b32_samples": x32.shape[2],
                       "b32_kernel_ms": device_ms(lambda: call(x32), reps=args.reps,
                                                  name="conv1d_same", expected=len(convs))}
                if tier == "highest":
                    row.update(_yardsticks(torch, x, x32, convs, args.reps))
                    for key in ("library_ms", "b32_library_ms"):
                        total[key] = total.get(key, 0.0) + row[key]
                elif tier == "default":
                    row["library_bf16_ms"] = _library_bf16_ms(torch, x, convs, args.reps)
                    total["library_bf16_ms"] = (total.get("library_bf16_ms", 0.0)
                                                + row["library_bf16_ms"])
                if args.sweep:
                    row["sweep"] = _sweep(torch, K1, x, convs, tier, args.reps)
                    row["b32_sweep"] = _sweep(torch, K1, x32, convs, tier, args.reps)
                for key in ("wrapper_ms", "kernel_ms", "b32_kernel_ms"):
                    total[key] += row[key]
                print(json.dumps(row), flush=True)
                rows.append(row)
            sums[tier] = total
        if args.utterances:
            rows += _utterances(torch, args.reps)
    summary = {"package": piper_tpu_torch.__file__, "device": torch.cuda.get_device_name(0),
               "frames": args.frames, "b32_frames": args.b32_frames,
               "launches_per_tier": 6 * len(levels), "sums": sums}
    print(json.dumps(summary), flush=True)
    return rows + [summary]


if __name__ == "__main__":
    main()
