"""Time the ResBlock1 kernels K2 and K3 at the medium voice's shapes on a CUDA card.

The main path's K2 and K3 calls: K2 (`resblock1_branch`) at level 2, C=64,
N = 128 samples a frame, one launch per branch (k = 3, 7, 11, dilations
1/3/5); K3 (`resblock1_mrf`) at level 3, C=32, N = 256 a frame, one launch
for the three branches and their mean. Two shapes: `b1`, a batch of one
at `--frames` frames (128) whose row ends 100 samples early, as
chip_smoke.py times the kernels; and `b32`, the serving batch, `--batch`
rows (32) at the bucket's `--bucket` frames (192) whose rows end at
`--live` frames (162), as the layer split's. Weights, biases and input
from torch's generator seeded 0. Per (kernel, tier, shape), the device
time of one call under torch.profiler (`tools/timing.py::device_ms`, behind
its sentinels): the whole wrapper (`wrapper_ms`, weight layout and bounds
included, its kernels per call counted first and then required) and the
ResBlock1 kernels alone (`kernel_ms`, by the symbol "resblock1_kernel", 3
or 1 of them per call required), beside `bound_ms`, the least time the
card could take (x read and the outputs written once, the weights read
once; 2*C*C*k FLOPs per conv and live sample at the tier's peak), and the
card's name and power limit. Tiers: "highest", "high", "default" and
"bfloat16" (bf16 x, weights and biases at "default"). One JSON line per
row, then a summary.

It uses only the public wrappers, so it times any tree whose package is
first on the path: run it as a file with PYTHONPATH at another checkout's
root to time that checkout's kernels on the same card.

`--sweep` also times the kernel alone at every (time tile, weight slots,
taps a slot holds) the wgmma stage offers (`resblock.wgmma_configs`),
each held bit-equal to the wrapper's own choice (the output depends on
none of them), and names the wrapper's choice.

`--device cpu` runs each case once through the wrappers, which take their
plain versions there, and checks the outputs (shape, dtype, finite, zero
past the rows' ends): a test of the shapes and arguments, with no time.

    python -m piper_tpu_torch.tools.resblock_probe
        [--precision highest,high,default,bfloat16] [--shapes b1,b32] [--frames 128]
        [--batch 32] [--bucket 192] [--live 162] [--reps 10]
        [--sweep] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

KERNELS = (("resblock1_branch", 64, 128), ("resblock1_mrf", 32, 256))  # (name, C, per frame)
KS = (3, 7, 11)
DILATIONS = (1, 3, 5)
SYMBOL = "resblock1_kernel"
EARLY_END = 100  # b1: the row ends this many samples early (chip_smoke's timed call)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--precision", default="highest,high,default,bfloat16")
    ap.add_argument("--shapes", default="b1,b32")
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--bucket", type=int, default=192)
    ap.add_argument("--live", type=int, default=162)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def shapes(args) -> dict:
    """{shape: (rows, frames, live samples a frame-unit)}: per shape the
    batch, the frames of each row and the frames that are live, as a
    function of the samples per frame (b1 ends EARLY_END samples early)."""
    out = {}
    for name in args.shapes.split(","):
        if name == "b1":
            out[name] = (1, args.frames, lambda per: args.frames * per - EARLY_END)
        elif name == "b32":
            out[name] = (args.batch, args.bucket, lambda per: args.live * per)
        else:
            raise SystemExit(f"resblock_probe: unknown shape {name!r} (b1, b32)")
    return out


def work(c: int, n: int, rows: int, live: int, outputs: int, elem: int) -> tuple:
    """(bytes, flops) of one call: x (rows, C, n) read once, `outputs` such
    tensors written once, each branch's six convs' weights and biases read
    once, `elem` bytes a value; 2*C*C*k FLOPs per conv and live sample."""
    weights = sum(6 * (c * c * k + c) for k in KS)
    return (elem * (rows * c * n * (1 + outputs) + weights),
            sum(2 * c * c * k * 6 * live * rows for k in KS))


def _inputs(torch, gen, c: int, rows: int, n: int, device: str):
    def rand(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    branches = []
    for k in KS:
        s = (c * k) ** -0.5
        branches.append((rand(3, c, c, k, scale=s), rand(3, c, scale=0.02),
                         rand(3, c, c, k, scale=s), rand(3, c, scale=0.02), k, DILATIONS))
    return branches, rand(rows, c, n, scale=0.3)


def _call(R, name: str, x, branches, bounds, precision: str):
    """The wrapper call of one (kernel, shape): K2's three branch launches
    or K3's one."""
    if name == "resblock1_mrf":
        return lambda: [R.resblock1_mrf(x, branches, bounds=bounds, precision=precision)]
    return lambda: [R.resblock1_branch(x, *br[:4], kernel=br[4], dilations=br[5], bounds=bounds,
                                       precision=precision) for br in branches]


def _sweep(torch, R, name: str, x, branches, bounds, tier: str, want, reps: int) -> dict:
    """The kernel alone at every (tile, slots, chunk) of the wgmma stage,
    each output bit-equal to the wrapper's; the wrapper's choice per
    launch."""
    from piper_tpu_torch.tools.timing import device_ms

    code = R.tier_code(tier)
    bf16 = x.dtype == torch.bfloat16
    halos = ([R.branch_halo(k, DILATIONS) for k in KS] if name == "resblock1_branch"
             else [R.branch_halo(max(KS), DILATIONS)])
    taps = list(KS) if name == "resblock1_branch" else [max(KS)]
    chosen = [list(R._pick_tile(x, h, name == "resblock1_mrf", 256, code, k))
              for h, k in zip(halos, taps)]
    rows = []
    for i, halo in enumerate(halos):
        for config in R.wgmma_configs(x, halo, 256, code, taps[i]):
            if name == "resblock1_mrf":
                def run(config=config):
                    return [R._launch_mrf(x, branches, bounds, 0.1, code, bf16, 256, config)]
            else:
                br = branches[i]

                def run(config=config, br=br):
                    return [R._launch_branch(x, br[:4], br[4], br[5], bounds, 0.1, code, bf16,
                                             config)]
            if not torch.equal(run()[0], want[i]):
                raise AssertionError(f"{name} {tier} launch {i} (tile, ring, chunk) {config}: "
                                     f"differs from the wrapper's choice")
            rows.append({"launch": i, "tile": config[0], "ring": config[1], "chunk": config[2],
                         "kernel_ms": device_ms(run, reps=reps, name=SYMBOL, expected=1)})
    return {"rows": rows, "chosen": chosen}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Run the probe; print and return one row per (kernel, tier, shape)
    and a summary."""
    args = _parser().parse_args(argv)
    import torch

    import piper_tpu_torch
    from piper_tpu_torch.ops.kernels import resblock as R
    from piper_tpu_torch.tools.timing import TIER_FLOPS, bound_ms, call_kernels, card, device_ms

    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("resblock_probe: no CUDA device; on the CPU pass --device cpu (no "
                         "times, the plain versions' checks only)")
    info = card(args.device)
    smi = info["nvidia_smi"] if info else None
    rows, sums = [], {}
    gen = torch.Generator().manual_seed(0)
    cases = []
    for shape, (batch, frames, live_of) in shapes(args).items():
        for name, c, per in KERNELS:
            n = frames * per
            branches, x = _inputs(torch, gen, c, batch, n, args.device)
            live = live_of(per)
            bounds = torch.full((batch,), live, dtype=torch.int32, device=args.device)
            cases.append((shape, name, c, n, batch, live, branches, x, bounds))
    with torch.inference_mode():
        for tier in args.precision.split(","):
            precision = "default" if tier == "bfloat16" else tier
            for shape, name, c, n, batch, live, branches, x, bounds in cases:
                if tier == "bfloat16":
                    x = x.to(torch.bfloat16)
                    branches = [tuple(t.to(torch.bfloat16) for t in br[:4]) + br[4:]
                                for br in branches]
                call = _call(R, name, x, branches, bounds, precision)
                launches = len(KS) if name == "resblock1_branch" else 1
                nbytes, flops = work(c, n, batch, live, launches, 2 if tier == "bfloat16" else 4)
                bound, by = bound_ms(nbytes, flops, TIER_FLOPS[precision])
                row = {"kernel": name, "precision": tier, "shape": shape, "batch": batch,
                       "channels": c, "samples": n, "live_samples": live,
                       "launches_per_call": launches, "bound_ms": bound, "bound_by": by,
                       "device": torch.cuda.get_device_name(0) if on_card else "cpu",
                       "nvidia_smi": smi}
                outs = call()
                for o in outs:
                    if (o.shape != x.shape or o.dtype != x.dtype or not bool(o.isfinite().all())
                            or bool((o[:, :, live:] != 0).any())):
                        raise AssertionError(f"{name} {tier} {shape}: output {o.shape} {o.dtype}"
                                             f" not finite, or nonzero past the rows' end")
                if on_card:
                    total, named = call_kernels(call, SYMBOL)
                    if named != launches:
                        raise AssertionError(f"{name}: {named} kernels named {SYMBOL!r} per "
                                             f"call, {launches} launched")
                    row.update(wrapper_ms=device_ms(call, reps=args.reps, expected=total),
                               wrapper_kernels=total,
                               kernel_ms=device_ms(call, reps=args.reps, name=SYMBOL,
                                                   expected=launches))
                    row["kernel_bound_frac"] = bound / row["kernel_ms"]
                    if args.sweep and hasattr(R, "wgmma_configs"):
                        row["sweep"] = _sweep(torch, R, name, x, branches, bounds, precision,
                                              outs, args.reps)
                    key = f"{tier} {shape}"
                    sums.setdefault(key, {"wrapper_ms": 0.0, "kernel_ms": 0.0, "bound_ms": 0.0})
                    for k in ("wrapper_ms", "kernel_ms", "bound_ms"):
                        sums[key][k] += row[k]
                print(json.dumps(row), flush=True)
                rows.append(row)
    summary = {"package": piper_tpu_torch.__file__, "device": rows[0]["device"] if rows else None,
               "nvidia_smi": smi, "k2_plus_k3": sums}
    print(json.dumps(summary), flush=True)
    return rows + [summary]


if __name__ == "__main__":
    main()
