"""The two readings each limit is set from, on the card, in one process:

- the lower: the numbers the judge compares over sound runs of the program
  (each seed its own weights, traffic and window, through run.run_cell);
- the upper: the same numbers with the control in the program's place, the
  reference computed one precision below what the configuration states
  (fp32 with TF32 off -> TF32), on the traffic a run of that seed sends.

    python3 -m benchmark.tools.readings --workload piper_high.offline \
        --seeds 101,102,... --control-seeds 201,202,203 --seconds 10

One JSON line per seed, then a summary line (the largest program reading
and the smallest control reading of each number).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np


def control(cell: dict, seed: int, seconds: float, batches: int, device: str) -> dict:
    """The control's numbers for one seed."""
    import torch

    from benchmark.core import spec as specs
    from benchmark.core import weights
    from benchmark.reference import judge

    config = specs.config(cell["config"])
    mix = specs.mix(cell["traffic"])
    kind = specs.loop(mix["loop"])
    hp = config["hparams"]
    w = weights.draw(hp, seed, device, config["pace_seed"])
    rows = kind.planned_rows(mix, seed, seconds, batches)
    for r in rows:  # answered, for the sample's choice; stand_in gives the real ones
        r.pcm = np.zeros(1, np.int16)
    sample = kind.sample(rows, mix, seed)
    runtime_seed = int(mix.get("noise_seed", seed)) & 0xFFFFFFFF
    low = judge.Reference(hp, config["inference"], w, device, tf32=True)
    ref = judge.Reference(hp, config["inference"], w, device)
    kind.judged(low, rows, runtime_seed)  # its own budgets, as the program derives its own
    judge.stand_in(low, rows, sample)
    kind.judged(ref, rows, runtime_seed)
    verdict = judge.judge(ref, rows, sample)
    del low, ref
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return verdict


def main(argv=None) -> int:
    from benchmark import run
    from benchmark.core import spec as specs

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control-batches", type=int, default=24,
                    help="offline: the batches a run of the cell completes")
    args = ap.parse_args(argv)
    spec = specs.load()
    cell = specs.cell(spec, args.workload)
    device = "cuda"
    program, ctrl = {}, {}
    for s in [int(x) for x in args.seeds.split(",") if x]:
        t = time.perf_counter()
        res = run.run_cell(spec, cell, s, args.seconds, False, device, log=lambda _: None)
        nums = {k: c["value"] for k, c in res["checks"].items()}
        program[s] = nums
        print(json.dumps({"seed": s, "side": "program", "numbers": nums,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "metrics": res["metrics"], "s": time.perf_counter() - t}), flush=True)
        gc.collect()
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        t = time.perf_counter()
        v = control(cell, s, args.seconds, args.control_batches, device)
        ctrl[s] = v["numbers"]
        print(json.dumps({"seed": s, "side": "control", **v, "s": time.perf_counter() - t}),
              flush=True)
    keys = sorted({k for d in list(program.values()) + list(ctrl.values()) for k in d})
    print(json.dumps({"workload": args.workload,
                      "lower": {k: max((d[k] for d in program.values()), default=None)
                                for k in keys},
                      "upper": {k: min((d[k] for d in ctrl.values()), default=None)
                                for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
