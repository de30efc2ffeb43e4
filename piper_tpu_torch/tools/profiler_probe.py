"""How often torch.profiler drops the first kernels of a window on this card,
and whether the sentinels of tools/timing.py catch every such window.

Profiles `--windows` windows of 10 calls of a plain function of 48 kernels
(one `neg`, then 47 elementwise multiplies) in two ways, in turns: bare, as
a window was opened before the sentinels, and through `timing.profiled`,
behind its sentinels. Then again with `--busy` processes spinning on the
host's cores. Card only; one JSON line:

    python -m piper_tpu_torch.tools.profiler_probe [--windows 150] [--busy 8]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
from typing import Optional, Sequence

CALLS = 10
KERNELS = 48


def _spin(stop) -> None:
    while not stop.is_set():
        sum(i * i for i in range(10000))


def _bare(run):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return prof.key_averages()


def _pass(run, windows: int) -> dict:
    """Per way of profiling: the windows that came back short (kernels lost,
    first-of-call kernels among them) and, behind the sentinels, those
    that lost every sentinel."""
    from piper_tpu_torch.tools import timing

    short = {"bare": [], "sentinels": []}
    lost_head = 0
    for _ in range(windows):
        for way in short:
            events = _bare(run) if way == "bare" else timing.profiled(run)
            if events is None:
                lost_head += 1
                continue
            total, _ = timing.device_kernels(events)
            first, _ = timing.device_kernels(events, "neg")
            if total != CALLS * KERNELS:
                short[way].append([CALLS * KERNELS - total, CALLS - first])
    return {"windows": windows, "short_bare": short["bare"],
            "sentinels_lost_head": lost_head, "short_behind_kept_sentinels": short["sentinels"]}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=150)
    ap.add_argument("--busy", type=int, default=8,
                    help="processes spinning on the host in the second pass")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe: no CUDA device")
    x0 = torch.randn(4096, device="cuda")

    def run():
        for _ in range(CALLS):
            x = torch.neg(x0)
            for _ in range(KERNELS - 1):
                x = x * 1.0001

    run()
    torch.cuda._sleep(0)
    torch.cuda.synchronize()
    out = {"kernels_per_window": CALLS * KERNELS, "idle": _pass(run, args.windows)}
    stop = mp.Event()
    procs = [mp.Process(target=_spin, args=(stop,)) for _ in range(args.busy)]
    for p in procs:
        p.start()
    try:
        out[f"{args.busy}_busy"] = _pass(run, args.windows)
    finally:
        stop.set()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
