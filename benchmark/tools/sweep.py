"""An open-loop mix's rate sweep, once, on the card, before its cell is
added: a configuration's voice and the mix at each rate in turn (a fresh server, prewarmed, the mix's lead-in, then
`--seconds` of arrivals), one JSON line per rate with its latency
percentiles, sheds and failures, how late the generator ran, and the
median latency of the requests due in the window's first and second
halves (a backlog that grows through the window shows as the second above
the first). The sustained rate is the highest whose p99 stays within 1 s with
nothing shed or failed; the cell runs at about four fifths of it.

    python3 -m benchmark.tools.sweep --config piper_high --traffic served --rates 120,160,200
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from benchmark.core import spec as specs
    from benchmark.core import weights

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=4242)
    args = ap.parse_args(argv)
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions

    config, mix = specs.config(args.config), specs.mix(args.traffic)
    hp = config["hparams"]
    model, cfg = weights.write_voice(specs.cache_dir() / "voices", args.config, hp,
                                     config["inference"], weights.draw(hp, args.seed, "cuda", config["pace_seed"]))
    r = config["runtime"]
    rt = PiperRuntime(model, cfg, RuntimeOptions(seed=int(mix.get("noise_seed", args.seed)) & 0xFFFFFFFF, **r))
    kind = specs.loop(mix["loop"])
    for rate in [float(x) for x in args.rates.split(",")]:
        loop = kind.Loop(rt, dict(mix, rate=rate), args.seed)
        loop.prepare()
        t = time.perf_counter()
        w = loop.window(args.seconds)
        print(json.dumps({"rate": rate, **w.info, **w.e2e, "failed": w.failed,
                          "attempted": w.attempted, **w.counters,
                          "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
