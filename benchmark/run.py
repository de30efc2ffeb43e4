"""Run one cell of the benchmark once and print its one result line.

    python3 -m benchmark.run --workload piper_high.offline --seed 7 --seconds 10 --trace 0

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
configuration in benchmark/configs/<config>.json, its traffic mix in
benchmark/traffic/<traffic>.json, the loop kind the mix names (its `loop`)
in benchmark/loops/<loop>.py, its limits in benchmark/limits/<cell>.json
and each per-layer metric's reader in benchmark/metrics/<metric>.py. The
run makes its weights and traffic from --seed, loads the voice through the
port's PiperRuntime, warms the shapes its traffic uses (set-up, up to the
window's opening: `setup_s`), measures for --seconds,
judges what the window returned against the plain reference
(reference/judge.py) and prints, as the last line of standard output, one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, with --trace 1
breakdown, and last the numbers compared beside their limits (also the
last lines of standard error).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark.core import spec as specs  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "piper_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line(device_index: int = 0) -> dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device_index}",
             "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable: {e}"
    return {"nvidia_smi": out}


def run_cell(spec: dict, cell: dict, seed: int, seconds: float, trace: bool, device: str,
             log=print) -> dict:
    """Set up, measure, judge. Returns the result object (without the
    process-level checks run.main adds). Its set-up line's `import` is the
    time from the process's start (interpreter, torch, the card's first
    touch, the port) to the end of its imports; `window_start` is what
    the loop does between its prepare and the window's opening (a served
    mix's lead-in, an offline job's first batch)."""
    from benchmark.core import weights
    from benchmark.reference import judge

    config = specs.config(cell["config"])
    mix = specs.mix(cell["traffic"])
    kind = specs.loop(mix["loop"])
    hp = config["hparams"]
    import torch

    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
    phases = {"import": time.perf_counter() - T_START}
    t = time.perf_counter()
    if device == "cuda":
        from piper_tpu_torch.ops.kernels import build

        build.load()
    phases["build"] = time.perf_counter() - t
    t = time.perf_counter()
    host_weights = weights.draw(hp, seed, device, config["pace_seed"])
    model, cfg = weights.write_voice(specs.cache_dir() / "voices", cell["config"], hp,
                                     config["inference"], host_weights)
    phases["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    r = config["runtime"]
    # The runtime's own noise seed, which requests that bring none draw
    # from (a served cell's): the mix's, so every seed does the same work.
    options = RuntimeOptions(seed=int(mix.get("noise_seed", seed)) & 0xFFFFFFFF, **r)
    rt = PiperRuntime(model, cfg, options, device=device)
    phases["load"] = time.perf_counter() - t
    t = time.perf_counter()
    loop = kind.Loop(rt, mix, seed)
    prep = loop.prepare()
    tracer = None
    if trace:
        from benchmark.core.trace import Tracer

        tracer = Tracer(device)
        tracer.warm()
    if device == "cuda":
        torch.cuda.synchronize()
    phases["prewarm"] = time.perf_counter() - t
    log(json.dumps({"setup": {k: round(v, 6) for k, v in phases.items()},
                    "prepare": _plain(prep)}))
    t = time.perf_counter()

    w = loop.window(seconds, tracer)
    phases["window_start"] = w.t_open - t
    setup_s = w.t_open - T_START

    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if tracer is not None:
        lo, hi = w.info.get("trace_interval") or (w.t_open, w.t_close)
        w.trace = tracer.analyse(lo, hi)
        tracer.prof = None
    runtime_seed = rt.options.seed
    del loop, rt, prep
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    log(json.dumps({"setup": {k: round(v, 6) for k, v in phases.items()},
                    "setup_s": setup_s}))
    log(json.dumps({"window": _plain(w.info), "e2e": w.e2e, "counters": w.counters,
                    "memory_peak_bytes": peak}))

    ref = judge.Reference(hp, config["inference"], host_weights, device)
    kind.judged(ref, w.rows, runtime_seed)
    t = time.perf_counter()
    sample = kind.sample(w.rows, mix, seed)
    verdict = judge.judge(ref, w.rows, sample)
    verdict["seconds"] = time.perf_counter() - t
    del ref
    limits = specs.limits(cell["name"])
    checks = {k: {"value": v, "limit": limits[k]} for k, v in verdict["numbers"].items()}
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and w.failed == 0 and verdict["rows_missing"] == 0
               and verdict["rows_ragged"] == 0 and verdict["audio_rows"] > 0)
    log(json.dumps({"judge": {k: v for k, v in verdict.items() if k != "numbers"}}))

    names = specs.cell_metrics(spec, cell["name"], trace)
    metrics = {}
    if trace:
        ctx = specs.Context(config=config, mix=mix, window=w, trace=w.trace)
        for m in names:
            value = specs.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in names:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"].split(".")[0] in w.e2e:
                # "<quantity>[.<qualifier>]": a quantity the loop measures,
                # qualified where a later cell holds it to a bound of its own
                metrics[m["name"]] = {"value": w.e2e[m["name"].split(".")[0]], "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": w.attempted, "failed": w.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and w.trace is not None:
        result["device"]["busy_s"] = w.trace["busy_s"]
        result["device"]["window_s"] = w.trace["window_s"]
        ops = sorted(w.trace["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                               "idle_gaps": [[k, v] for k, v in w.trace["idle_gaps"]]}
        log(json.dumps({"trace": {"lost_head": w.trace["lost_head"],
                                  "kernels": len(w.trace["kernel_s"])}}))
    result["checks"] = checks
    return result


def _plain(x):
    return json.loads(json.dumps(x, default=lambda o: repr(o)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = specs.load()
    cell = specs.cell(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    try:
        import piper_tpu_torch.engine.runtime  # noqa: F401 - the program under test
    except ImportError as e:
        print(f"benchmark: the port is not in this checkout: {e}", file=sys.stderr)
        return 4
    print(json.dumps({"card": torch.cuda.get_device_name(0), **card_line(0)}), flush=True)
    result = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      log=lambda s: print(s, flush=True))
    print(json.dumps(card_line(0)), flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {bad}: the port's run must not load JAX or the "
              f"JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
