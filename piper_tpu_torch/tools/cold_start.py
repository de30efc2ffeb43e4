"""Measure the process-start -> first-audio budget.

Counterpart of the JAX package's tools/cold_start.py. Operators need three
numbers before wiring a readiness probe:

  * warm process: a served request on a running server whose first request
    has run (the steady state, milliseconds): `warm_process_call_ms`;
  * cold process, built kernels: a restart on a machine whose kernel
    library (`build/piper_tpu_torch/`) is already built: the CUDA context,
    the imports, the weights' upload, the library's load and the first
    call's cuDNN heuristics and allocator growth (seconds):
    `cold_process_warm_cache`;
  * cold process, cold build: a first deploy, or a checkout of changed
    kernel sources: the same plus nvcc building every kernel (minutes; opt
    in with --cold-build): `cold_process_cold_cache`.

The keys are the JAX tool's. On the card the "cache" is the kernels'
library, not an XLA compilation cache: the cold-build child runs from a
temporary copy of the package, whose build directory (beside the copy) is
empty, so the child's first call builds the kernels there; the repo's own
build is not touched. `kernel_load_s` (a key of the port's) is the child's
`build.load()`: the build and the library's load, or the load alone.

Each scenario runs in a FRESH subprocess (imports, device init, weight
upload and the first call all count). The child serves by default: the
bench's serving options (fused mode, highest/high/high, int16 PCM) and
first audio through a BatchingServer submit; --raw takes a plain fp32
split-mode synthesize instead. Prints one JSON line.

    python -m piper_tpu_torch.tools.cold_start                 # built kernels + warm
    python -m piper_tpu_torch.tools.cold_start --cold-build    # adds the nvcc row
    python -m piper_tpu_torch.tools.cold_start --device cpu --quality test   # smoke
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parents[2]

_CHILD = r"""
import json, time
t0 = time.perf_counter()
from piper_tpu_torch.engine.runtime import (PiperRuntime, RuntimeOptions,
                                            parse_precision_spec)
t_import = time.perf_counter()
device = {device!r}
if device == "cuda":
    from piper_tpu_torch.ops.kernels import build
    build.load()
t_kernels = time.perf_counter()
raw = {raw!r}
options = (RuntimeOptions() if raw else RuntimeOptions(
    mode="fused", precision="highest",
    vocoder_precision=parse_precision_spec("high"),
    flow_precision=parse_precision_spec("high"),
    output_dtype="int16"))
rt = PiperRuntime({model!r}, {config!r}, options=options, device=device)
t_load = time.perf_counter()
ids = [1, 20, 0, 120, 0, 61, 0, 24, 0, 59, 0, 100, 0, 2]
if raw:
    audio = rt.synthesize(ids)
    t_first = time.perf_counter()
    audio2 = rt.synthesize(ids)
    t_second = time.perf_counter()
else:
    from piper_tpu_torch.engine.batcher import BatchingServer
    srv = BatchingServer(rt)
    audio = srv.submit(ids).result(timeout=3600)
    t_first = time.perf_counter()
    audio2 = srv.submit(ids).result(timeout=3600)
    t_second = time.perf_counter()
    srv.close()
print(json.dumps({{
    "import_s": round(t_import - t0, 2),
    "kernel_load_s": round(t_kernels - t_import, 2),
    "runtime_load_s": round(t_load - t_kernels, 2),
    "first_audio_s": round(t_first - t_load, 2),
    "start_to_first_audio_s": round(t_first - t0, 2),
    "warm_call_ms": round((t_second - t_first) * 1e3, 1),
    "samples": int(len(audio)),
}}))
"""


def run_child(model, config, device: str, root: Optional[Path] = None, timeout=3600,
              raw=False) -> dict:
    """One fresh process importing the package found under `root` (the
    repo by default); returns its line plus `subprocess_wall_s`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(root or REPO), env.get("PYTHONPATH")) if p)
    code = _CHILD.format(model=str(model), config=str(config), raw=raw, device=device)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root or REPO,
                         capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise SystemExit(f"child failed:\n{out.stderr[-2000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    rec["subprocess_wall_s"] = round(wall, 2)
    return rec


def package_copy(dest: Path) -> Path:
    """A copy of the package under `dest`, without compiled Python files,
    whose kernel build directory (dest/build/piper_tpu_torch) is empty."""
    shutil.copytree(REPO / "piper_tpu_torch", dest / "piper_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--quality", default="medium")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--raw", action="store_true",
                    help="measure plain float32 split-mode synthesize instead of the "
                         "serving configuration (int16 fused via a BatchingServer "
                         "submit, the default: what a serving restart loads)")
    ap.add_argument("--cold-build", action="store_true",
                    help="also measure a child whose kernel build directory is empty "
                         "(nvcc builds every kernel: minutes)")
    args = ap.parse_args(argv)

    import torch

    from piper_tpu_torch.tools.timing import card

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here (use --device cpu)")
    if args.model:
        model, config = args.model, args.config or f"{args.model}.json"
    else:
        # The synthetic voice is made here, so the child pays its load only.
        from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

        model, config = make_synthetic_voice(
            tempfile.mkdtemp(prefix="coldstart_"), quality=args.quality, seed=0)

    out = {"metric": "cold_start_budget", "quality": args.quality,
           "platform": "gpu" if args.device == "cuda" else "cpu",
           "device": card(args.device) or {"name": "cpu", "power_limit": None},
           "config": "raw-float32-split" if args.raw
                     else "serving-int16-fused (BatchingServer)"}
    if args.device == "cuda":
        # The built-kernels row must not pay the build: make sure it is there.
        from piper_tpu_torch.ops.kernels import build

        t0 = time.perf_counter()
        build.build()
        out["prebuild_s"] = round(time.perf_counter() - t0, 2)
    out["cold_process_warm_cache"] = run_child(model, config, args.device, raw=args.raw)
    if args.cold_build:
        with tempfile.TemporaryDirectory(prefix="piper_cold_build_") as d:
            out["cold_process_cold_cache"] = run_child(
                model, config, args.device, root=package_copy(Path(d)), raw=args.raw)
    # The warm-process number rides along in every child ("warm_call_ms").
    out["warm_process_call_ms"] = out["cold_process_warm_cache"]["warm_call_ms"]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
