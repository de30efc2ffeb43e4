"""Multi-session bench protocol: the median of fresh processes.

Counterpart of the JAX package's tools/bench_sessions.py. A bench's walls
move 1.5-2x between calls on the H100 (PERF.md §2), so one run is no A/B.
This tool runs `python -m piper_tpu_torch.bench` N times, each in a
FRESH process (a new CUDA context, weights uploaded again, the kernels'
library loaded from `build/piper_tpu_torch/`: built by the first session
if it is not there yet, the counterpart of JAX's warm persistent jit
cache after session 1), and reports the per-metric median and spread.

Usage:
    python -m piper_tpu_torch.tools.bench_sessions --sessions 3 -- --batch 32 --no-high

Everything after `--` is forwarded to the bench. Prints one JSON line with
the JAX tool's keys: {"metric": "rtf_per_chip_median", "value", "unit",
"sessions", "spread": [min, max] of rtf_per_chip, "median": the median of
every numeric leaf of the sessions' lines, "all": the lines}. Each session's
line names its card (`device`), so "all" carries the card's name and power
limit; compare sessions of one call only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

REPO_ROOT = Path(__file__).resolve().parents[2]


def _median_paths(results):
    """Median of every numeric leaf across session dicts (missing keys skipped)."""
    def walk(vals):
        ref = next((v for v in vals if v is not None), None)
        if isinstance(ref, dict):
            keys = {k for v in vals if isinstance(v, dict) for k in v}
            return {k: walk([v.get(k) if isinstance(v, dict) else None for v in vals])
                    for k in sorted(keys)}
        if isinstance(ref, (int, float)) and not isinstance(ref, bool):
            nums = [v for v in vals if isinstance(v, (int, float))
                    and not isinstance(v, bool)]
            return round(statistics.median(nums), 3) if nums else None
        return ref  # strings/lists: first session's value
    return walk(results)


def main(argv=None, bench_cmd: Optional[Sequence[str]] = None) -> int:
    """Run the sessions and print the line; 1 when none succeeded.
    `bench_cmd` replaces the bench's command (the forwarded arguments are
    appended to it)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--" in argv:
        split = argv.index("--")
        own, fwd = argv[:split], argv[split + 1:]
    else:
        own, fwd = argv, []
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sessions", type=int, default=3)
    parser.add_argument("--timeout", type=int, default=3600,
                        help="per-session timeout (seconds)")
    args = parser.parse_args(own)

    cmd = list(bench_cmd or [sys.executable, "-m", "piper_tpu_torch.bench"])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO_ROOT), env.get("PYTHONPATH"))
                                        if p)
    results = []
    for i in range(args.sessions):
        proc = subprocess.run([*cmd, *fwd], capture_output=True, text=True,
                              timeout=args.timeout, cwd=REPO_ROOT, env=env)
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        try:
            results.append(json.loads(line))
        except json.JSONDecodeError:
            print(f"session {i}: bench failed (rc={proc.returncode}): "
                  f"{proc.stderr.strip()[-500:]}", file=sys.stderr)
    if not results:
        print(json.dumps({"sessions": 0, "error": "no successful sessions"}))
        return 1

    rtfs = [r.get("value") for r in results if isinstance(r.get("value"), (int, float))]
    print(json.dumps({
        "metric": "rtf_per_chip_median",
        "value": round(statistics.median(rtfs), 2) if rtfs else None,
        "unit": "x_realtime",
        "sessions": len(results),
        "spread": [min(rtfs), max(rtfs)] if rtfs else None,
        "median": _median_paths(results),
        "all": results,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
