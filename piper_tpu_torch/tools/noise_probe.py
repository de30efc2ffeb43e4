"""Time the seeded noise draw on a CUDA card, and count the kernels of the
seeded paths that draw it.

`--draws`: JAX's threefry normals (`ops/kernels/prng.py::threefry_normal`)
at the main path's shapes: `prior`, one (192, F) row of the prior at the
frame bucket F (`--frames`, 256 by default: medium at f=8), one seed; and
`stream_rows`, per_row_frame_noise's (4, 192, 256): four streams' windows
of 256 frames, per-row seeds and frames on the card. Each as the kernel
(`kernel_ms`, by its symbol, one a draw), its plain version (`plain_ms`,
every kernel it launches) and torch.randn of the same shape (`randn_ms`:
the card's own Philox generator, other numbers, what the port's seeded
draw cost before it drew JAX's); device time under torch.profiler
(`tools/timing.py::device_ms`), with the kernel's launches per draw. The
bound (`bound_ms`, `bound_by`) is the larger of the bytes (the output once,
seeds and frames once) at 3.35 TB/s and the 32-bit integer operations (one
threefry2x32 an element, THREEFRY_OPS + 1 with its xor, and one a derived
key) at PEAK_INT32_OPS.

`--kernels`: the device kernels of one seeded call under torch.profiler
(`timing.call_kernels`) on the synthetic medium voice (seed 0, written under
build/noise_probe_voice/) at the JAX bench's mixed tiers: synthesize of the
14-id phrase in fused mode (`medium_mixed_fused_1x1`, the bench's fused
row) and one incremental stream of the 224-id utterance
(`medium_mixed_stream_224`, the bench's `streaming` row), and among them
the threefry kernels where the tree has the kernel. It uses only public
entry points, so it counts any tree whose package is first on the path:
run it as a file with PYTHONPATH at another checkout's root.

    python -m piper_tpu_torch.tools.noise_probe [--draws] [--kernels] [--frames 256] [--reps 10]

One JSON line, with the card's name and power limit. It needs the card and
has no other path.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path
from typing import List, Optional

THREEFRY_OPS = 79  # 32-bit operations of one threefry2x32 (20 rounds, 5 injections)
THREEFRY_SYMBOL = "threefry_normal_kernel"
CHANNELS = 192  # medium's inter_channels
STREAM_ROWS, STREAM_WINDOW = 4, 256


def draw_work(rows: int, n: int, width: int, per_row: bool, frames: bool) -> tuple:
    """(bytes, 32-bit integer operations) the draw needs: the fp32 output
    written once and the seeds and frames read once; a threefry2x32 and
    its xor an element, and one threefry2x32 per key derived (the stream's
    fold per seed, the frame's fold per (seed, frame))."""
    seeds = rows if per_row else 1
    keys = seeds + (seeds * width if frames else 0)
    nbytes = 4 * rows * n * width + 8 * seeds + (8 * seeds * width if frames else 0)
    return nbytes, (THREEFRY_OPS + 1) * rows * n * width + THREEFRY_OPS * keys


def draw_cases(torch, frames: int) -> dict:
    """name -> (seed, stream, rows, n, frames tensor or None) at the main
    path's shapes, on the card."""
    dev = torch.device("cuda")
    seeds = torch.tensor([3, 2 ** 32 - 1, 2 ** 31, 77], dtype=torch.int64, device=dev)
    starts = torch.tensor([-47, 0, 100, 2 ** 20], dtype=torch.int64, device=dev)
    return {"prior": (1234, 1, 1, CHANNELS * frames, None),
            "stream_rows": (seeds, 1, STREAM_ROWS, CHANNELS,
                            starts[:, None] + torch.arange(STREAM_WINDOW, device=dev))}


def time_draws(torch, frames: int, reps: int) -> dict:
    """Per case of draw_cases: the kernel's, its plain version's and
    torch.randn's device ms, and the bound."""
    from piper_tpu_torch.ops.kernels import prng
    from piper_tpu_torch.tools.timing import PEAK_INT32_OPS, bound_ms, device_ms

    dev = torch.device("cuda")
    rows = {}
    for name, (seed, stream, r, n, fr) in draw_cases(torch, frames).items():
        width = 1 if fr is None else fr.shape[-1]
        shape = (r, n) if fr is None else (r, n, width)

        def kernel(seed=seed, stream=stream, r=r, n=n, fr=fr):
            return prng.threefry_normal(seed, stream, r, n, fr, device=dev)

        def plain(seed=seed, stream=stream, r=r, n=n, fr=fr):
            return prng.threefry_normal_plain(seed, stream, r, n, fr, device=dev)

        before = prng.threefry_normal.launches
        kernel()
        per_draw = prng.threefry_normal.launches - before
        nbytes, ops = draw_work(r, n, width, isinstance(seed, torch.Tensor), fr is not None)
        bound, by = bound_ms(nbytes, ops, PEAK_INT32_OPS)
        rows[name] = {"shape": list(shape), "launches_per_draw": per_draw,
                      "kernel_ms": device_ms(kernel, reps=reps, name=THREEFRY_SYMBOL,
                                             expected=1),
                      "plain_ms": device_ms(plain, reps=reps),
                      "randn_ms": device_ms(lambda shape=shape: torch.randn(shape, device=dev),
                                            reps=reps),
                      "bound_ms": bound, "bound_by": by, "bytes": nbytes, "int_ops": ops}
    return rows


def _voice(quality: str = "medium"):
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

    root = Path(__file__).resolve().parents[2] / "build" / "noise_probe_voice" / quality
    return make_synthetic_voice(root, quality=quality, seed=0)


def kernels_per_call(voice=None, reps: int = 4) -> dict:
    """Device kernels (and threefry kernels, where the tree has them) of
    one seeded fused 14-id synthesize and one seeded 224-id incremental
    stream, medium at the bench's mixed tiers."""
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu_torch.tools.timing import call_kernels

    model, config = voice or _voice()
    mix = dict(precision="highest", vocoder_precision="high", flow_precision="high")
    fused = PiperRuntime(model, config, RuntimeOptions(mode="fused", **mix), device="cuda")
    split = PiperRuntime(model, config, RuntimeOptions(**mix), device="cuda")
    ids224 = (FIXTURE_PHONEME_IDS * 16)[:4096]
    calls = {"medium_mixed_fused_1x1": lambda: fused.synthesize(FIXTURE_PHONEME_IDS, seed=0),
             "medium_mixed_stream_224": lambda: [c for c in split.synthesize_stream(
                 ids224, incremental=True, seed=0)]}
    name = THREEFRY_SYMBOL if importlib.util.find_spec(
        "piper_tpu_torch.ops.kernels.prng") is not None else None
    rows = {}
    for key, fn in calls.items():
        fn()  # every window size once: cuDNN's heuristics, the allocator
        kernels, threefry = call_kernels(fn, name=name, reps=reps)
        rows[key] = {"device_kernels": kernels, "threefry_kernels": threefry}
    return rows


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", action="store_true", help="time the draws")
    ap.add_argument("--kernels", action="store_true", help="count the seeded paths' kernels")
    ap.add_argument("--frames", type=int, default=256, help="the prior row's frame bucket")
    ap.add_argument("--reps", type=int, default=10)
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    args = _parser().parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("noise_probe: no CUDA device; this probe measures the card and has "
                         "no CPU path")
    import piper_tpu_torch
    from piper_tpu_torch.tools.timing import card

    out = {"probe": "noise_probe", "package": str(Path(piper_tpu_torch.__file__).parent),
           "card": card("cuda")}
    with torch.inference_mode():
        if args.draws or not args.kernels:
            out["draws"] = time_draws(torch, args.frames, args.reps)
        if args.kernels or not args.draws:
            out["kernels_per_call"] = kernels_per_call()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
