"""Run a pipeline-parallel (pp) decode without writing code.

Port of tools/pp_run.py, the same flags and `--check`: load a voice (a real
checkpoint or a synthetic preset), build a dp x pp mesh, synthesize a batch
through `ShardedVits.synthesize_pipelined` (parallel/pp.py: the GPipe stage
pipeline over the pp axis), optionally write row 0 as a WAV and check the
audio against the one-slot whole-graph `synthesize_batch` at the same seed
(max-abs below 1e-4, else exit 1). `--slots N` builds the mesh on N virtual
slots of the first CUDA card (or of the CPU with `--device cpu`) in place of
the JAX tool's XLA_FLAGS virtual devices; without it the mesh takes every
CUDA card. It prints one JSON line that names the card and its power limit.

    python -m piper_tpu_torch.tools.pp_run --slots 2 --check
    python -m piper_tpu_torch.tools.pp_run --model v.onnx --pp 4 --out out.wav
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="pipeline-parallel VITS decode (GPipe over the pp axis)")
    p.add_argument("--model", default=None,
                   help="voice checkpoint (.onnx with sibling .onnx.json); "
                        "omit for a synthetic --quality voice")
    p.add_argument("--config", default=None)
    p.add_argument("--quality", default="medium",
                   help="synthetic preset when --model is omitted")
    p.add_argument("--pp", type=int, default=2, help="pipeline stages")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel width (default: slots // pp)")
    p.add_argument("--batch", type=int, default=0,
                   help="rows (default: one per dp group)")
    p.add_argument("--ids", default=None, help="comma-separated phoneme ids")
    p.add_argument("--max-frames", type=int, default=256)
    p.add_argument("--microbatches", type=int, default=None)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--slots", type=int, default=0,
                   help="virtual slots of one device (default: every CUDA card)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=None, help="write row 0 as WAV here")
    p.add_argument("--check", action="store_true",
                   help="also decode on one slot and report max-abs err")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    import torch

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.parallel.mesh import make_mesh
    from piper_tpu_torch.parallel.serving import ShardedVits
    from piper_tpu_torch.tools.timing import card

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for virtual CPU slots")
    if args.slots:
        devices = [torch.device("cuda", 0) if args.device == "cuda" else "cpu"] * args.slots
    elif args.device == "cpu":
        raise SystemExit("--device cpu needs --slots N (virtual CPU slots)")
    else:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n_dev = len(devices)
    if n_dev % args.pp:
        raise SystemExit(f"{n_dev} slots not divisible by pp={args.pp} "
                         f"(virtual slots: --slots N)")
    dp = args.dp or n_dev // args.pp
    mesh = make_mesh(dp * args.pp, devices=devices, pipeline_parallel=args.pp)

    if args.model:
        from piper_tpu_torch.core.config import VoiceConfig
        from piper_tpu_torch.models.vits.hparams import derive_hparams
        from piper_tpu_torch.models.vits.params import host_arrays_from_graph
        from piper_tpu_torch.onnx import load_model

        cfg = VoiceConfig.load(args.config or f"{args.model}.json")
        m = load_model(args.model)
        hp = derive_hparams(m.graph, sample_rate=cfg.audio.sample_rate,
                            n_speakers=cfg.num_speakers)
        host = host_arrays_from_graph(m.graph)
        sample_rate = cfg.audio.sample_rate
    else:
        from piper_tpu_torch.models.vits.hparams import PRESETS
        from piper_tpu_torch.models.vits.synthetic import synthetic_params

        hp = PRESETS[args.quality]
        host = synthetic_params(hp, seed=0)
        sample_rate = hp.sample_rate
    params = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in host.items()}
    sharded = ShardedVits.create(mesh, params, hp)

    if args.ids:
        ids_row = [int(x) for x in args.ids.split(",")]
    else:
        ids_row = [i % hp.n_vocab for i in FIXTURE_PHONEME_IDS]
    b = args.batch or dp
    if b % dp:
        raise SystemExit(f"--batch {b} not divisible by dp={dp}")
    ids = np.asarray([ids_row] * b, np.int64)
    lengths = np.full((b,), len(ids_row), np.int64)

    t0 = time.perf_counter()
    audio, y_len = sharded.synthesize_pipelined(
        ids, lengths, max_frames=args.max_frames, seed=args.seed,
        microbatches=args.microbatches)
    wall = time.perf_counter() - t0
    n = int(y_len[0]) * hp.hop_length
    out = {"tool": "pp_run", "pp": args.pp, "dp": dp, "b": b, "slots": n_dev,
           "audio_shape": list(audio.shape), "samples_per_row": n,
           "audio_s": n / sample_rate, "wall_s": wall,
           "launches_per_slot": [dict(c) for c in mesh.slot_launches],
           "device": card(args.device) or {"name": "cpu", "power_limit": None}}
    if args.check:
        single = make_mesh(1, devices=devices[:1])
        ref, _ = ShardedVits.create(single, params, hp).synthesize_batch(
            ids, lengths, max_frames=args.max_frames, seed=args.seed)
        err = float(np.max(np.abs(audio[:, :n] - ref[:, :n])))
        out["max_abs_err"] = err
        out["check"] = "OK" if err < 1e-4 else "MISMATCH"
    if args.out:
        from piper_tpu_torch.utils.wav import write_wav

        write_wav(args.out, audio[0, :n], sample_rate)
        out["wrote"] = args.out
    print(json.dumps(out), flush=True)
    if out.get("check") == "MISMATCH":
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
