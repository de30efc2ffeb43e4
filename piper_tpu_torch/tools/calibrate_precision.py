"""Calibrate the per-level vocoder precision schedule on the port.

The port's copy of the JAX package's tools/calibrate_precision.py, with its
candidate schedules and flags. The fidelity gate is max-abs waveform error
<= 1e-3 against a reference run; this tool measures, for each candidate
schedule of per-level vocoder tiers,

  * max-abs waveform error against the port's own fp32 run on the same
    device (TF32 off), with injected noise, both vocoders fed the identical
    latent z (a ~1e-6 difference in logw can flip a duration ceil() and
    shift the whole waveform: an artifact of the comparison, not a
    precision error); where a committed JAX golden has this voice and
    factor (`piper_tpu_torch/golden/`, seed 0), also against that golden;
  * steady synthesis wall time, the schedules timed in turns (round-robin),
    so that drift on the device hits every schedule alike;

and recommends the fastest schedule whose error clears --threshold.

Beyond the JAX tool it reports the error by stage: each decode stage
alone at its mixed tier ("high"), every other stage in fp32. The stages:
the reverse flows, conv_pre, each upsample level's PyTorch convs (its
conv-transpose and, at the wide levels, its ResBlock convs) and conv_post,
each run both ways: as the tier runs them (fp32 convs on the card, see
`ops/kernels/precision.py::tier_scope`) and in TF32 (as "default" runs
them); and each narrow level's kernels at "high". Then a
batch of `--serving-batch` rows of the phrase at `--factor`, with injected
noise, at the JAX bench's mixed tiers (encoder "highest", flows and
vocoder "high"), each of four rows against its own one-row run. On the CPU
a tier scope changes nothing, so the two ways agree there.

    python -m piper_tpu_torch.tools.calibrate_precision             # medium, the card
    python -m piper_tpu_torch.tools.calibrate_precision --quality x_low
    python -m piper_tpu_torch.tools.calibrate_precision --device cpu --quality test \\
        --factor 1 --batch 2 --iters 1 --serving-batch 2            # smoke

Prints one JSON line on stdout; progress goes to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS

ROOT = Path(__file__).resolve().parents[2]
BENCH_MIX = {"precision": "highest", "vocoder_precision": "high", "flow_precision": "high"}


def candidate_schedules(n_levels: int):
    """Uniform tiers plus every monotone high->default split, and the
    reverse splits (to confirm which end of the stack is error-sensitive)."""
    cands = [("highest",) * n_levels, ("high",) * n_levels, ("default",) * n_levels]
    for split in range(1, n_levels):
        cands.append(("highest",) * split + ("high",) * (n_levels - split))
        cands.append(("high",) * split + ("highest",) * (n_levels - split))
        cands.append(("high",) * split + ("default",) * (n_levels - split))
    # de-dup preserving order
    seen, out = set(), []
    for c in cands:
        if c not in seen:
            seen.add(c)
            out.append(c)
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quality", default="medium")
    ap.add_argument("--factor", type=int, default=8,
                    help="fixture repeat factor (8 = the 112-phoneme bench row)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--threshold", type=float, default=2e-4,
                    help="max-abs error bound (gate 1e-3 with 5x margin)")
    ap.add_argument("--flow-tiers", default="",
                    help="comma list of decode-flow tiers to fidelity-check "
                         "(e.g. 'highest,high,default'); runs the flow "
                         "calibration instead of the vocoder schedule sweep")
    ap.add_argument("--schedules", default="",
                    help="comma-of-colon list, e.g. 'high:high:default:default,default'")
    ap.add_argument("--serving-batch", type=int, default=32,
                    help="rows of the batch held against its own rows")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    return ap


def vocoder_scopes(n_levels: int) -> tuple:
    """The tier scopes hifigan_generator opens, in order: conv_pre, each
    upsample level's PyTorch convs, conv_post."""
    return ("conv_pre", *(f"level{i}" for i in range(n_levels)), "conv_post")


@contextlib.contextmanager
def scope_tiers(tiers: dict, n_levels: int):
    """Within the block, hifigan_generator's scopes named in `tiers`
    (vocoder_scopes) open at the tier given there, whatever the level's
    tier; the kernels keep theirs. tier_scope("high") runs fp32 convs on
    the card and "default" TF32 ones, so {"level1": "default"} puts level
    1's PyTorch convs alone in TF32. The generator's tier_scope is replaced
    for the block, each call's scopes counted off in vocoder_scopes'
    order."""
    from piper_tpu_torch.models.vits import hifigan
    from piper_tpu_torch.ops.kernels.precision import tier_scope

    names = vocoder_scopes(n_levels)
    opened = []

    def scope(precision, device):
        stage = names[len(opened) % len(names)]
        opened.append(stage)
        return tier_scope(tiers.get(stage, precision), device)

    saved, hifigan.tier_scope = hifigan.tier_scope, scope
    try:
        yield
    finally:
        hifigan.tier_scope = saved
    if len(opened) % len(names):
        raise AssertionError(f"hifigan_generator opened {len(opened)} scopes, not a "
                             f"multiple of {names}")


def _err(a, b) -> float:
    return float((a - b).abs().max())


def _log(row: dict) -> None:
    print(json.dumps(row), file=sys.stderr, flush=True)


class _Voice:
    """The synthetic voice's weights on the device, the tool's inputs, and
    the fp32 reference run that every comparison shares."""

    def __init__(self, torch, args, dev):
        from piper_tpu_torch.models.vits import model as vits
        from piper_tpu_torch.models.vits.flows import flow_reverse
        from piper_tpu_torch.models.vits.hparams import PRESETS
        from piper_tpu_torch.models.vits.params import params_to_torch
        from piper_tpu_torch.models.vits.synthetic import synthetic_params

        self.dev = dev
        self.hp = hp = PRESETS[args.quality]
        self.params = params_to_torch(synthetic_params(hp, seed=args.seed), dev)
        rng = np.random.default_rng(args.seed + 1)
        ids1 = (FIXTURE_IDS * args.factor)[:4096]
        b, p = args.batch, len(ids1)
        self.ids = torch.as_tensor(np.tile(np.asarray(ids1, np.int64), (b, 1)), device=dev)
        self.lengths = torch.full((b,), p, dtype=torch.int64, device=dev)
        self.dp_noise = torch.as_tensor(rng.standard_normal((b, 2, p)).astype(np.float32),
                                        device=dev)
        # frame budget ~2x the synthetic voice's observed frames/phoneme
        self.max_frames = max(64, -(-2 * p // 64) * 64)
        self.main_noise = torch.as_tensor(rng.standard_normal(
            (b, hp.inter_channels, self.max_frames)).astype(np.float32), device=dev)
        _log({"quality": args.quality, "levels": hp.num_upsamples, "b": b, "phonemes": p,
              "max_frames": self.max_frames, "device": str(dev)})
        enc = vits.encode(self.params, hp, self.ids, self.lengths, self.dp_noise, noise_w=0.8)
        y_lengths, self.y_mask, _, _, _, self.z_p = vits._expand_prior(
            enc.m_p, enc.logs_p, enc.w_ceil, enc.x_mask, self.max_frames, self.main_noise,
            0.667)
        self.bounds = y_lengths.to(torch.int32)
        self.z = flow_reverse(self.z_p, self.y_mask, self.params, hp) * self.y_mask
        self.audio = self.vocode(("highest",) * hp.num_upsamples, {})
        _log({"frames_used": y_lengths.tolist()})

    def vocode(self, levels, tiers=None, z=None):
        """HiFi-GAN on z (the reference's by default) at per-level tiers
        `levels`, the scopes named in `tiers` at the tier given there
        (scope_tiers)."""
        from piper_tpu_torch.models.vits.hifigan import hifigan_generator

        with scope_tiers(tiers or {}, self.hp.num_upsamples):
            return hifigan_generator(self.z if z is None else z, self.params, self.hp,
                                     level_precisions=list(levels), t_mask=self.y_mask,
                                     t_bounds=self.bounds)[:, 0]

    def flows(self, tier):
        """The reverse flows on the reference's z_p at `tier`, masked."""
        from piper_tpu_torch.models.vits.flows import flow_reverse
        from piper_tpu_torch.ops.kernels.precision import tier_scope

        with tier_scope(tier, self.dev):
            return flow_reverse(self.z_p, self.y_mask, self.params, self.hp) * self.y_mask


def _stage_rows(voice) -> List[dict]:
    """Each decode stage alone at "high" against the fp32 reference: the
    flows and each vocoder scope's PyTorch convs as "high" runs them (route
    "fp32") and in TF32 ("default"'s convs, route "tf32"), every other
    stage and every kernel in fp32; then each narrow level's kernels at
    "high" (their level's PyTorch convs as "high" runs them)."""
    n = voice.hp.num_upsamples
    fp32 = ("highest",) * n
    rows = []
    for route, tier in (("fp32", "high"), ("tf32", "default")):
        rows.append({"stage": "flows", "route": route, "max_abs_err": _err(
            voice.vocode(fp32, z=voice.flows(tier)), voice.audio)})
        _log(rows[-1])
        for stage in vocoder_scopes(n):
            rows.append({"stage": stage, "route": route, "max_abs_err": _err(
                voice.vocode(fp32, {stage: tier}), voice.audio)})
            _log(rows[-1])
    for i in range(n):
        if voice.hp.upsample_initial_channel // 2 ** (i + 1) >= 128:
            continue  # a wide level: its ResBlocks are PyTorch convs, no kernel
        levels = ["high" if j == i else "highest" for j in range(n)]
        rows.append({"stage": f"level{i}.kernels", "route": "kernel",
                     "max_abs_err": _err(voice.vocode(levels), voice.audio)})
        _log(rows[-1])
    return rows


def _golden_errs(torch, args, voice, cands) -> Optional[List[Optional[float]]]:
    """Each schedule's max-abs against the committed JAX golden of this
    voice and factor (JAX on the CPU at "highest", injected noise), or None
    where there is no such golden. The encoder runs in fp32 and its w_ceil
    must equal the golden's (else that schedule's entry is None)."""
    from piper_tpu_torch import golden
    from piper_tpu_torch.models.vits import model as vits

    if args.seed != 0 or args.factor not in golden.factors(args.quality):
        return None
    g = golden.load(args.quality, args.factor)
    dev = voice.dev
    ids = torch.as_tensor(g["ids"][None].astype(np.int64), device=dev)
    enc = vits.encode(voice.params, voice.hp, ids, torch.tensor([ids.shape[1]], device=dev),
                      torch.as_tensor(g["dp_noise"][None], device=dev), noise_w=0.8)
    if not np.array_equal(enc.w_ceil[0].cpu().numpy(), g["w_ceil"]):
        return [None] * len(cands)
    frames = g["main_noise"].shape[-1]
    mn = torch.as_tensor(g["main_noise"][None], device=dev)
    want = torch.as_tensor(g["audio"], device=dev)
    errs = []
    for sched in cands:
        audio, _ = vits.decode(voice.params, voice.hp, enc, mn, max_frames=frames,
                               vocoder_precision=list(sched))
        errs.append(_err(audio[0, : want.shape[0]], want))
    return errs


def _batch_rows(args, dev) -> List[dict]:
    """A batch of `--serving-batch` rows of the phrase at `--factor` with
    injected noise on a split-mode runtime at the bench's mixed tiers; four
    of its rows each against its own one-row run (cuDNN's algorithms
    follow the batch's shape: in TF32, PR 9's 9.54e-4 on the H100)."""
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

    model, config = make_synthetic_voice(ROOT / "build" / f"calibrate_voice_{args.quality}",
                                         quality=args.quality, seed=args.seed)
    rt = PiperRuntime(model, config, RuntimeOptions(mode="split", output_dtype="float32",
                                                    **BENCH_MIX), device=dev)
    ids = (FIXTURE_IDS * args.factor)[:4096]
    b = args.serving_batch
    rng = np.random.default_rng(2)
    dp = rng.standard_normal((b, 2, len(ids))).astype(np.float32)
    width = max(64, -(-2 * len(ids) // 64) * 64)
    mn = rng.standard_normal((b, rt.hparams.inter_channels, width)).astype(np.float32)
    kw = dict(noise_scale=None, length_scale=None, noise_w=None, speaker_ids=None)
    picked = sorted({0, 1, b // 2 + 1, b - 1} & set(range(b)))
    batch, _ = rt._synthesize_batch_impl([ids] * b, dp_noise=dp, main_noise=mn, **kw)
    solo = [rt._synthesize_batch_impl([ids], dp_noise=dp[i:i + 1], main_noise=mn[i:i + 1],
                                      **kw)[0][0] for i in picked]
    if any(batch[i].shape != s.shape for i, s in zip(picked, solo)):
        raise AssertionError(f"batch rows {picked}: lengths differ from their solo runs")
    row = {"rows": b, "factor": args.factor, "compared_rows": picked,
           "max_abs_err": max(float(np.abs(batch[i] - s).max()) for i, s in zip(picked, solo))}
    _log(row)
    return row


def _flow_rows(args, voice) -> List[dict]:
    """--flow-tiers: the reference's z_p through the flows at each tier,
    then the vocoder at "high", against the fp32 reference's audio."""
    rows = []
    for tier in args.flow_tiers.split(","):
        t = None if tier in ("", "none") else tier
        audio = voice.vocode(("high",) * voice.hp.num_upsamples, z=voice.flows(t))
        rows.append({"flow_tier": tier, "vocoder": "high",
                     "max_abs_err": _err(audio, voice.audio)})
        _log(rows[-1])
    return rows


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    import torch

    from piper_tpu_torch.models.vits import model as vits
    from piper_tpu_torch.ops.kernels.precision import fp32_exact, tier_scope

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("calibrate_precision: no CUDA device (--device cpu runs on the CPU)")
    dev = torch.device(args.device)
    head = {"quality": args.quality, "device": (torch.cuda.get_device_name(0)
                                                if dev.type == "cuda" else "cpu"),
            "threshold": args.threshold, "factor": args.factor, "batch": args.batch}
    with torch.inference_mode(), fp32_exact():
        voice = _Voice(torch, args, dev)
        if args.flow_tiers:
            result = {**head, "flow_rows": _flow_rows(args, voice)}
            print(json.dumps(result), flush=True)
            return result

        n = voice.hp.num_upsamples
        if args.schedules:
            cands = [tuple(s.split(":")) if ":" in s else (s,) * n
                     for s in args.schedules.split(",")]
        else:
            cands = candidate_schedules(n)
        tf32 = {s: "default" for s in vocoder_scopes(n)}
        # Pass 1: fidelity on the reference's z, as the tiers run and with
        # every PyTorch conv of the vocoder in TF32.
        rows = []
        for sched in cands:
            rows.append({"schedule": list(sched),
                         "max_abs_err": _err(voice.vocode(sched), voice.audio),
                         "max_abs_err_tf32": _err(voice.vocode(sched, tf32), voice.audio)})
            _log(rows[-1])
        for r, e in zip(rows, _golden_errs(torch, args, voice, cands) or ()):
            r["golden_max_abs_err"] = e

        # Pass 2: the whole synthesis per schedule, in turns (round-robin),
        # the median over the rounds.
        def synth(sched):
            with tier_scope("highest", dev):
                audio, _ = vits.infer(voice.params, voice.hp, voice.ids, voice.lengths,
                                      voice.dp_noise, voice.main_noise,
                                      max_frames=voice.max_frames, vocoder_precision=list(sched))
            return audio.cpu()  # the host read ends the call

        for sched in cands:
            synth(sched)  # first call per shape: cuDNN heuristics, allocator
        times = [[] for _ in cands]
        for _ in range(args.iters):
            for ci, sched in enumerate(cands):
                t0 = time.perf_counter()
                synth(sched)
                times[ci].append((time.perf_counter() - t0) * 1e3)
        for r, ts in zip(rows, times):
            r["ms"] = statistics.median(ts)
            r["ms_spread"] = [min(ts), max(ts)]
        base = next((r for r in rows if set(r["schedule"]) == {"highest"}), rows[0])
        for r in rows:
            r["speedup_vs_highest"] = base["ms"] / r["ms"]
        stages = _stage_rows(voice)
    batch = _batch_rows(args, dev)
    ok = [r for r in rows if r["max_abs_err"] <= args.threshold]
    result = {**head, "rows": rows, "recommended": min(ok, key=lambda r: r["ms"]) if ok else None,
              "stages": stages, "batch_vs_rows": batch}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
