"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
builds the port's kernels from piper_tpu_torch/csrc/, checks each against
its plain PyTorch version at the shapes the main paths give it, drives the
main paths (utterances of a medium voice, whose narrow ResBlock1 levels run
the resblock kernels, and of an x_low voice, whose ResBlock2 levels run
conv1d_same; phoneme ids to PCM through piper_tpu_torch.PiperRuntime) and
checks each voice's result on the card against the same port on the CPU.
Each phase prints one JSON line; any failure raises and the exit code is
non-zero. The last line is {"ok": true, "device": {...}}. It imports no
JAX: the machine with the card has none.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# kernel -> (its source, the TPU kernel it replaces, the voice whose main path runs it)
KERNELS = {
    "resblock1_branch": ("piper_tpu_torch/csrc/resblock1.cu",
                         "piper_tpu/ops/pallas/resblock.py:157", "medium"),
    "resblock1_mrf": ("piper_tpu_torch/csrc/resblock1.cu",
                      "piper_tpu/ops/pallas/resblock.py:328", "medium"),
    "conv1d_same": ("piper_tpu_torch/csrc/conv1d.cu",
                    "piper_tpu/ops/pallas/conv.py:107", "x_low"),
}
KERNEL_ATOL = 1e-4   # C*k <= 704-term sums chained over 6 convs, cuDNN's order differs
WAVE_ATOL = 1e-4     # the fp32 waveform bar the JAX package is held to
FACTORS = (1, 2, 4, 8)
REPS = 10
# x_low's ResBlock2 convs, (kernel, dilation), one per conv of the three branches.
X_LOW_CONVS = ((3, 1), (3, 2), (5, 2), (5, 6), (7, 3), (7, 12))


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def median_ms(fn, torch, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn() (device time, ms)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, torch, reps: int = 10) -> float:
    """Device time of fn() (ms): the sum of its kernels' times under
    torch.profiler, per call. Where the host enqueues more slowly than the
    card runs, the CUDA-event time of median_ms is the host's, not this."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    from piper_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    lib_path, log = build.build()
    build.load()
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit(phase="build", seconds=time.perf_counter() - t0, cached=not log,
         library=str(lib_path.relative_to(ROOT)), ptxas=ptxas)


def _rand(torch, gen, *shape, scale):
    return (torch.randn(*shape, generator=gen) * scale).to("cuda")


def _branch_weights(torch, gen, c, k, m=3):
    s = (c * k) ** -0.5
    return (_rand(torch, gen, m, c, c, k, scale=s), _rand(torch, gen, m, c, scale=0.02),
            _rand(torch, gen, m, c, c, k, scale=s), _rand(torch, gen, m, c, scale=0.02))


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version on the card (TF32 off)."""
    from piper_tpu_torch.engine.runtime import fp32_exact
    from piper_tpu_torch.ops.kernels import resblock as R

    gen = torch.Generator().manual_seed(0)
    dils = (1, 3, 5)
    results = {}
    with torch.inference_mode(), fp32_exact():
        # K2 at medium level 2 (C=64, N = frames * 128), K3 at level 3
        # (C=32, N = frames * 256), 128 frames.
        for name, c, n in (("resblock1_branch", 64, 128 * 128),
                           ("resblock1_mrf", 32, 128 * 256)):
            branches = [(*_branch_weights(torch, gen, c, k), k, dils) for k in (3, 7, 11)]
            x2 = _rand(torch, gen, 2, c, n, scale=0.3)
            cases = {
                "none": None,
                # row 1 ends 3000 samples early: its last tiles are dead
                "one_sided": torch.tensor([n, n - 3000], dtype=torch.int32, device="cuda"),
                "two_sided": torch.tensor([[37, n - 401], [0, n // 3]],
                                          dtype=torch.int32, device="cuda"),
            }

            def run(x, bnd, kernel):
                if name == "resblock1_mrf":
                    fn = R.resblock1_mrf if kernel else R.resblock1_mrf_plain
                    return [fn(x, branches, bounds=bnd)]
                fn = R.resblock1_branch if kernel else R.resblock1_branch_plain
                return [fn(x, *br[:4], kernel=br[4], dilations=br[5], bounds=bnd)
                        for br in branches]

            errs = {}
            for case, bnd in cases.items():
                got = run(x2, bnd, True)
                torch.cuda.synchronize()
                want = run(x2, bnd, False)
                errs[case] = max(float((g - w).abs().max()) for g, w in zip(got, want))
                if bnd is not None:
                    b2 = bnd if bnd.ndim == 2 else torch.stack([torch.zeros_like(bnd), bnd], 1)
                    pos = torch.arange(n, device="cuda")
                    outside = (pos[None] < b2[:, :1]) | (pos[None] >= b2[:, 1:])
                    for g in got:
                        if not bool((g.masked_select(outside[:, None, :]) == 0).all()):
                            raise AssertionError(f"{name} {case}: nonzero output outside [lo, hi)")
            worst = max(errs.values())
            if not worst <= KERNEL_ATOL:
                raise AssertionError(f"{name}: max-abs {worst} > {KERNEL_ATOL} ({errs})")

            # Timing at the main path's batch of one, bounds = valid length.
            x1 = x2[:1].contiguous()
            bnd1 = torch.tensor([n - 100], dtype=torch.int32, device="cuda")
            ms = median_ms(lambda: run(x1, bnd1, True), torch)
            plain_ms = median_ms(lambda: run(x1, bnd1, False), torch)
            results[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}
            emit(phase="kernel", name=name, channels=c, samples=n, batch_timed=1,
                 max_abs_err=worst, errs=errs, ms=ms, plain_ms=plain_ms,
                 device_ms=device_ms(lambda: run(x1, bnd1, True), torch),
                 plain_device_ms=device_ms(lambda: run(x1, bnd1, False), torch),
                 note="ms covers the 3 branch launches of one level" if c == 64 else
                 "ms covers one launch (3 branches + mean)")
        results["conv1d_same"] = _conv1d_same_check(torch, gen)
    return results


def _conv1d_same_check(torch, gen) -> dict:
    """K1 at x_low's levels 1 (C=64) and 2 (C=32), 128 frames: every (k, d)
    of the ResBlock2 convs, B=2 at the level's N with act_slope 0.1 and at a
    ragged N with act_slope 0, then B=1 timed per level (6 launches)."""
    from piper_tpu_torch.ops.kernels import conv as K1

    total = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for level, c, n in ((1, 64, 128 * 64), (2, 32, 128 * 256)):
        convs = [(_rand(torch, gen, c, c, k, scale=(c * k) ** -0.5),
                  _rand(torch, gen, c, scale=0.02), k, d) for k, d in X_LOW_CONVS]
        errs = {}
        for case, nn, slope in (("act", n, 0.1), ("ragged_no_act", n - 77, 0.0)):
            x2 = _rand(torch, gen, 2, c, nn, scale=0.3)
            for w, b, k, d in convs:
                got = K1.conv1d_same(x2, w, b, dilation=d, act_slope=slope)
                torch.cuda.synchronize()
                want = K1.conv1d_same_plain(x2, w, b, dilation=d, act_slope=slope)
                if got.shape != want.shape:
                    raise AssertionError(f"conv1d_same {case} k={k} d={d}: {got.shape}")
                errs[f"{case}_k{k}_d{d}"] = float((got - want).abs().max())
        worst = max(errs.values())
        if not worst <= KERNEL_ATOL:
            raise AssertionError(f"conv1d_same level {level}: max-abs {worst} > {KERNEL_ATOL} "
                                 f"({errs})")
        x1 = _rand(torch, gen, 1, c, n, scale=0.3)

        def run(kernel):
            fn = K1.conv1d_same if kernel else K1.conv1d_same_plain
            return [fn(x1, w, b, dilation=d, act_slope=0.1) for w, b, k, d in convs]

        ms = median_ms(lambda: run(True), torch)
        plain_ms = median_ms(lambda: run(False), torch)
        emit(phase="kernel", name="conv1d_same", level=level, channels=c, samples=n,
             batch_timed=1, max_abs_err=worst, errs=errs, ms=ms, plain_ms=plain_ms,
             device_ms=device_ms(lambda: run(True), torch),
             plain_device_ms=device_ms(lambda: run(False), torch),
             note="ms covers the 6 launches of one level")
        total = {"max_abs_err": max(total["max_abs_err"], worst),
                 "ms": total["ms"] + ms, "plain_ms": total["plain_ms"] + plain_ms}
    return total


def _counters():
    from piper_tpu_torch.ops.kernels import conv as K1
    from piper_tpu_torch.ops.kernels import resblock as R

    return {"resblock1_branch": R.resblock1_branch, "resblock1_mrf": R.resblock1_mrf,
            "conv1d_same": K1.conv1d_same}


def phase_main_path(torch, quality: str, voice_dir: Path) -> tuple:
    """The port's main path for one voice: synthesize() on the card. Every
    launch count is set to 0 just before the timed run and read just after;
    each kernel of this voice's path must have launched."""
    from piper_tpu.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu.models.vits.synthetic import make_synthetic_voice
    from piper_tpu_torch.engine.runtime import PiperRuntime

    t0 = time.perf_counter()
    model, config = make_synthetic_voice(voice_dir, quality=quality, seed=0)
    rt = PiperRuntime(model, config, device="cuda")
    load_s = time.perf_counter() - t0
    for f in FACTORS:  # first call per shape: cuDNN heuristics, allocator
        rt.synthesize(FIXTURE_PHONEME_IDS * f)

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    rows = []
    for f in FACTORS:
        ids = FIXTURE_PHONEME_IDS * f
        walls, timings = [], []
        for _ in range(REPS):
            pcm = rt.synthesize(ids)
            t = rt.last_run_timings
            walls.append(t.wall_ms)
            timings.append(t)
            if pcm.dtype.name != "float32" or len(pcm) != t.frames * rt.hparams.hop_length:
                raise AssertionError(f"{quality} f={f}: {pcm.dtype} length {len(pcm)} != "
                                     f"{t.frames} frames * {rt.hparams.hop_length}")
            if not np.isfinite(pcm).all() or not 0 < float(np.abs(pcm).max()) <= 1.0:
                raise AssertionError(f"{quality} f={f}: output not finite / not in (0, 1]")
        t = timings[-1]
        rows.append({"factor": f, "phonemes": len(ids), "ms_median": statistics.median(walls),
                     "ms_all": walls, "encode_ms": t.encode_ms, "decode_ms": t.decode_ms,
                     "frames": t.frames, "frame_bucket": t.frame_bucket,
                     "audio_s": t.samples / rt.sample_rate, "rtf": t.rtf})
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, (_, _, voice) in KERNELS.items():
        if voice == quality and launches[name] <= 0:
            raise AssertionError(f"the {quality} main path launched {name} no time")
    utterances = len(FACTORS) * REPS
    if quality == "x_low" and launches["conv1d_same"] != 12 * utterances:
        raise AssertionError(f"x_low: {launches['conv1d_same']} conv1d_same launches for "
                             f"{utterances} utterances, expected 12 each")
    emit(phase="main_path", voice=f"synthetic {quality}, seed 0", load_s=load_s,
         sample_rate=rt.sample_rate, hop=rt.hparams.hop_length, rows=rows,
         utterances=utterances, launches=launches)
    return rt, model, config, launches


def phase_card_vs_cpu(torch, quality: str, rt, model, config) -> None:
    """f=1 with the same injected noise: card (kernels + fp32 cuDNN) vs the
    port on the CPU (plain versions)."""
    from piper_tpu.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.bucketing import bucket_for, pad_to
    from piper_tpu_torch.engine.runtime import PiperRuntime, fp32_exact
    from piper_tpu_torch.models.vits import model as vits

    cpu = PiperRuntime(model, config, device="cpu")
    ids = FIXTURE_PHONEME_IDS
    hp = rt.hparams
    rng = np.random.default_rng(0)
    dp_noise = rng.standard_normal((2, len(ids))).astype(np.float32)
    main_noise = rng.standard_normal((hp.inter_channels, 64)).astype(np.float32)

    def w_ceil(r):
        p = bucket_for(len(ids), r.options.phoneme_buckets)
        dpn = np.zeros((1, 2, p), np.float32)
        dpn[0, :, : len(ids)] = dp_noise
        with torch.inference_mode(), fp32_exact():
            enc = vits.encode(
                r.params, hp, torch.from_numpy(pad_to(np.asarray(ids), p)[None]).to(r.device),
                torch.tensor([len(ids)], device=r.device), torch.from_numpy(dpn).to(r.device))
            return enc.w_ceil.cpu().numpy()

    wc_gpu, wc_cpu = w_ceil(rt), w_ceil(cpu)
    if not np.array_equal(wc_gpu, wc_cpu):
        raise AssertionError(f"{quality}: w_ceil differs: card {wc_gpu} cpu {wc_cpu}")
    a_gpu = rt.synthesize(ids, dp_noise=dp_noise, main_noise=main_noise)
    a_cpu = cpu.synthesize(ids, dp_noise=dp_noise, main_noise=main_noise)
    if a_gpu.shape != a_cpu.shape:
        raise AssertionError(f"{quality}: lengths differ: card {a_gpu.shape} cpu {a_cpu.shape}")
    err = float(np.abs(a_gpu - a_cpu).max())
    if not err <= WAVE_ATOL:
        raise AssertionError(f"{quality}: card vs cpu waveform max-abs {err} > {WAVE_ATOL}")
    emit(phase="card_vs_cpu", voice=quality, factor=1, w_ceil_equal=True, frames=int(wc_gpu.sum()),
         samples=int(a_gpu.shape[0]), max_abs_err=err, atol=WAVE_ATOL)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU and has no CPU path")
    if not (ROOT / "piper_tpu_torch").is_dir() or not (ROOT / "piper_tpu").is_dir():
        fail(f"run from the root of a piper-tpu checkout ({ROOT} holds no package)")
    sys.path.insert(0, str(ROOT))

    phase_device(torch)
    phase_build()
    kernels = phase_kernels(torch)
    launches = {}
    for quality in ("medium", "x_low"):
        rt, model, config, counts = phase_main_path(
            torch, quality, ROOT / "build" / f"chip_smoke_voice_{quality}")
        launches.update({name: counts[name] for name, k in KERNELS.items() if k[2] == quality})
        phase_card_vs_cpu(torch, quality, rt, model, config)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    emit(kernels=[
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, r in kernels.items()])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
