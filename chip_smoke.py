"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
builds the port's kernels from piper_tpu_torch/csrc/, checks each against
its plain PyTorch version at every precision tier at the shapes the main
paths give it, and drives the main paths, counting each kernel's launches:

- utterances of a medium voice, whose narrow ResBlock1 levels run the
  resblock kernels, and of an x_low voice, whose ResBlock2 levels run
  conv1d_same (phoneme ids to PCM through piper_tpu_torch.PiperRuntime, at
  the fp32 tier);
- each voice at the JAX bench's mixed-precision configuration (encoder
  "highest", vocoder and flows "high"), held against its fp32 run on the
  card within the 1e-3 waveform gate;
- a reduced run of the folded-kernel probe
  (piper_tpu_torch.tools.folded_probe), the path that runs the folded MRF
  kernel;
- a reduced run of the conv-transpose probe (piper_tpu_torch.tools.ct_probe)
  at each of the medium voice's four upsample levels, the path that runs
  the interleave kernel (the polyphase conv-transpose's interleave), with
  the polyphase and input-dilated conv-transposes held against PyTorch's;
- each voice, fp32 and mixed, against the committed JAX goldens
  (piper_tpu_torch/golden/, f=1 and f=8): w_ceil equal, the waveform within
  1e-4 (1e-3 mixed);
- seeded synthesis (`seeded`, medium fp32): the card's own noise, JAX's
  threefry draws (the threefry kernel), against the committed seeded
  goldens (the JAX package's synthesize and incremental stream at their
  seed): w_ceil equal, within 1e-4; the port's CPU run against its card run
  at one seed (durations equal, the waveform and a stream within 1e-4);
  and the device kernels of one seeded call (medium mixed: fused 1x1 and a
  224-id stream, tools/noise_probe.py), the threefry kernels among them;
- batches: 32 identical f=8 rows of synthesize_batch against one
  synthesize (medium, both configurations), four injected rows of f =
  1/2/4/8 against their one-row runs (every voice and configuration: the
  kernels' per-row bounds at B>1), and medium's B=32 throughput, blocking
  and through ServingPipeline.submit_batch, with one profiled batch;
- 32 ServingPipeline.submit requests on a fused-mode medium runtime, each
  equal to its fused synthesize;
- the five-level high voice (K3 at 16 channels), fp32 and mixed, held
  against the port on the CPU and against each other;
- the bench's 904-speaker medium voice (gin 512), fp32 and mixed:
  utterances of speaker ids and mixes, the committed speaker goldens (id
  903, mix {0: 0.6, 903: 0.4}), the card against the CPU, one-hot mixes
  bit-equal to their ids, a B=32 batch of mixed speaker ids against its
  rows run one by one, and forced durations: the predicted plan forced
  against synthesize, and synthesize_batch_forced against its solo runs;
- the port's bench, `piper_tpu_torch.bench.main(["--quick"])`, its
  multispeaker row (8 speakers) included;
- the continuous batcher (`serve`): one MultiVoiceBatchingServer over the
  medium and x_low voices at the mixed tiers (fused, int16), prewarmed,
  serving the serving mix of piper_tpu_torch.tools.serving_sim from several
  threads: nothing failed or shed, zero-noise requests held to the fp32
  synthesize, served durations equal to phoneme_durations, K1, K2 and K3
  launched in the served groups, and close() releasing each voice's
  weights from the card;
- concurrent streams (`stream_serve`, on medium and x_low at the mixed
  tiers and on medium at fp32): eight clients at once through one
  StreamingServer at 64 frames a window, each stream contiguous and equal
  to its synthesize_stream_incremental alone (1e-4 fp32, 5e-4 mixed), the
  windows batched across streams, K1-K3 launched their count per head and
  window call;
- batch and stream traffic on one worker (`unified`): a UnifiedServer of
  medium and x_low at the mixed tiers serving the serving mix with streams
  opened during it, nothing failed or shed, zero-noise rows within 5e-5 of
  the fp32 synthesize, the streams equal to their solo runs, and
  remove_voice(close_runtime=True) releasing x_low's weights from the card;
- the HTTP door (`http`): PiperHTTPServer(stream=True) over the same two
  voices, the serving mix POSTed to /v1/synthesize through serving_sim's
  HttpClient, zero-noise WAV and pcm responses within 5e-5 of the fp32
  synthesize, chunked /v1/stream responses equal to their solo streams,
  /v1/durations equal to phoneme_durations, the GET routes, a 404 and a
  400, K1-K3 launched, the client SDK (PiperClient: health, voices,
  zero-noise WAVs within 5e-5 of fp32, durations, a 404); then the serving
  CLI (`python -m piper_tpu_torch.cli --serve --stream --prewarm`) as a
  subprocess, one request of each kind through it, and its SIGTERM drain
  (exit 0);
- the layer split (`roofline`): the device's GEMM and HBM ceilings beside
  the published peaks, then piper_tpu_torch.utils.roofline's report on
  medium mixed (K2, K3) and x_low (K1) at B=4, P=32, T=128, every stage
  and level with a device time, its kernels per call and an mfu and
  hbm_frac in (0, 1.05]; and a reduced level probe
  (piper_tpu_torch.tools.level_probe) at level 3, through K3;
- the command line (`cli`): --record-vectors and --microbench in process
  (K2 and K3 launched; both chain times), then as subprocesses a one-shot
  --phoneme-ids WAV at zero noise within 1e-4 + 1/32767 of synthesize, and
  --verify-summary of the recorded vector within 1e-4;
- the "bfloat16" capacity tier (`bf16`, paths `medium_bf16`, `x_low_bf16`):
  bf16 weights and activations, K1-K3 on bf16 at "default"; synthesize at
  f=1 and 8, a B=32 batch of f=8 and one incremental stream, float32 PCM,
  finite, in [-1, 1], each vocoder kernel its count per call and the
  profiled batch's bf16 kernels (symbol `__nv_bfloat16`) equal to their
  launches; printed, not gated: the max-abs against the card's fp32 run,
  the share of w_ceil that differs from fp32, and the batch's device busy
  and rtf beside medium mixed's. The kernel phase holds each of K1-K3 on
  bf16 input against its plain version (its bar plus one bf16 ulp) and
  within one bf16 ulp of the fp32-input "default" kernel on the same bf16
  values, its output rounded to bf16 (the kernels line's "bfloat16" tier);
- the per-layer trace (`debug_trace`): medium fp32 synthesize_debug(
  per_layer=True) on the card against the port on the CPU, one seed: the
  same keys in the same order, w_ceil equal, audio within 1e-4, the other
  module tensors within 2e-5 (logw 5e-5), each layer's max-abs printed;
- the operator's tools (`tools`), reduced: bench_sessions (two fresh
  processes of a small x_low bench), cold_start (a fresh process on built
  kernels, and the warm call), padding_tax --iters 2 and streaming_bench
  --streams 4 --rounds 1 --ab-heads, each line with the JAX tool's keys;
- incremental streaming on each voice, fp32 and mixed (paths
  `{voice}_stream`, `{voice}_mixed_stream`): the f=8 JAX golden streamed
  with its injected noise at the growing schedule and at 16-frame windows
  (contiguous chunks, the last final, the waveform within 1e-4, 1e-3
  mixed), the seeded fused head against the split path, the head and the
  speculative window 1 dispatched under torch.cuda's sync debug mode
  "error", a batched head of 4 streams and one batched window (rows at
  different offsets, one past its end) against their solo decodes, and the
  bench's streaming row (time to first audio, p50) with the head's device
  busy time.

- the multi-slot layer (`mesh`, paths `mesh_dp`, `mesh_sp`, `mesh_tp`,
  `mesh_pp`; piper_tpu_torch.parallel) on two virtual slots of the card,
  medium fp32 at full width, each slot on its own stream: ShardedVits dp=2
  (4 rows of f=8) against the one-slot call with the same numpy noise, at
  fp32 (1e-4) and at the mixed tiers (1e-3); sp=2 synthesize_long against
  the one-device decode_window windows; tp=2 against the one-slot
  (replicated) call; dp=1 x pp=2 synthesize_pipelined against
  synthesize_batch at the same seed; each against the same call on CPU
  slots (sp at zero noise). dp and sp slots launch K2 and K3 their count
  per call, counted per slot; tp and pp launch none. Each path's wall and
  device busy are printed (dp=1 beside dp=2);
- PiperRuntime(mesh=dp2) behind a BatchingServer (`mesh_serve`): the
  serving mix from two threads beside zero-noise requests, each held to
  the one-device runtime (1e-4), both slots launching K2 and K3;
- the native ONNX parser (`onnx_native`): load_model of the medium voice
  through piper_tpu_torch/native/onnx_parser.cpp (built with g++ at first
  use) and through the Python decoder, equal initializers and nodes, both
  load times;
- a 15 s run of the unified soak (`soak`,
  tests/test_torch_unified_soak.py::run_soak) on the medium voice and a
  3-speaker medium voice at the mixed tiers: submits, streams, cancels,
  add_voice/remove_voice churn and sheds, no hang, no leaked thread.

Beside the paths, a profile phase puts one utterance of each voice (fp32
and mixed, factors 1 and 8) under torch.profiler: its device kernels, their
summed device time, the vocoder kernels' share (K2 + K3 for medium, K1 for
x_low), and the unprofiled ms/utterance. A calibration phase prints the
error by decode stage (piper_tpu_torch.tools.calibrate_precision, reduced:
each stage alone at "high", its PyTorch convs as "high" runs them (fp32)
and in TF32, its kernels; the serving batch against its rows), and a
margin line lists every comparison held to the mixed gate (1e-3) against
half of it, 5e-4: the run fails if any lands above that target.

The build's resblock_ptxas and conv1d_ptxas lines give each K2-K4 and
each K1 instantiation's registers, spills, ptxas notes and its products in
the machine code (cuobjdump -sass: HGMMA is wgmma, HMMA mma.sync); the run
fails unless every tier's instantiations of both (K1's at every padded
width and with bf16 I/O) hold wgmma and none holds mma.sync. The kernel
phase holds K1's wide design (`conv1d_same_wide`, csrc/conv1d_wide.cu) at
a high voice's wide levels (C=256 and 128 at the 320-frame bucket) against
its plain version at "highest" and "high", and times it beside the
library route it replaced (leaky_relu, F.conv1d, the residual; TF32 off);
its launches are its own counter's, and conv1d_same's entry counts the
narrow design's alone. It also drives the route of the ResBlock1 widths
the K2/K3 stage refuses (a voice with C=48 and C=24 levels, at "highest",
"high" and in the "bfloat16" mode): K1 launched its count, against its
plain version;
and it holds the seeded draw's kernel (threefry_normal, which replaces no
TPU kernel) against its plain version in its three layouts (bits and
uniforms bit-equal, normals within 2e-6), timed beside its plain version
and torch.randn.

Each voice's result on the card is checked against the same port on the
CPU. Each phase prints one JSON line; any failure raises and the exit code
is non-zero. The line before the last lists every kernel: its launches on
the paths, its error against its plain version, its device time (`ms`,
torch.profiler) beside the plain version's, the least time the card could
take for the same work (`bound_ms`, from the published H100 peaks) and the
time of one PyTorch call that computes the same function where there is
one (`library_ms`). The last line is {"ok": true, "device": {...}}. It
imports neither JAX nor the JAX package (piper_tpu): the machine with the
card has no JAX, and the port runs without that package.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# The paths that run the ResBlock1 kernels (K2, K3) and conv1d_same (K1).
# The multi-speaker voice's paths (the medium vocoder: K2, K3).
MS_PATHS = tuple(f"medium_ms{suffix}{part}" for suffix in ("", "_mixed")
                 for part in ("", "_golden", "_batch", "_forced"))
RESBLOCK1_PATHS = ("medium", "medium_mixed", "medium_golden", "medium_mixed_golden",
                   "medium_batch", "medium_mixed_batch", "pipeline", "high", "high_mixed",
                   "bench", "medium_stream", "medium_mixed_stream", "serve",
                   "medium_stream_serve", "medium_mixed_stream_serve", "unified",
                   "http", "medium_bf16", "tools", "mesh_dp", "mesh_sp", "mesh_serve",
                   "soak") + MS_PATHS
CONV1D_PATHS = ("x_low", "x_low_mixed", "x_low_golden", "x_low_mixed_golden", "x_low_batch",
                "x_low_mixed_batch", "x_low_stream", "x_low_mixed_stream", "serve",
                "x_low_mixed_stream_serve", "unified", "http", "x_low_bf16", "debug_trace")
# The paths that draw seeded noise (the threefry kernel): synthesize() at
# the default seed, the seeded streams, the seeded goldens.
SEEDED_PATHS = ("medium", "medium_mixed", "x_low", "x_low_mixed", "medium_stream",
                "medium_mixed_stream", "x_low_stream", "x_low_mixed_stream", "seeded")
# kernel -> (its source, the TPU kernel it replaces, the paths that run it)
KERNELS = {
    "resblock1_branch": ("piper_tpu_torch/csrc/resblock1.cu",
                         "piper_tpu/ops/pallas/resblock.py:157",
                         RESBLOCK1_PATHS + ("probe", "resblock_probe", "roofline_medium",
                                            "cli")),
    "resblock1_mrf": ("piper_tpu_torch/csrc/resblock1.cu",
                      "piper_tpu/ops/pallas/resblock.py:328",
                      RESBLOCK1_PATHS + ("probe", "resblock_probe", "roofline_medium",
                                         "level_probe", "cli")),
    "conv1d_same": ("piper_tpu_torch/csrc/conv1d.cu",
                    "piper_tpu/ops/pallas/conv.py:107", CONV1D_PATHS + ("roofline_x_low",)),
    # K1's wide design: no TPU kernel, the JAX package leaves the wide
    # levels' convs to XLA.
    "conv1d_same_wide": ("piper_tpu_torch/csrc/conv1d_wide.cu",
                         "none (XLA's conv, piper_tpu/models/vits/hifigan.py:53)",
                         ("medium", "medium_mixed", "x_low", "x_low_mixed", "high",
                          "high_mixed")),
    "resblock1_mrf_folded": ("piper_tpu_torch/csrc/resblock1.cu",
                             "piper_tpu/ops/pallas/folded.py:220", ("probe",)),
    "interleave": ("piper_tpu_torch/csrc/interleave.cu", "tools/ct_probe.py:151",
                   ("ct_probe",)),
    # No TPU kernel: the JAX package leaves jax.random's threefry to XLA.
    "threefry_normal": ("piper_tpu_torch/csrc/threefry.cu",
                        "none (jax.random.normal under XLA, piper_tpu/engine/runtime.py:600)",
                        SEEDED_PATHS),
}
# Why no single PyTorch call computes a kernel's function (library_ms null).
NO_LIBRARY_CALL = {
    "resblock1_branch": "a masked chain of six convs, each after a leaky_relu",
    "resblock1_mrf": "three masked chains of six convs and their mean",
    "conv1d_same": "leaky_relu then a conv: two calls",
    "conv1d_same_wide": "leaky_relu, a conv, the residual added: three calls (their "
                        "time is library_ms)",
    "resblock1_mrf_folded": "the MRF's chains on a folded layout",
    "threefry_normal": "no PyTorch call draws JAX's threefry numbers; torch.randn (Philox, "
                       "other numbers) is timed beside it as randn_ms",
}
TIERS = ("highest", "high", "default")
# "high": C*k <= 704-term sums of exact products chained over 6 convs, in
# another order than cuDNN's. "highest": the same sums, K2-K4 forming each
# product as 3xTF32 (big*big + big*small + small*big), which drops about
# 2^-21 of it against the plain version's fp32 product, the order of the
# sums' own rounding: measured 1.7e-5 at K2's main-path shape on the H100
# (the wgmma stage, whose "highest" conv2 sums from 0 and adds the residual
# after), against 2.8e-5 at "high". "default": where the
# two sums differ by an fp32 ulp, the next conv's bf16 rounding of its
# input can flip by one bf16 ulp (2^-6 for values in [2, 4)), times a
# weight of up to ~0.1, and the chain carries it on; measured up to 2.2e-3
# at K2's main-path shape on the H100.
KERNEL_ATOL = {"highest": 1e-4, "high": 1e-4, "default": 5e-3}
# K1 is one conv: no chain carries a flip, and the kernel rounds the same
# fp32 input as its plain version, so every tier differs only in the order
# of its fp32 sums.
K1_ATOL = 1e-4
# How K2/K3/K4 form each tier's conv products (csrc/resblock1.cu): every
# tier on warpgroup products with each tap's weights bulk-copied into a
# ring in shared memory; "highest" as 3xTF32 on tf32 big and small planes
# split where they are written.
RESBLOCK_DESIGN = {"highest": "wgmma tf32 x3, bulk-copied weights",
                   "high": "wgmma bf16 x3, bulk-copied weights",
                   "default": "wgmma bf16 x1, bulk-copied weights"}
# How K1 forms them (csrc/conv1d.cu): K2-K4's wgmma stage for one conv,
# the tile's output lanes on M, the weights' swizzled image (laid out once
# per weight tensor and tier) bulk-copied into a ring.
K1_DESIGN = {"highest": "wgmma tf32 x3, bulk-copied weight image",
             "high": "wgmma bf16 x3, bulk-copied weight image",
             "default": "wgmma bf16 x1, bulk-copied weight image"}
RESBLOCK_SYMBOL = "resblock1_kernel"  # the device symbol of K2, K3 and K4
# K1-K3 on bf16 activations ("bfloat16" mode, the "default" tier): the
# "default" stage with bf16 loads and stores; "__nv_bfloat16" is in the
# symbols of those variants only.
BF16_DESIGN = {"conv1d_same": "wgmma bf16 x1, bulk-copied weight image, bf16 loads and stores",
               "resblock": "wgmma bf16 x1, bulk-copied weights, bf16 loads and stores"}
K1_SYMBOL = "conv1d_same"  # held by every K1 instantiation's symbol
K5_SYMBOL = "interleave_kernel"
# A voice's vocoder kernels: their device symbol and their launch counters.
VOCODER_KERNELS = {"medium": (RESBLOCK_SYMBOL, ("resblock1_branch", "resblock1_mrf")),
                   "x_low": (K1_SYMBOL, ("conv1d_same",))}
# A voice's vocoder kernel launches per synthesis call or stream window,
# whatever its rows:
# medium's level 2 (C=64) runs three K2 branches and level 3 (C=32) one K3;
# high adds a K3 level at C=16; x_low's two narrow levels run six K1 convs
# each.
LAUNCHES_PER_CALL = {"medium": {"resblock1_branch": 3, "resblock1_mrf": 1},
                     "high": {"resblock1_branch": 3, "resblock1_mrf": 2},
                     "x_low": {"conv1d_same": 12}}
# And the wide levels' convs, through K1's wide design on fp32 activations
# (the bf16 paths keep them PyTorch convs): 18 a level at medium's and
# high's C=256 and 128, six at x_low's C=128. conv1d_same's counter counts
# them too; conv1d_same_wide's counts them alone.
WIDE_LAUNCHES_PER_CALL = {"medium": 36, "high": 36, "x_low": 6}
# The wide check: a high voice's wide levels, (level, C, samples a frame),
# at the f=8 batches' 320-frame bucket; timed at the serving batch's rows.
WIDE_LEVELS = ((0, 256, 8), (1, 128, 64))
WIDE_FRAMES = 320
WAVE_ATOL = 1e-4     # the fp32 waveform bar the JAX package is held to
MIXED_ATOL = 1e-3    # the lowered-precision waveform gate (BASELINE.md)
# Half the gate: where every mixed comparison must land (the margin phase
# fails above it), and what each printed there (path, what, max-abs).
MIXED_TARGET = 5e-4
MIXED_MARGINS = []
# bench.py's default configuration of the JAX package
BENCH_MIX = {"precision": "highest", "vocoder_precision": "high", "flow_precision": "high"}
FACTORS = (1, 2, 4, 8)
REPS = 10
SERVING_BATCH = 32  # the JAX bench's serving batch of f=8 utterances
# x_low's ResBlock2 convs, (kernel, dilation), one per conv of the three branches.
X_LOW_CONVS = ((3, 1), (3, 2), (5, 2), (5, 6), (7, 3), (7, 12))
# The bench's multi-speaker voice, and the speakers its paths run: ids at
# both ends and inside the table, and a blend.
MS_SPEAKERS = 904
MS_GIN = 512
MS_RUNS = ({"speaker_id": 0}, {"speaker_id": 451}, {"speaker_id": 903},
           {"speaker_mix": {0: 0.6, 903: 0.4}}, {"speaker_mix": {17: 1.2, 400: -0.2}})
FORCED_ATOL = 1e-5  # the forced predicted plan against synthesize, fp32
# The medium voice's upsample levels: rate (the interleave's r), kernel,
# output channels.
MEDIUM_UPSAMPLE = ((8, 16, 256), (8, 16, 128), (2, 4, 64), (2, 4, 32))
CT_ATOL = 1e-4  # poly_ct and native_ct vs full_ct, fp32 sums in other orders
# Streaming: the fused head against the split path (the same kernels on the
# same inputs), and the bench's first window (c0 = max(32, 2048 // hop)).
FUSED_SPLIT_ATOL = 1e-6
STREAM_C0 = 32
# The serve phase: the serving mix (serving_sim.LENGTH_MIX) from SERVE_THREADS
# submitter threads, Poisson at SERVE_RATE requests/s in all, for SERVE_S
# seconds, through one MultiVoiceBatchingServer of the two voices.
SERVE_RATE = 40.0
SERVE_THREADS = 4
SERVE_S = 4.0
SERVE_MAX_BATCH = 32  # serving_sim's --max-batch
# The concurrent-stream phases: STREAM_CLIENTS threads at once, client i
# streaming the fixture phrase x STREAM_FACTORS[i % 4] twice (two seeds)
# through one StreamingServer at 64 emitted frames a window (so each stream
# has several windows) and the default c0. UNIFIED_STREAMS: (voice, factor,
# seconds into the unified phase) of the streams opened beside its traffic.
STREAM_CLIENTS = 8
STREAM_FACTORS = (2, 4, 8, 16)
STREAM_EMIT = 64
UNIFIED_STREAMS = (("medium", 2, 0.4), ("x_low", 2, 1.0), ("medium", 4, 1.6),
                   ("x_low", 4, 2.2), ("medium", 8, 2.8), ("x_low", 8, 3.4))
# int16 served rows against the fp32 synthesize at zero noise: the int16
# rounding (1.5e-5) and the kernels' "high" products (~5e-6).
ZERO_NOISE_ATOL = 5e-5
# The roofline phase: (B, P, T) of its reports, timed windows of ROOFLINE_ITERS
# calls; every stage's mfu and hbm_frac must lie in (0, ROOFLINE_MAX_FRAC].
ROOFLINE_SHAPE = (4, 32, 128)
ROOFLINE_ITERS = 2
ROOFLINE_MAX_FRAC = 1.05
# The CLI phase: a WAV (int16) against the fp32 synthesize of the same ids at
# zero noise, and a recorded vector replayed.
WAV_ATOL = WAVE_ATOL + 1.0 / 32767
REPLAY_ATOL = 1e-4
# debug_infer's module-boundary keys, in its order (after the layers'). On
# the card against the CPU at full width, a module tensor's bar (2e-5, 5e-5
# logw, 1e-4 audio) scales with its peak where that exceeds 1: fp32 sums in
# another order leave ~3e-6 on m_p and logs_p, and z_p = m_p + noise *
# exp(logs_p) * noise_scale carries logs_p's error times |z_p - m_p| (up to
# ~10), 3.4e-5 on the H100.
# The multi-slot phases (parallel/): medium at full width on virtual slots
# of the one card. dp: MESH_B rows of the fixture x MESH_F at MESH_FRAMES
# frames (the f=8 utterance's durations fit); sp, tp and pp: MESH_SMALL_B
# rows of the fixture x 2 at MESH_SMALL_FRAMES (sp: two spans of MESH_SPAN).
# Seeds as the JAX tests'. mesh_serve: MESH_SERVE_S seconds of the serving
# mix at MESH_SERVE_RATE requests/s from two threads, beside zero-noise
# requests of f = 1/2/4/8. The soak: SOAK_S seconds of the 60 s test's churn.
MESH_B, MESH_F, MESH_FRAMES = 4, 8, 256
MESH_SMALL_B, MESH_SMALL_FRAMES, MESH_SPAN = 2, 64, 64
MESH_SEED, SP_SEED = 3, 77
MESH_SERVE_S, MESH_SERVE_RATE = 2.0, 20.0
SOAK_S = 15.0
DEBUG_MODULE_KEYS = ["enc_hidden", "m_p", "logs_p", "x_mask", "logw", "w_ceil", "y_lengths",
                     "y_mask", "path", "m_p_expanded", "logs_p_expanded", "z_p", "z", "audio"]


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


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
    k1_rows = build.ptxas_report(log, K1_SYMBOL)
    emit(phase="build", seconds=time.perf_counter() - t0, cached=not log,
         library=str(lib_path.relative_to(ROOT)), ptxas=ptxas,
         k1_registers={r["kernel"]: r["registers"] for r in k1_rows},
         k1_spill_bytes=sum((r["spill_stores"] or 0) + (r["spill_loads"] or 0)
                            for r in k1_rows))
    # K2-K4's instantiations: registers, spills, shared bytes, ptxas notes,
    # and their products in the machine code: every tier on wgmma (HGMMA),
    # none on mma.sync (HMMA).
    sass = build.sass_ops(lib_path, RESBLOCK_SYMBOL)
    rows = build.ptxas_report(log, RESBLOCK_SYMBOL)
    for row in rows:
        row["sass"] = sass.get(row["kernel"])
    emit(phase="resblock_ptxas", kernels=rows)
    tiers, wrong = resblock_sass_check(sass)
    if tiers != {0, 1, 2} or wrong or (log and len(rows) != len(sass)):
        raise AssertionError(f"resblock_ptxas: tiers {sorted(tiers)} in the library; not on "
                             f"wgmma alone: {wrong}")
    # K1's instantiations (every tier, every padded width, bf16 I/O at
    # "default"): registers, spills, notes, and their products: wgmma only.
    sass = build.sass_ops(lib_path, K1_SYMBOL)
    for row in k1_rows:
        row["sass"] = sass.get(row["kernel"])
    emit(phase="conv1d_ptxas", kernels=k1_rows)
    variants, wrong = conv1d_sass_check(sass)
    if variants != K1_VARIANTS or wrong or (log and len(k1_rows) != len(sass)):
        raise AssertionError(f"conv1d_ptxas: {sorted(K1_VARIANTS - variants)} missing from "
                             f"the library; not on wgmma alone: {wrong}")


def resblock_sass_check(sass: dict) -> tuple:
    """(the tiers of the ResBlock1 instantiations in `sass`, {instantiation:
    counts} of those not on wgmma alone: any HMMA, or no HGMMA). The tier is
    the kernel's third template argument, demangled as `2` or `(int)2`."""
    tiers = set()
    for name in sass:
        m = re.search(r"resblock1_kernel<[^,<>]+, [^,<>]+, (?:\(int\))?(\d+),", name)
        if m:
            tiers.add(int(m.group(1)))
    return tiers, {k: c for k, c in sass.items() if c["HMMA"] or not c["HGMMA"]}


# K1's instantiations: (padded C, tier, I/O type), every multiple of 16 up
# to 128 at every tier, and bf16 I/O at "default".
K1_VARIANTS = {(c, t, "float") for c in range(16, 129, 16) for t in (0, 1, 2)} | {
    (c, 2, "bf16") for c in range(16, 129, 16)}


def conv1d_sass_check(sass: dict) -> tuple:
    """({(padded C, tier, "float" or "bf16")} of the conv1d_same
    instantiations in `sass`, {instantiation: counts} of those not on wgmma
    alone: any HMMA, or no HGMMA). C and the tier are the kernel's first two
    template arguments, demangled as `2` or `(int)2`."""
    variants = set()
    for name in sass:
        m = re.search(r"conv1d_same_kernel<(?:\(int\))?(\d+), (?:\(int\))?(\d+), ([^>]+)>",
                      name)
        if m:
            io = "bf16" if "bfloat16" in m.group(3) else "float"
            variants.add((int(m.group(1)), int(m.group(2)), io))
    return variants, {k: c for k, c in sass.items() if c["HMMA"] or not c["HGMMA"]}


def _rand(torch, gen, *shape, scale):
    return (torch.randn(*shape, generator=gen) * scale).to("cuda")


def _branch_weights(torch, gen, c, k, m=3):
    s = (c * k) ** -0.5
    return (_rand(torch, gen, m, c, c, k, scale=s), _rand(torch, gen, m, c, scale=0.02),
            _rand(torch, gen, m, c, c, k, scale=s), _rand(torch, gen, m, c, scale=0.02))


def _bounds_cases(torch, n):
    return {
        "none": None,
        # row 1 ends 3000 samples early: its last tiles are dead
        "one_sided": torch.tensor([n, n - 3000], dtype=torch.int32, device="cuda"),
        "two_sided": torch.tensor([[37, n - 401], [0, n // 3]], dtype=torch.int32, device="cuda"),
        # row 0 is empty (a stream window wholly past its end): every tile dead
        "empty": torch.tensor([[0, 0], [0, n]], dtype=torch.int32, device="cuda"),
    }


def _check_zero_outside(torch, name, case, bnd, n, outs) -> None:
    if bnd is None:
        return
    b2 = bnd if bnd.ndim == 2 else torch.stack([torch.zeros_like(bnd), bnd], 1)
    pos = torch.arange(n, device="cuda")
    outside = (pos[None] < b2[:, :1]) | (pos[None] >= b2[:, 1:])
    for g in outs:
        if not bool((g.masked_select(outside[:, None, :]) == 0).all()):
            raise AssertionError(f"{name} {case}: nonzero output outside [lo, hi)")


def _chain_work(c, n, live, ks, outputs, convs=6, elem=4) -> tuple:
    """(bytes, flops) of `convs` convs of C channels per kernel size in
    `ks`: x (1, C, n) read once, `outputs` (1, C, n) written once, the
    weights and biases read once, `elem` bytes each (4 fp32, 2 bf16);
    2*C*C*k flops per conv and live sample."""
    weights = sum(convs * (c * c * k + c) for k in ks)
    return elem * (c * n * (1 + outputs) + weights), sum(2 * c * c * k * convs * live
                                                         for k in ks)


def _whole_call_ms(fn, symbol=None, counter=None, prefix="") -> dict:
    """device_ms of fn() with its kernels per call required: the count per
    call that two torch.profiler windows agree on (timing.call_kernels).
    For a wrapper (`symbol`, `counter`) its kernels by symbol per call must
    equal the launches its counter sees in one call, so the count is the
    wrapper's launches plus its weight-layout, bounds and mask launches;
    for a plain version it is the plain version's kernels. A window of the
    timed calls with another count is profiled again, then raises."""
    from piper_tpu_torch.tools.timing import call_kernels, device_ms

    total, named = call_kernels(fn, symbol)
    if counter is not None:
        before = counter.launches
        fn()
        launched = counter.launches - before
        if named != launched:
            raise AssertionError(f"{symbol}: {named} kernels per call in the profiler's "
                                 f"windows, {launched} launched")
    return {f"{prefix}device_ms": device_ms(fn, expected=total),
            f"{prefix}device_kernels": total}


def _tier_row(torch, name, tier, run, cases, n, x1, bnd1, work, launches_per_call,
              **fields) -> dict:
    """Check run(x, bounds, kernel, tier) against its plain version at
    `tier` on every bounds case, then time both at a batch of one: `ms` by
    CUDA events (the host's time where it is the slower), `device_ms` under
    torch.profiler (the whole wrapper: weight layout, fold copies and
    launches; `device_kernels` per call required, `_whole_call_ms`), and
    `kernel_device_ms`, the ResBlock1 kernel alone, whose
    `launches_per_call` launches per call the profiler must count. `work` is
    the timed call's (bytes, flops), for the least time the card could take
    at the tier's rate."""
    from piper_tpu_torch.tools.timing import TIER_FLOPS, bound_ms, device_ms, event_ms

    errs = {}
    for case, (x2, bnd) in cases.items():
        got = run(x2, bnd, True, tier)
        torch.cuda.synchronize()
        want = run(x2, bnd, False, tier)
        errs[case] = max(float((g - w).abs().max()) for g, w in zip(got, want))
        _check_zero_outside(torch, name, case, bnd, n, got)
    worst = max(errs.values())
    if not worst <= KERNEL_ATOL[tier]:
        raise AssertionError(f"{name} {tier}: max-abs {worst} > {KERNEL_ATOL[tier]} ({errs})")

    def kernel():
        return run(x1, bnd1, True, tier)

    def plain():
        return run(x1, bnd1, False, tier)

    row = {"max_abs_err": worst, "ms": event_ms(kernel), "plain_ms": event_ms(plain),
           **_whole_call_ms(kernel, RESBLOCK_SYMBOL, _counters()[name]),
           "kernel_device_ms": device_ms(kernel, name=RESBLOCK_SYMBOL,
                                         expected=launches_per_call),
           **_whole_call_ms(plain, prefix="plain_"), "design": RESBLOCK_DESIGN[tier]}
    row["bound_ms"], row["bound_by"] = bound_ms(*work, TIER_FLOPS[tier])
    emit(phase="kernel", name=name, precision=tier, samples=n, batch_timed=1, errs=errs,
         atol=KERNEL_ATOL[tier], **row, **fields)
    return row


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version on the card (TF32 off), at
    every tier: {kernel: {tier: row}}."""
    from piper_tpu_torch.ops.kernels import folded as K4
    from piper_tpu_torch.ops.kernels import resblock as R
    from piper_tpu_torch.ops.kernels.precision import fp32_exact
    from piper_tpu_torch.tools import tier_checksums

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

            def run(x, bnd, kernel, tier):
                if name == "resblock1_mrf":
                    fn = R.resblock1_mrf if kernel else R.resblock1_mrf_plain
                    return [fn(x, branches, bounds=bnd, precision=tier)]
                fn = R.resblock1_branch if kernel else R.resblock1_branch_plain
                return [fn(x, *br[:4], kernel=br[4], dilations=br[5], bounds=bnd,
                           precision=tier) for br in branches]

            cases = {case: (x2, bnd) for case, bnd in _bounds_cases(torch, n).items()}
            x1 = x2[:1].contiguous()
            bnd1 = torch.tensor([n - 100], dtype=torch.int32, device="cuda")
            work = _chain_work(c, n, n - 100, (3, 7, 11), outputs=3 if c == 64 else 1)
            results[name] = {tier: _tier_row(
                torch, name, tier, run, cases, n, x1, bnd1, work, 3 if c == 64 else 1,
                channels=c,
                note="ms covers the 3 branch launches of one level" if c == 64 else
                "ms covers one launch (3 branches + mean)") for tier in TIERS}
        results["conv1d_same"] = _conv1d_same_check(torch, gen)
        results["conv1d_same_wide"] = _conv1d_wide_check(torch, gen)
        _refused_widths_check(torch)
        _bf16_kernel_rows(torch, gen, results)
        results["resblock1_mrf_folded"] = _folded_check(torch, gen, K4, R)
        results["interleave"] = _interleave_check(torch, gen)
        results["threefry_normal"] = _threefry_check(torch)
        # K2-K4's outputs at the bf16 tiers, to hold against another
        # checkout's on the same card (tools/tier_checksums.py).
        emit(phase="checksums", checksums=tier_checksums.checksums())
    return results


def _bf16_row(torch, name, call, cases, n, x1, bnd1, work, per_call, atol, default_row,
             **fields) -> dict:
    """One of K1-K3 on bf16 activations at "default" (the "bfloat16" mode):
    call(x, bounds, variant) -> outputs, variant "kernel" (the wrapper on
    bf16 x, weights and biases), "plain" (its plain version) or "fp32" (the
    fp32-input "default" kernel on the same bf16 values, its output rounded
    to bf16). On every bounds case the kernel's output is bf16, bit-equal
    or within one bf16 ulp of "fp32" (the same products summed in the same
    order), and within `atol` plus one ulp of "plain" (sums in another
    order, then each rounded to bf16). Timed at a batch of one beside the
    fp32-input "default" row (`default_row`): `device_ms` the whole wrapper
    (its kernels per call required), `kernel_device_ms` the bf16 kernels
    alone by their symbol (`__nv_bfloat16`, `per_call` of them per call)."""
    from piper_tpu_torch.ops.kernels.precision import bf16_ulp, bf16_ulps
    from piper_tpu_torch.tools.timing import TIER_FLOPS, bound_ms, device_ms, event_ms

    errs, excess, ulps = {}, {}, {}
    for case, (x2, bnd) in cases.items():
        got = call(x2, bnd, "kernel")
        torch.cuda.synchronize()
        if any(g.dtype != torch.bfloat16 for g in got):
            raise AssertionError(f"{name} bf16: output dtype {[g.dtype for g in got]}")
        want, ref = call(x2, bnd, "plain"), call(x2, bnd, "fp32")
        errs[case] = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        excess[case] = max(float(((g.float() - w.float()).abs() - bf16_ulp(
            torch.maximum(g.float().abs(), w.float().abs()))).max()) for g, w in zip(got, want))
        ulps[case] = max(bf16_ulps(g, r) for g, r in zip(got, ref))
        if name != "conv1d_same":  # K1 masks its input, not its output
            _check_zero_outside(torch, name, case, bnd, n, got)
    if not max(excess.values()) <= atol:
        raise AssertionError(f"{name} bf16 vs plain: {excess} past one bf16 ulp > {atol}")
    if not max(ulps.values()) <= 1.0:
        raise AssertionError(f"{name} bf16 vs the fp32-input kernel: {ulps} bf16 ulps > 1")

    def kernel():
        return call(x1, bnd1, "kernel")

    def plain():
        return call(x1, bnd1, "plain")

    symbol = K1_SYMBOL if name == "conv1d_same" else RESBLOCK_SYMBOL
    row = {"max_abs_err": max(errs.values()), "excess_over_one_ulp": max(excess.values()),
           "ulps_vs_fp32_input": max(ulps.values()), "ms": event_ms(kernel),
           "plain_ms": event_ms(plain), **_whole_call_ms(kernel, symbol, _counters()[name]),
           "kernel_device_ms": device_ms(kernel, name="__nv_bfloat16", expected=per_call),
           **_whole_call_ms(plain, prefix="plain_"),
           "design": BF16_DESIGN["conv1d_same" if name == "conv1d_same" else "resblock"],
           "default_fp32_device_ms": default_row["device_ms"],
           "default_fp32_kernel_device_ms": default_row["kernel_device_ms"], **fields}
    row["bound_ms"], row["bound_by"] = bound_ms(*work, TIER_FLOPS["default"])
    emit(phase="kernel", name=name, precision="bfloat16", samples=n, batch_timed=1,
         errs=errs, ulps=ulps, atol=atol, **row)
    return row


def _bf16_kernel_rows(torch, gen, results) -> None:
    """K1-K3 on bf16 activations at the main paths' shapes (K2 medium level
    2, K3 level 3, K1 x_low's levels 1 and 2, 128 frames): each kernel's
    "bfloat16" row into results[name] (`_bf16_row`). K1's row also times
    the two PyTorch calls that compute its function on bf16 tensors,
    leaky_relu then F.conv1d (`library_ms`), and sums its two levels."""
    import torch.nn.functional as F

    from piper_tpu_torch.ops.kernels import conv as K1
    from piper_tpu_torch.ops.kernels import resblock as R
    from piper_tpu_torch.tools.timing import device_ms

    bf = torch.bfloat16
    dils = (1, 3, 5)
    for name, c, n in (("resblock1_branch", 64, 128 * 128), ("resblock1_mrf", 32, 128 * 256)):
        branches = [tuple(t.to(bf) for t in _branch_weights(torch, gen, c, k)) + (k, dils)
                    for k in (3, 7, 11)]
        fp32 = [tuple(t.float() for t in br[:4]) + br[4:] for br in branches]

        def call(x, bnd, variant, name=name, branches=branches, fp32=fp32):
            brs = fp32 if variant == "fp32" else branches
            xin = x.float() if variant == "fp32" else x
            if name == "resblock1_mrf":
                fn = R.resblock1_mrf_plain if variant == "plain" else R.resblock1_mrf
                outs = [fn(xin, brs, bounds=bnd, precision="default")]
            else:
                fn = R.resblock1_branch_plain if variant == "plain" else R.resblock1_branch
                outs = [fn(xin, *br[:4], kernel=br[4], dilations=br[5], bounds=bnd,
                           precision="default") for br in brs]
            return [o.to(bf) for o in outs]

        x2 = _rand(torch, gen, 2, c, n, scale=0.3).to(bf)
        cases = {case: (x2, bnd) for case, bnd in _bounds_cases(torch, n).items()}
        bnd1 = torch.tensor([n - 100], dtype=torch.int32, device="cuda")
        work = _chain_work(c, n, n - 100, (3, 7, 11), outputs=3 if c == 64 else 1, elem=2)
        results[name]["bfloat16"] = _bf16_row(
            torch, name, call, cases, n, x2[:1].contiguous(), bnd1, work,
            3 if c == 64 else 1, KERNEL_ATOL["default"], results[name]["default"], channels=c)

    total = None
    for level, c, n in ((1, 64, 128 * 64), (2, 32, 128 * 256)):
        convs = [(_rand(torch, gen, c, c, k, scale=(c * k) ** -0.5).to(bf),
                  _rand(torch, gen, c, scale=0.02).to(bf), k, d) for k, d in X_LOW_CONVS]

        def call(x, bnd, variant, convs=convs):
            if variant == "fp32":
                return [K1.conv1d_same(x.float(), w.float(), b.float(), dilation=d,
                                       act_slope=0.1, bounds=bnd, precision="default").to(bf)
                        for w, b, k, d in convs]
            fn = K1.conv1d_same_plain if variant == "plain" else K1.conv1d_same
            return [fn(x, w, b, dilation=d, act_slope=0.1, bounds=bnd, precision="default")
                    for w, b, k, d in convs]

        x2 = _rand(torch, gen, 2, c, n, scale=0.3).to(bf)
        cases = {case: (x2, bnd) for case, bnd in _bounds_cases(torch, n).items()}
        x1 = x2[:1].contiguous()
        work = _chain_work(c, n, n, [k for k, _ in X_LOW_CONVS], outputs=6, convs=1, elem=2)
        row = _bf16_row(torch, "conv1d_same", call, cases, n, x1, None, work, len(convs),
                        K1_ATOL, {"device_ms": None, "kernel_device_ms": None},
                        level=level, channels=c)

        def library(x1=x1, convs=convs):
            return [F.conv1d(F.leaky_relu(x1, 0.1), w, b, padding=(k - 1) // 2 * d, dilation=d)
                    for w, b, k, d in convs]

        row["library_ms"] = device_ms(library)
        if total is None:
            total = dict(row, level="1+2")
        else:
            total["max_abs_err"] = max(total["max_abs_err"], row["max_abs_err"])
            total["excess_over_one_ulp"] = max(total["excess_over_one_ulp"],
                                               row["excess_over_one_ulp"])
            total["ulps_vs_fp32_input"] = max(total["ulps_vs_fp32_input"],
                                              row["ulps_vs_fp32_input"])
            for key in ("ms", "plain_ms", "device_ms", "kernel_device_ms", "plain_device_ms",
                        "bound_ms", "library_ms"):
                total[key] += row[key]
    total["channels"] = "64+32"
    total["default_fp32_device_ms"] = results["conv1d_same"]["default"]["device_ms"]
    total["default_fp32_kernel_device_ms"] = results["conv1d_same"]["default"][
        "kernel_device_ms"]
    results["conv1d_same"]["bfloat16"] = total


def _folded_check(torch, gen, K4, R) -> dict:
    """K4 at the probe's two levels (C=64 at fold 2, C=32 at fold 4, so F*C
    = 128 rows) and N = 128 frames' samples less 3 (not a multiple of the
    fold), every tier, against its plain version and bit for bit against K3
    on the same input; timed at C=32 (medium level 3)."""
    dils = (1, 3, 5)
    rows = {}
    for c, n, fold in ((64, 128 * 128 - 3, 2), (32, 128 * 256 - 3, 4)):
        branches = [(*_branch_weights(torch, gen, c, k), k, dils) for k in (3, 7, 11)]
        x2 = _rand(torch, gen, 2, c, n, scale=0.3)

        def run(x, bnd, kernel, tier):
            fn = K4.resblock1_mrf_folded if kernel else K4.resblock1_mrf_folded_plain
            return [fn(x, branches, fold=fold, bounds=bnd, precision=tier)]

        cases = {case: (x2, bnd) for case, bnd in _bounds_cases(torch, n).items()}
        for tier in TIERS:
            bnd = cases["two_sided"][1]
            if not torch.equal(run(x2, bnd, True, tier)[0],
                               R.resblock1_mrf(x2, branches, bounds=bnd, precision=tier)):
                raise AssertionError(f"resblock1_mrf_folded C={c} fold {fold} {tier}: "
                                     f"differs from resblock1_mrf on the same input")
        x1 = x2[:1].contiguous()
        bnd1 = torch.tensor([n - 100], dtype=torch.int32, device="cuda")
        work = _chain_work(c, n, n - 100, (3, 7, 11), outputs=1)
        level = {tier: _tier_row(torch, "resblock1_mrf_folded", tier, run, cases, n, x1, bnd1,
                                 work, 1, channels=c, fold=fold, equal_to_k3=True,
                                 note="ms covers fold + one launch + unfold")
                 for tier in TIERS}
        if c == 32:
            rows = level
    return rows


def _conv1d_same_check(torch, gen) -> dict:
    """K1 at x_low's levels 1 (C=64) and 2 (C=32), 128 frames, every tier:
    every (k, d) of the ResBlock2 convs, B=2 at the level's N with act_slope
    0.1 and each bounds case, and at a ragged N with act_slope 0, within
    K1_ATOL; then B=1 timed per level (6 launches, no bounds;
    `kernel_device_ms` counts the 6 kernels of each call). Returns {tier:
    the two levels' worst error and summed times}."""
    from piper_tpu_torch.ops.kernels import conv as K1
    from piper_tpu_torch.tools.timing import TIER_FLOPS, bound_ms, device_ms, event_ms

    total = {t: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0,
                 "kernel_device_ms": 0.0, "plain_device_ms": 0.0, "bound_ms": 0.0,
                 "design": K1_DESIGN[t]} for t in TIERS}
    for level, c, n in ((1, 64, 128 * 64), (2, 32, 128 * 256)):
        convs = [(_rand(torch, gen, c, c, k, scale=(c * k) ** -0.5),
                  _rand(torch, gen, c, scale=0.02), k, d) for k, d in X_LOW_CONVS]
        x2 = _rand(torch, gen, 2, c, n, scale=0.3)
        bounds = {**_bounds_cases(torch, n), "empty_and_full": torch.tensor(
            [[500, 500], [0, n]], dtype=torch.int32, device="cuda")}
        inputs = [(f"act_{case}", x2, 0.1, bnd) for case, bnd in bounds.items()]
        inputs.append(("ragged_no_act", _rand(torch, gen, 2, c, n - 77, scale=0.3), 0.0, None))
        x1 = _rand(torch, gen, 1, c, n, scale=0.3)
        for tier in TIERS:
            errs = {}
            for case, xin, slope, bnd in inputs:
                for w, b, k, d in convs:
                    got = K1.conv1d_same(xin, w, b, dilation=d, act_slope=slope, bounds=bnd,
                                         precision=tier)
                    torch.cuda.synchronize()
                    want = K1.conv1d_same_plain(xin, w, b, dilation=d, act_slope=slope,
                                                bounds=bnd, precision=tier)
                    if got.shape != want.shape:
                        raise AssertionError(f"conv1d_same {case} k={k} d={d}: {got.shape}")
                    errs[f"{case}_k{k}_d{d}"] = float((got - want).abs().max())
                    if case == "act_empty":
                        _check_k1_empty(torch, K1, xin, w, b, d, bnd, got, tier)
            worst = max(errs.values())
            if not worst <= K1_ATOL:
                raise AssertionError(f"conv1d_same level {level} {tier}: max-abs {worst} > "
                                     f"{K1_ATOL} ({errs})")

            def run(kernel):
                fn = K1.conv1d_same if kernel else K1.conv1d_same_plain
                return [fn(x1, w, b, dilation=d, act_slope=0.1, precision=tier)
                        for w, b, k, d in convs]

            row = {"max_abs_err": worst, "ms": event_ms(lambda: run(True)),
                   "plain_ms": event_ms(lambda: run(False)),
                   **_whole_call_ms(lambda: run(True), K1_SYMBOL, K1.conv1d_same),
                   "kernel_device_ms": device_ms(lambda: run(True), name=K1_SYMBOL,
                                                 expected=len(convs)),
                   **_whole_call_ms(lambda: run(False), prefix="plain_")}
            # One input read and six outputs written, as the timed call does
            # (six convs of x1); the weights once; 2*C*C*k flops per sample.
            work = _chain_work(c, n, n, [k for k, _ in X_LOW_CONVS], outputs=6, convs=1)
            row["bound_ms"], row["bound_by"] = bound_ms(*work, TIER_FLOPS[tier])
            emit(phase="kernel", name="conv1d_same", precision=tier, level=level, channels=c,
                 samples=n, batch_timed=1, errs=errs, atol=K1_ATOL, design=K1_DESIGN[tier],
                 **row, note="ms covers the 6 launches of one level")
            t = total[tier]
            t["max_abs_err"] = max(t["max_abs_err"], worst)
            t["bound_by"] = row["bound_by"]
            for key in ("ms", "plain_ms", "device_ms", "kernel_device_ms", "plain_device_ms",
                        "bound_ms"):
                t[key] += row[key]
    return total


def _conv1d_wide_check(torch, gen) -> dict:
    """K1's wide design (csrc/conv1d_wide.cu) at a high voice's wide
    levels, C=256 (2,560 samples a row) and C=128 (20,480), at "highest"
    and "high": each of a level's 18 convs (k 3/7/11 at dilations 1/3/5,
    then each branch's dense conv adding the running sum,
    `conv1d_probe.WIDE_CONVS`) at B=2 with act_slope 0.1 under each bounds
    case and at a ragged N with no bounds, within K1_ATOL of its plain
    version, an empty row exactly its bias (plus the residual). Then the 18
    convs timed at SERVING_BATCH rows, no bounds: the wrapper (`ms`,
    `device_ms`), its 18 kernels alone by symbol (`kernel_device_ms`), the
    plain version, and `library_ms`, the route before the wide design
    (leaky_relu, F.conv1d, the residual added; TF32 off); `bound_ms` from
    those inputs (`conv1d_probe._wide_bound`). Returns {tier: the two
    levels' worst error and summed times}."""
    import torch.nn.functional as F

    from piper_tpu_torch.ops.kernels import conv as K1
    from piper_tpu_torch.tools.conv1d_probe import WIDE_CONVS, _wide_bound
    from piper_tpu_torch.tools.timing import device_ms, event_ms

    symbol = "conv1d_same_wide"
    keys = ("ms", "plain_ms", "device_ms", "kernel_device_ms", "plain_device_ms", "bound_ms",
            "library_ms")
    total = {t: {"max_abs_err": 0.0, **{k: 0.0 for k in keys}, "design": K1_DESIGN[t]}
             for t in ("highest", "high")}
    for level, c, per_frame in WIDE_LEVELS:
        n = per_frame * WIDE_FRAMES
        convs = [(_rand(torch, gen, c, c, k, scale=(c * k) ** -0.5),
                  _rand(torch, gen, c, scale=0.02), k, d, r) for k, d, r in WIDE_CONVS]
        x2, res2 = _rand(torch, gen, 2, c, n, scale=0.3), _rand(torch, gen, 2, c, n, scale=0.5)
        bounds = {"none": None,
                  "one_sided": torch.tensor([n, n - n // 5], dtype=torch.int32, device="cuda"),
                  "two_sided": torch.tensor([[37, n - 401], [0, n // 3]], dtype=torch.int32,
                                            device="cuda"),
                  "empty": torch.tensor([[0, 0], [0, n]], dtype=torch.int32, device="cuda")}
        inputs = [(case, x2, res2, bnd) for case, bnd in bounds.items()]
        ragged = n - 77
        inputs.append(("ragged", _rand(torch, gen, 2, c, ragged, scale=0.3),
                       _rand(torch, gen, 2, c, ragged, scale=0.5), None))
        xb = _rand(torch, gen, SERVING_BATCH, c, n, scale=0.3)
        resb = _rand(torch, gen, SERVING_BATCH, c, n, scale=0.5)

        def library():
            return [F.conv1d(F.leaky_relu(xb, 0.1), w, b, padding=(k - 1) // 2 * d,
                             dilation=d) + (resb if r else 0) for w, b, k, d, r in convs]

        library_ms = device_ms(library)
        for tier in ("highest", "high"):
            errs = {}
            for case, xin, res, bnd in inputs:
                for w, b, k, d, r in convs:
                    kw = dict(dilation=d, act_slope=0.1, bounds=bnd,
                              residual=res if r else None, precision=tier)
                    launched = K1.conv1d_same.wide_launches
                    got = K1.conv1d_same(xin, w, b, **kw)
                    torch.cuda.synchronize()
                    if K1.conv1d_same.wide_launches != launched + 1:
                        raise AssertionError(f"conv1d_same C={c} {tier}: not the wide design")
                    want = K1.conv1d_same_plain(xin, w, b, **kw)
                    key = f"{case}_k{k}_d{d}" + ("_res" if r else "")
                    errs[key] = max(errs.get(key, 0.0), float((got - want).abs().max()))
                    if case == "empty" and not r:
                        _check_k1_empty(torch, K1, xin, w, b, d, bnd, got, tier)
                    elif case == "empty" and not torch.equal(got[0], res[0] + b[:, None]):
                        raise AssertionError(f"conv1d_same C={c} {tier} k={k}: the empty "
                                             f"row is not its residual plus its bias")
            worst = max(errs.values())
            if not worst <= K1_ATOL:
                raise AssertionError(f"conv1d_same wide C={c} {tier}: max-abs {worst} > "
                                     f"{K1_ATOL} ({errs})")

            def run(fn, tier=tier):
                return [fn(xb, w, b, dilation=d, act_slope=0.1, residual=resb if r else None,
                           precision=tier) for w, b, k, d, r in convs]

            row = {"max_abs_err": worst, "ms": event_ms(lambda: run(K1.conv1d_same)),
                   "plain_ms": event_ms(lambda: run(K1.conv1d_same_plain)),
                   **_whole_call_ms(lambda: run(K1.conv1d_same), K1_SYMBOL, K1.conv1d_same),
                   "kernel_device_ms": device_ms(lambda: run(K1.conv1d_same), name=symbol,
                                                 expected=len(convs)),
                   **_whole_call_ms(lambda: run(K1.conv1d_same_plain), prefix="plain_"),
                   "library_ms": library_ms}
            row["bound_ms"], row["bound_by"] = _wide_bound(c, SERVING_BATCH, n, tier)
            emit(phase="kernel", name="conv1d_same_wide", precision=tier, level=level,
                 channels=c, samples=n, batch_timed=SERVING_BATCH, errs=errs, atol=K1_ATOL,
                 design=K1_DESIGN[tier], **row,
                 note="ms covers the level's 18 launches; library_ms is leaky_relu, F.conv1d "
                      "and the residual added, TF32 off")
            t = total[tier]
            t["max_abs_err"] = max(t["max_abs_err"], worst)
            t["bound_by"] = row["bound_by"]
            for key in keys:
                t[key] += row[key]
    return total


# The vocoder of a voice whose ResBlock1 levels are C=48 and C=24 (the
# `test` voice's shape at upsample_initial_channel 96), against itself with
# every kernel wrapper's plain version: the fp32 waveform bar at "highest",
# the lowered tiers' gate at "high", and in bf16 a few bf16 ulps of the
# level activations (~4, an ulp of 2^-6), as tests/test_torch_cuda.py says.
REFUSED_ATOL = {"highest": WAVE_ATOL, "high": MIXED_ATOL, "bfloat16": 5e-2}
# K1's launches per call: two convs at two dilations a level on K1 (C=24
# at every tier, C=48 at "high" and "default"); at "highest" K2 takes C=48.
REFUSED_LAUNCHES = {"highest": (4, 1), "high": (8, 0), "bfloat16": (8, 0)}


def _refused_widths_check(torch) -> None:
    """Fault 1's route: widths the K2/K3 stage refuses (C=24 at every tier,
    C=48 at "high" and "default") run conv by conv through K1
    (models/vits/hifigan.py::_level), never cuDNN. The 48/24 voice's
    vocoder at "highest", "high" and in the "bfloat16" mode (bf16 weights
    and activations, the kernels at "default"), masked with bounds as a
    decode runs it: K1's and K2's launches per call, K3 none, finite, and
    within REFUSED_ATOL of its plain version."""
    from dataclasses import replace

    from piper_tpu_torch.models.vits import hifigan
    from piper_tpu_torch.models.vits.hparams import PRESETS
    from piper_tpu_torch.models.vits.params import params_to_torch
    from piper_tpu_torch.models.vits.synthetic import synthetic_params
    from piper_tpu_torch.ops.kernels import conv as K1
    from piper_tpu_torch.ops.kernels import resblock as R

    hp = replace(PRESETS["test"], upsample_initial_channel=96)
    weights = synthetic_params(hp, seed=21)
    frames = 64
    z32 = torch.randn(2, hp.inter_channels, frames,
                      generator=torch.Generator().manual_seed(21)).to("cuda")
    lengths = torch.tensor([frames, 41], dtype=torch.int32, device="cuda")
    wrappers = ((K1, "conv1d_same", K1.conv1d_same_plain),
                (hifigan, "resblock1_branch", R.resblock1_branch_plain),
                (hifigan, "resblock1_mrf", R.resblock1_mrf_plain))
    for mode in REFUSED_ATOL:
        dtype = torch.bfloat16 if mode == "bfloat16" else torch.float32
        params = params_to_torch(weights, "cuda", dtype)
        z = z32.to(dtype)
        mask = (torch.arange(frames, device="cuda")[None] < lengths[:, None]).to(dtype)[:, None]

        def run(params=params, z=z, mask=mask, mode=mode):
            return hifigan.hifigan_generator(
                z * mask, params, hp, t_mask=mask, t_bounds=lengths,
                level_precisions=None if mode == "bfloat16" else mode)

        before = [K1.conv1d_same.launches, R.resblock1_branch.launches,
                  R.resblock1_mrf.launches]
        got = run()
        torch.cuda.synchronize()
        launched = (K1.conv1d_same.launches - before[0],
                    R.resblock1_branch.launches - before[1])
        if launched != REFUSED_LAUNCHES[mode] or R.resblock1_mrf.launches != before[2]:
            raise AssertionError(f"refused widths {mode}: K1, K2 launched {launched}, "
                                 f"expected {REFUSED_LAUNCHES[mode]} and no K3")
        kept = [(mod, name, getattr(mod, name)) for mod, name, _ in wrappers]
        try:
            for mod, name, plain in wrappers:
                setattr(mod, name, plain)
            want = run()
        finally:
            for mod, name, fn in kept:
                setattr(mod, name, fn)
        err = float((got.float() - want.float()).abs().max())
        if not (bool(torch.isfinite(got).all()) and err <= REFUSED_ATOL[mode]):
            raise AssertionError(f"refused widths {mode}: max-abs {err} against the plain "
                                 f"version > {REFUSED_ATOL[mode]}")
        emit(phase="kernel", name="conv1d_same", case="refused_widths_48_24", mode=mode,
             k1_launches=launched[0], k2_launches=launched[1], max_abs_err=err,
             atol=REFUSED_ATOL[mode], samples=int(got.shape[-1]))


def _check_k1_empty(torch, K1, x, w, b, d, bnd, got, tier) -> None:
    """K1 on an empty row (bounds [0, 0]): its input is all zero, so its
    output is exactly the bias, and exactly zero without one (K1 masks its
    input, not its output, as JAX's conv on the masked input)."""
    bare = K1.conv1d_same(x, w, None, dilation=d, act_slope=0.1, bounds=bnd, precision=tier)
    if not (torch.equal(got[0], b[:, None].expand_as(got[0]))
            and int(torch.count_nonzero(bare[0])) == 0):
        raise AssertionError(f"conv1d_same {tier} d={d}: the empty row is not its bias / zero")


def _interleave_check(torch, gen) -> dict:
    """K5 at the medium voice's four upsample levels, 128 frames: level i
    interleaves r = rate phases of c = its output channels over q = the
    level's input samples + kr - 1 (the polyphase conv's 'full' output).
    Bit-equal to its plain version (a permutation) at B=1 and at B=2 with a
    ragged q; timed as the four launches of one utterance at B=1. The plain
    version is one PyTorch call (the copy behind permute().reshape()), so
    its time is also the library yardstick."""
    from piper_tpu_torch.ops.kernels import interleave as K5
    from piper_tpu_torch.tools.timing import bound_ms, event_ms

    ys, errs, t_in = [], {}, 128
    for level, (r, k, c) in enumerate(MEDIUM_UPSAMPLE):
        q = t_in + -(-k // r) - 1
        for b, qq in ((1, q), (2, q - 77)):
            y = _rand(torch, gen, b, r, c, qq, scale=1.0)
            got = K5.interleave(y)
            torch.cuda.synchronize()
            want = K5.interleave_plain(y)
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"interleave level {level} B={b} q={qq}: differs from "
                                     f"its plain version")
            errs[f"level{level}_b{b}_q{qq}"] = float((got - want).abs().max())
            if b == 1:
                ys.append(y)
        t_in *= r

    def run(kernel):
        fn = K5.interleave if kernel else K5.interleave_plain
        return [fn(y) for y in ys]

    row = {"max_abs_err": max(errs.values()), "ms": event_ms(lambda: run(True)),
           "plain_ms": event_ms(lambda: run(False)),
           **_whole_call_ms(lambda: run(True), K5_SYMBOL, K5.interleave),
           **_whole_call_ms(lambda: run(False), prefix="plain_")}
    row["bound_ms"], row["bound_by"] = bound_ms(sum(2 * 4 * y.numel() for y in ys))
    emit(phase="kernel", name="interleave", shapes=[list(y.shape) for y in ys], batch_timed=1,
         errs=errs, atol=0.0, **row, note="ms covers the 4 launches of one medium utterance "
         "at 128 frames; plain_device_ms is also library_ms (one PyTorch call)")
    return {"highest": row}


# The seeded draw's normals against its plain version on the card: CUDA's
# log1pf and the kernel's fused Horner steps against PyTorch's log1p and
# the plain version's once-rounded float64 steps, an ulp or two of values
# up to ~5.5. Its bits and uniforms are held bit-equal.
THREEFRY_ATOL = 2e-6
THREEFRY_FRAMES = 256  # the prior row's frame bucket (medium at f=8)


def _threefry_check(torch) -> dict:
    """The seeded draw (`ops/kernels/prng.py::threefry_normal`) against
    its plain version on the card in its three layouts: a (192, F) prior
    row (one seed), per_frame_noise (2, 192, 126: one seed, a stream
    window's frames from -47) and per_row_frame_noise (4, 192, 256: per-row
    seeds and frames on the card); bits and uniforms bit-equal, normals
    within THREEFRY_ATOL; and the kernel against the plain version run on
    the CPU. Timed by tools/noise_probe.py at the prior row and the
    per-row windows, beside torch.randn of the same shape."""
    from piper_tpu_torch.ops.kernels import prng
    from piper_tpu_torch.tools import noise_probe
    from piper_tpu_torch.tools.timing import event_ms

    dev = torch.device("cuda")
    cases = noise_probe.draw_cases(torch, THREEFRY_FRAMES)
    cases["per_frame"] = (7, 1, 2, 192, torch.arange(-47, 79, device=dev))
    errs = {}
    for case, (seed, stream, rows, n, fr) in cases.items():
        for output in ("bits", "uniform", "normal"):
            got = prng.threefry_normal(seed, stream, rows, n, fr, device=dev, output=output)
            torch.cuda.synchronize()
            want = prng.threefry_normal_plain(seed, stream, rows, n, fr, device=dev,
                                              output=output)
            if got.shape != want.shape:
                raise AssertionError(f"threefry_normal {case} {output}: {tuple(got.shape)} "
                                     f"vs {tuple(want.shape)}")
            if output != "normal" and not torch.equal(got, want):
                raise AssertionError(f"threefry_normal {case}: its {output} differ from the "
                                     f"plain version's")
        errs[case] = float((got - want).abs().max())
        cpu = prng.threefry_normal_plain(seed.cpu() if isinstance(seed, torch.Tensor) else seed,
                                         stream, rows, n, None if fr is None else fr.cpu())
        errs[f"{case}_vs_cpu"] = float((got.cpu() - cpu).abs().max())
    worst = max(errs.values())
    if not worst <= THREEFRY_ATOL:
        raise AssertionError(f"threefry_normal: max-abs {worst} > {THREEFRY_ATOL} ({errs})")
    draws = noise_probe.time_draws(torch, THREEFRY_FRAMES, REPS)
    seed, stream, rows, n, _ = cases["prior"]
    prior = draws["prior"]
    row = {"max_abs_err": worst, "device_ms": prior["kernel_ms"],
           "plain_device_ms": prior["plain_ms"], "randn_ms": prior["randn_ms"],
           "bound_ms": prior["bound_ms"], "bound_by": prior["bound_by"],
           "ms": event_ms(lambda: prng.threefry_normal(seed, stream, rows, n, device=dev)),
           "plain_ms": event_ms(lambda: prng.threefry_normal_plain(seed, stream, rows, n,
                                                                   device=dev)),
           "draws": draws}
    emit(phase="kernel", name="threefry_normal", errs=errs, atol=THREEFRY_ATOL, **row,
         note="ms covers one (192, 256) prior draw; draws also times the (4, 192, 256) "
              "per-row windows")
    return {"highest": row}


def _counters():
    from piper_tpu_torch.ops.kernels import conv as K1
    from piper_tpu_torch.ops.kernels import folded as K4
    from piper_tpu_torch.ops.kernels import interleave as K5
    from piper_tpu_torch.ops.kernels import resblock as R

    from piper_tpu_torch.ops.kernels import prng

    return {"resblock1_branch": R.resblock1_branch, "resblock1_mrf": R.resblock1_mrf,
            "conv1d_same": K1.conv1d_same, "conv1d_same_wide": _WideCounter(),
            "resblock1_mrf_folded": K4.resblock1_mrf_folded,
            "interleave": K5.interleave, "threefry_normal": prng.threefry_normal}


class _WideCounter:
    """K1's wide launches (`conv1d_same.wide_launches`) behind the
    `launches` attribute every other counter has."""

    @property
    def launches(self) -> int:
        from piper_tpu_torch.ops.kernels import conv as K1

        return K1.conv1d_same.wide_launches

    @launches.setter
    def launches(self, n: int) -> None:
        from piper_tpu_torch.ops.kernels import conv as K1

        K1.conv1d_same.wide_launches = n


def _zero_counts() -> dict:
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def _require_launches(path: str, counters: dict) -> dict:
    """Read the counts; every kernel of `path` must have launched."""
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, (_, _, paths) in KERNELS.items():
        if path in paths and launches[name] <= 0:
            raise AssertionError(f"the {path} path launched {name} no time")
    return launches


def _voice(path: str) -> str:
    """The voice of a path: medium, high or x_low."""
    return next(v for v in LAUNCHES_PER_CALL if path.startswith(v))


def _require_per_call(path: str, launches: dict, calls: int) -> None:
    """Each vocoder kernel of the path's voice launched exactly its count
    per synthesis call, `calls` times: K1's with the wide levels' convs,
    and K1's wide design those alone, outside the bf16 paths (none there)."""
    want = dict(LAUNCHES_PER_CALL[_voice(path)])
    want["conv1d_same_wide"] = 0 if "bf16" in path else WIDE_LAUNCHES_PER_CALL[_voice(path)]
    want["conv1d_same"] = want.get("conv1d_same", 0) + want["conv1d_same_wide"]
    for name, n in want.items():
        if launches[name] != n * calls:
            raise AssertionError(f"{path}: {launches[name]} {name} launches for {calls} calls, "
                                 f"expected {n} each")


def phase_main_path(torch, path: str, model, config, options=None, factors=FACTORS,
                    runs=({},), reps=REPS) -> tuple:
    """A main path: synthesize() on the card for one voice and options, at
    each factor, once per speaker keyword set of `runs` (speaker_id or
    speaker_mix; {} for none). Every launch count is set to 0 just before
    the timed run and read just after; each kernel of this path must have
    launched."""
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime

    t0 = time.perf_counter()
    rt = PiperRuntime(model, config, options, device="cuda")
    load_s = time.perf_counter() - t0
    for f in factors:  # first call per shape: cuDNN heuristics, allocator
        for spk in runs:
            rt.synthesize(FIXTURE_PHONEME_IDS * f, **spk)

    counters = _zero_counts()
    rows = []
    for f in factors:
        ids = FIXTURE_PHONEME_IDS * f
        for spk in runs:
            walls, timings = [], []
            for _ in range(reps):
                pcm = rt.synthesize(ids, **spk)
                t = rt.last_run_timings
                walls.append(t.wall_ms)
                timings.append(t)
                if pcm.dtype.name != "float32" or len(pcm) != t.frames * rt.hparams.hop_length:
                    raise AssertionError(f"{path} f={f} {spk}: {pcm.dtype} length {len(pcm)} "
                                         f"!= {t.frames} frames * {rt.hparams.hop_length}")
                if not np.isfinite(pcm).all() or not 0 < float(np.abs(pcm).max()) <= 1.0:
                    raise AssertionError(f"{path} f={f} {spk}: output not finite / not in "
                                         f"(0, 1]")
            t = timings[-1]
            rows.append({"factor": f, **{k: str(v) for k, v in spk.items()},
                         "phonemes": len(ids), "ms_median": statistics.median(walls),
                         "ms_all": walls, "encode_ms": t.encode_ms, "decode_ms": t.decode_ms,
                         "frames": t.frames, "frame_bucket": t.frame_bucket,
                         "audio_s": t.samples / rt.sample_rate, "rtf": t.rtf})
    launches = _require_launches(path, counters)
    utterances = len(factors) * len(runs) * reps
    _require_per_call(path, launches, utterances)
    o, hp = rt.options, rt.hparams
    voice = f"synthetic {rt.config.audio.quality}, seed 0"
    if hp.n_speakers > 1:
        voice += f", {hp.n_speakers} speakers, gin {hp.gin_channels}"
    emit(phase="main_path", path=path, voice=voice,
         precision=o.precision, vocoder_precision=o.vocoder_precision,
         flow_precision=o.flow_precision, load_s=load_s, sample_rate=rt.sample_rate,
         hop=hp.hop_length, rows=rows, utterances=utterances, launches=launches)
    return rt, launches


def _injected_noise(hp, n_ids: int):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, n_ids)).astype(np.float32),
            rng.standard_normal((hp.inter_channels, 64)).astype(np.float32))


def _speaker_lists(spk: dict) -> dict:
    """synthesize()'s speaker keyword as the batch keywords of one row."""
    return {"speaker_ids": [spk["speaker_id"]] if "speaker_id" in spk else None,
            "speaker_mixes": [spk["speaker_mix"]] if "speaker_mix" in spk else None}


def phase_compare(torch, path: str, rt, other, atol: float, against: str, **spk) -> None:
    """f=1 with the same injected noise and speaker (`spk`: speaker_id or
    speaker_mix): runtime rt against `other` (the port on the CPU, or
    another configuration on the card); w_ceil equal and the waveform
    within atol."""
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS

    ids = FIXTURE_PHONEME_IDS
    dp_noise, main_noise = _injected_noise(rt.hparams, len(ids))
    wc = rt._durations([ids], dp_noise=dp_noise[None], **_speaker_lists(spk))[1]
    wc_other = other._durations([ids], dp_noise=dp_noise[None], **_speaker_lists(spk))[1]
    if not np.array_equal(wc, wc_other):
        raise AssertionError(f"{path}: w_ceil differs: {wc} vs {against} {wc_other}")
    a = rt.synthesize(ids, dp_noise=dp_noise, main_noise=main_noise, **spk)
    b = other.synthesize(ids, dp_noise=dp_noise, main_noise=main_noise, **spk)
    if a.shape != b.shape:
        raise AssertionError(f"{path}: lengths differ: {a.shape} vs {against} {b.shape}")
    err = float(np.abs(a - b).max())
    if not err <= atol:
        raise AssertionError(f"{path}: waveform vs {against} max-abs {err} > {atol}")
    _note_mixed(path, f"vs {against} {spk}", err, atol)
    emit(phase="compare", path=path, against=against, factor=1, w_ceil_equal=True,
         frames=int(wc.sum()), samples=int(a.shape[0]), max_abs_err=err, atol=atol,
         **{k: str(v) for k, v in spk.items()})


def phase_profile(torch, runtimes: dict) -> None:
    """The method of PERF.md §5, per runtime and factor 1 and 8
    (tools/conv1d_probe.py::profile_utterance): the median wall of REPS
    unprofiled utterances, then one utterance under torch.profiler: its
    device kernels, their summed device time (device busy), and the voice's
    vocoder kernels' time and launches, by symbol (VOCODER_KERNELS: K2 + K3
    for medium, K1 for x_low), which must equal the launches their counters
    saw."""
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.tools.conv1d_probe import profile_utterance

    counters = _counters()
    for path, rt in runtimes.items():
        symbol, names = VOCODER_KERNELS[path.split("_mixed")[0]]
        for f in (1, 8):
            row = profile_utterance(rt, FIXTURE_PHONEME_IDS * f, symbol,
                                    [counters[name] for name in names], REPS)
            emit(phase="profile", path=path, factor=f, kernels=list(names), **row,
                 vocoder_precision=rt.options.vocoder_precision)


def phase_golden(path: str, rt, speakers: bool = False) -> dict:
    """rt on the card against the committed JAX goldens of its voice, f=1
    and 8 (with `speakers`, the multi-speaker voice's speaker goldens):
    w_ceil equal, the waveform within 1e-4 at fp32, 1e-3 mixed."""
    from piper_tpu_torch import golden

    quality = _voice(path)
    keys = (golden.SPEAKER_GOLDENS if speakers else
            [(quality, f, None) for f in golden.factors(quality)])
    counters = _zero_counts()
    rows = [golden.check(rt, *key) for key in keys]
    launches = _require_launches(f"{path}_golden", counters)
    for r in rows:
        _note_mixed(path, f"golden f={r['factor']} {r['speaker'] or ''}".strip(),
                    r["max_abs_err"], r["atol"])
    emit(phase="golden", path=path, rows=rows, launches=launches)
    return launches


SEEDED_CPU_SEED = 2 ** 32 - 5  # the seed of the card-against-CPU check


def phase_seeded(torch, rt, model, config) -> dict:
    """Seeded synthesis draws JAX's noise (`seeded`; medium, fp32): the
    card's own threefry draws against the committed seeded goldens (the JAX
    package's synthesize and incremental stream at their seed: `w_ceil`
    equal, within 1e-4), with every launch count set to 0 just before and
    read just after; then the port's CPU run against its card run at one
    seed (durations equal, the waveform and a stream within 1e-4); then the
    device kernels of one seeded call (tools/noise_probe.py: medium mixed,
    fused 1x1, and one 224-id stream), the threefry kernels among them."""
    from piper_tpu_torch import golden
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime
    from piper_tpu_torch.tools import noise_probe

    t0 = time.perf_counter()
    counters = _zero_counts()
    rows = [golden.check_seeded(rt, q, f) for q, f in golden.SEEDED_GOLDENS]
    rows.append(golden.check_seeded(rt, *golden.STREAM_GOLDEN[:2], stream=True))
    launches = _require_launches("seeded", counters)
    cpu = PiperRuntime(model, config, device="cpu")
    ids, seed = FIXTURE_PHONEME_IDS * 2, SEEDED_CPU_SEED
    plans = [np.asarray(r.phoneme_durations([ids], seed=seed)[0]) for r in (rt, cpu)]
    if not np.array_equal(*plans):
        raise AssertionError(f"seeded: card durations {plans[0]} vs cpu {plans[1]}")
    a, b = rt.synthesize(ids, seed=seed), cpu.synthesize(ids, seed=seed)
    if a.shape != b.shape:
        raise AssertionError(f"seeded: card {a.shape} vs cpu {b.shape}")
    wave_err = float(np.abs(a - b).max())
    sa, sb = (np.concatenate([c.samples for c in r.synthesize_stream_incremental(
        ids, seed=seed, chunk_frames=16)]) for r in (rt, cpu))
    stream_err = float(np.abs(sa - sb).max()) if sa.shape == sb.shape else None
    if not (wave_err <= WAVE_ATOL and stream_err is not None and stream_err <= WAVE_ATOL):
        raise AssertionError(f"seeded: card vs cpu max-abs {wave_err} (stream {stream_err}) "
                             f"> {WAVE_ATOL}")
    per_call = noise_probe.kernels_per_call((model, config))
    for key, r in per_call.items():
        if r["threefry_kernels"] <= 0:
            raise AssertionError(f"seeded: {key} launched no threefry kernel")
    emit(phase="seeded", goldens=rows, launches=launches, cpu_seed=seed,
         cpu_w_ceil_equal=True, cpu_max_abs_err=wave_err, cpu_stream_max_abs_err=stream_err,
         kernels_per_call=per_call, wall_s=time.perf_counter() - t0)
    return launches


def _note_mixed(path: str, what: str, err: float, atol: float) -> None:
    """Keep a comparison held to the mixed gate for the margin line."""
    if atol == MIXED_ATOL:
        MIXED_MARGINS.append({"path": path, "what": what, "max_abs_err": err,
                              "within_target": err <= MIXED_TARGET})


def _rows_close(path: str, what: str, got, want, atol: float) -> float:
    """Rows of equal lengths within atol; their worst max-abs."""
    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            raise AssertionError(f"{path} {what}: row {i} has {g.shape[0]} samples, "
                                 f"its single run {w.shape[0]}")
        errs.append(float(np.abs(g - w).max()))
    if not max(errs) <= atol:
        raise AssertionError(f"{path} {what}: max-abs {errs} > {atol}")
    _note_mixed(path, what, max(errs), atol)
    return max(errs)


def phase_batch(path: str, rt, atol: float, serving: bool) -> dict:
    """The batch paths on the card, each row held within `atol`, the
    tier's bar: 1e-4 at fp32, 1e-3 at the mixed tiers, where cuDNN's TF32
    convs around the kernels pick their algorithms by the batch's shape
    (4.7e-4 to 6.1e-4 between B=4 and B=1 on the H100). (b) four injected
    rows of f = 1/2/4/8 (dp noise zero past each row's length) through
    _synthesize_batch_impl, each against its one-row injected run: per-row
    bounds and dead tiles at B>1. With `serving`, first (a) 32 identical
    f=8 rows of synthesize_batch, each against one synthesize with the same
    seed and as long (on a length mismatch the message gives the pre-ceil
    durations' distance to an integer); then (c) B=32 throughput blocking
    and through ServingPipeline.submit_batch (8 batches) and (d) one
    profiled B=32 batch, its vocoder kernels counted against their counters
    (`bench.measure_throughput`). (a) and (b) check each vocoder kernel's
    launches per call."""
    from piper_tpu_torch import bench
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS

    kw = dict(noise_scale=None, length_scale=None, noise_w=None, speaker_ids=None)
    counters = _zero_counts()
    row, calls = {}, 0
    if serving:
        ids8 = FIXTURE_PHONEME_IDS * 8
        t0 = time.perf_counter()
        batch = rt.synthesize_batch([ids8] * SERVING_BATCH, seed=7)
        batch_ms = (time.perf_counter() - t0) * 1e3
        single = rt.synthesize(ids8, seed=7)
        calls += 2
        if any(len(a) != len(single) for a in batch):
            w_b = rt._durations([ids8] * SERVING_BATCH, seed=7)[0]
            w_1 = rt._durations([ids8], seed=7)[0]
            raise AssertionError(
                f"{path} (a): batch rows' lengths {sorted({len(a) for a in batch})} vs "
                f"{len(single)}; pre-ceil durations' distance to an integer "
                f"{float(np.abs(w_1 - np.round(w_1)).min())}, batch vs single "
                f"{float(np.abs(w_b - w_1).max())}")
        row["identical_rows"] = {"rows": SERVING_BATCH, "phonemes": len(ids8),
                                 "samples": len(single), "first_call_ms": batch_ms,
                                 "max_abs_err": _rows_close(path, "(a)", batch,
                                                            [single] * SERVING_BATCH, atol),
                                 "atol": atol}
    rows = [FIXTURE_PHONEME_IDS * f for f in FACTORS]
    rng = np.random.default_rng(1)
    width = max(len(r) for r in rows)
    dp = rng.standard_normal((len(rows), 2, width)).astype(np.float32)
    for i, r in enumerate(rows):
        dp[i, :, len(r):] = 0.0
    mn = rng.standard_normal((len(rows), rt.hparams.inter_channels, 64)).astype(np.float32)
    got, t = rt._synthesize_batch_impl(rows, dp_noise=dp, main_noise=mn, **kw)
    one = [rt._synthesize_batch_impl([r], dp_noise=dp[i:i + 1, :, :len(r)],
                                     main_noise=mn[i:i + 1], **kw)[0][0]
           for i, r in enumerate(rows)]
    calls += 1 + len(rows)
    row["mixed_lengths"] = {"factors": list(FACTORS), "samples": [len(a) for a in got],
                            "frame_bucket": t.frame_bucket,
                            "max_abs_err": _rows_close(path, "(b)", got, one, atol),
                            "atol": atol}
    launches = _require_launches(f"{path}_batch", counters)
    _require_per_call(path, launches, calls)
    if serving:
        row["throughput"] = bench.measure_throughput(rt, SERVING_BATCH, iters=5)
        row["throughput_pipelined"] = bench.measure_throughput_pipelined(rt, SERVING_BATCH, 8)
        launches = {name: fn.launches for name, fn in counters.items()}
    emit(phase="batch", path=path, **row, launches=launches)
    return launches


def phase_pipeline(model, config) -> dict:
    """32 ServingPipeline.submit requests (f = 1/2, seeds 0..31) on a
    fused-mode medium runtime at the bench's mixed tiers, each equal to the
    same runtime's synthesize with its seed."""
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.pipeline import ServingPipeline
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions

    rt = PiperRuntime(model, config, RuntimeOptions(mode="fused", **BENCH_MIX), device="cuda")
    reqs = [(FIXTURE_PHONEME_IDS * (1 + i % 2), i) for i in range(32)]
    want = [rt.synthesize(ids, seed=s) for ids, s in reqs]
    counters = _zero_counts()
    t0 = time.perf_counter()
    with ServingPipeline(rt, max_inflight=16, num_fetchers=8) as pipe:
        got = [f.result(timeout=300) for f in [pipe.submit(ids, seed=s) for ids, s in reqs]]
    wall = time.perf_counter() - t0
    launches = _require_launches("pipeline", counters)
    _require_per_call("medium", launches, len(reqs))
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g, w):
            raise AssertionError(f"pipeline: request {i} differs from its fused synthesize")
    emit(phase="pipeline", requests=len(reqs), mode="fused", fused_keys=sorted(
        str(k) for k in rt._compiled_keys), ms_per_utt=wall / len(reqs) * 1e3,
        launches=launches)
    return launches


def phase_high(torch) -> dict:
    """The high preset (five upsample levels; K3 at C=32 and C=16, K2 at
    C=64) at fp32 and mixed, f=1: timed as a main path, fp32 held against
    the port on the CPU within 1e-4, mixed against fp32 within 1e-3."""
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

    model, config = make_synthetic_voice(ROOT / "build" / "chip_smoke_voice_high",
                                         quality="high", seed=0)
    rt, launches = phase_main_path(torch, "high", model, config, factors=(1,))
    phase_compare(torch, "high", rt, PiperRuntime(model, config, device="cpu"), WAVE_ATOL, "cpu")
    rt_mixed, mixed = phase_main_path(torch, "high_mixed", model, config,
                                      RuntimeOptions(**BENCH_MIX), factors=(1,))
    phase_compare(torch, "high_mixed", rt_mixed, rt, MIXED_ATOL, "card highest")
    return {name: launches[name] + mixed[name] for name in launches}


def _ms_checks(path: str, rt, atol: float) -> dict:
    """On one configuration of the multi-speaker voice: the speaker goldens,
    one-hot mixes bit-equal to their ids, a B=32 batch of f=8 rows with
    speaker ids 0, 29, 58, ... against four of its rows run alone (and a
    4-row batch of mixes of f = 8/1/4/2 against its rows), both with
    injected noise, and forced durations. Each part zeroes the launch
    counts first and requires K2/K3 on its path."""
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS

    ids, ids8 = FIXTURE_PHONEME_IDS, FIXTURE_PHONEME_IDS * 8
    total = {}

    def add(launches):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

    add(phase_golden(path, rt, speakers=True))

    onehot = {}
    for k in (0, 903):
        a = rt.synthesize(ids8, speaker_id=k, seed=3)
        b = rt.synthesize(ids8, speaker_mix={k: 1.0}, seed=3)
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{path}: the one-hot mix of speaker {k} differs from its id")
        onehot[k] = len(a)

    counters = _zero_counts()
    sids = [i * 29 % MS_SPEAKERS for i in range(SERVING_BATCH)]
    rng = np.random.default_rng(2)
    dp = rng.standard_normal((SERVING_BATCH, 2, len(ids8))).astype(np.float32)
    mn = rng.standard_normal((SERVING_BATCH, rt.hparams.inter_channels, 384)).astype(np.float32)
    kw = dict(noise_scale=None, length_scale=None, noise_w=None)
    t0 = time.perf_counter()
    batch, _ = rt._synthesize_batch_impl([ids8] * SERVING_BATCH, dp_noise=dp, main_noise=mn,
                                         speaker_ids=sids, **kw)
    batch_ms = (time.perf_counter() - t0) * 1e3
    picked = sorted({0, 1, SERVING_BATCH // 2 + 1, SERVING_BATCH - 1})
    solo = [rt._synthesize_batch_impl([ids8], dp_noise=dp[i:i + 1], main_noise=mn[i:i + 1],
                                      speaker_ids=[sids[i]], **kw)[0][0] for i in picked]
    mixes = [dict(spk["speaker_mix"]) for spk in MS_RUNS if "speaker_mix" in spk]
    mixes += [{5: 0.5, 6: 0.5}, {903: 1.0}]
    mix_rows = [ids8, ids, ids * 4, ids * 2]
    dp4 = dp[:4].copy()
    for i, r in enumerate(mix_rows):
        dp4[i, :, len(r):] = 0.0
    mixed_batch, _ = rt._synthesize_batch_impl(mix_rows, dp_noise=dp4, main_noise=mn[:4],
                                               speaker_ids=None, speaker_mixes=mixes, **kw)
    mixed_solo = [rt._synthesize_batch_impl([r], dp_noise=dp4[i:i + 1, :, :len(r)],
                                            main_noise=mn[i:i + 1], speaker_ids=None,
                                            speaker_mixes=[mixes[i]], **kw)[0][0]
                  for i, r in enumerate(mix_rows)]
    add(_require_launches(f"{path}_batch", counters))
    batch_row = {"rows": SERVING_BATCH, "speaker_ids": sids, "first_call_ms": batch_ms,
                 "compared_rows": list(picked),
                 "max_abs_err": _rows_close(path, "ids batch", [batch[i] for i in picked],
                                            solo, atol),
                 "mixes_max_abs_err": _rows_close(path, "mixes batch", mixed_batch,
                                                  mixed_solo, atol), "atol": atol}
    emit(phase="batch", path=path, **batch_row, onehot_bit_equal=onehot)

    counters = _zero_counts()
    forced = []
    for spk in (MS_RUNS[2], MS_RUNS[3]):
        durs = rt.phoneme_durations([ids8], seed=4, **_speaker_lists(spk))[0]
        ref = rt.synthesize(ids8, seed=4, **spk)
        got = rt.synthesize_forced(ids8, [int(d) for d in durs], seed=4, **spk)
        if got.shape != ref.shape:
            raise AssertionError(f"{path} forced {spk}: {got.shape} vs synthesize {ref.shape}")
        err = float(np.abs(got - ref).max())
        bar = FORCED_ATOL if atol == WAVE_ATOL else atol
        if not err <= bar:
            raise AssertionError(f"{path} forced {spk}: max-abs {err} > {bar}")
        _note_mixed(path, f"forced plan {spk}", err, bar)
        forced.append({**{k: str(v) for k, v in spk.items()}, "frames": int(durs.sum()),
                       "max_abs_err": err, "atol": bar})
    # Every plan's total in the 256-frame bucket: the seeded prior noise is
    # drawn at the bucket's width, so a solo run shares its batch row's
    # realization only at the batch's bucket.
    plans = [[15] * len(ids), [40] * 6, [9, 0, 12] * 10, [2] * len(ids8)]
    rows_f = [ids, ids[:6], (ids * 3)[:30], ids8]
    f_sids = [903, 0, 451, 17]
    got = rt.synthesize_batch_forced(rows_f, plans, speaker_ids=f_sids, seed=5)
    want = [rt.synthesize_forced(r, d, speaker_id=k, seed=5)
            for r, d, k in zip(rows_f, plans, f_sids)]
    hop = rt.hparams.hop_length
    if [len(a) for a in got] != [sum(d) * hop for d in plans]:
        raise AssertionError(f"{path} forced batch: lengths {[len(a) for a in got]}")
    batch_err = _rows_close(path, "forced batch", got, want, atol)
    add(_require_launches(f"{path}_forced", counters))
    emit(phase="forced", path=path, predicted_plan=forced, batch_rows=len(rows_f),
         batch_max_abs_err=batch_err, atol=atol)
    return total


def phase_multispeaker(torch) -> dict:
    """The bench's multi-speaker voice (medium, 904 speakers, gin 512) at
    fp32 and at the mixed tiers, split mode: utterances of MS_RUNS' speaker
    ids and mixes at f=1 and 8 (a main path each, 3 of each after a
    warm-up), the card against the port on the CPU (fp32,
    an id and a mix, 1e-4), the mixed run against the fp32 one (1e-3), and
    _ms_checks on each."""
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

    model, config = make_synthetic_voice(ROOT / "build" / "chip_smoke_voice_medium_ms",
                                         quality="medium", seed=0, n_speakers=MS_SPEAKERS,
                                         gin_channels=MS_GIN)
    total = {}

    def add(launches):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

    rt, counts = phase_main_path(torch, "medium_ms", model, config, factors=(1, 8),
                                 runs=MS_RUNS, reps=3)
    add(counts)
    cpu = PiperRuntime(model, config, device="cpu")
    for spk in (MS_RUNS[2], MS_RUNS[3]):
        phase_compare(torch, "medium_ms", rt, cpu, WAVE_ATOL, "cpu", **spk)
    del cpu
    add(_ms_checks("medium_ms", rt, WAVE_ATOL))
    rt_mixed, counts = phase_main_path(torch, "medium_ms_mixed", model, config,
                                       RuntimeOptions(**BENCH_MIX), factors=(1, 8),
                                       runs=MS_RUNS, reps=3)
    add(counts)
    phase_compare(torch, "medium_ms_mixed", rt_mixed, rt, MIXED_ATOL, "card highest",
                  **MS_RUNS[3])
    add(_ms_checks("medium_ms_mixed", rt_mixed, MIXED_ATOL))
    return total


def phase_bench() -> dict:
    """The port's bench at --quick on the card (medium, the JAX bench's
    defaults: mixed tiers, fused mode, int16, B=32), its golden rows
    included. It prints its own JSON line; its keys must be the root
    bench's."""
    from piper_tpu_torch import bench

    keys = {"metric", "value", "unit", "vs_baseline", "rows", "throughput",
            "throughput_pipelined", "batch_sweep", "pipeline", "high", "multispeaker",
            "streaming", "streaming_server", "roofline", "platform", "device", "golden"}
    counters = _zero_counts()
    result = bench.main(["--quick"])
    launches = _require_launches("bench", counters)
    if not keys <= set(result) or result["metric"] != "rtf_per_chip" or \
            result["platform"] != "gpu" or not result["value"] > 0:
        raise AssertionError(f"bench: keys {sorted(result)}")
    if not all(r["ok"] for r in result["golden"]):
        raise AssertionError(f"bench: golden {result['golden']}")
    ms = result["multispeaker"]
    if ms is None or ms["n_speakers"] != 8 or not ms["rtf_throughput"] > 0:
        raise AssertionError(f"bench: multispeaker {ms}")
    emit(phase="bench", rtf_per_chip=result["value"], multispeaker=ms, launches=launches)
    return launches


def _stream_chunks(path: str, chunks, hop: int) -> np.ndarray:
    """A stream's chunks: offsets contiguous, the last one final and no
    other, every one but the last a whole number of frames. Returns the
    concatenated audio."""
    sizes = [len(c.samples) for c in chunks]
    if [c.start_sample_index for c in chunks] != [sum(sizes[:i]) for i in range(len(sizes))]:
        raise AssertionError(f"{path}: chunk offsets not contiguous")
    if [c.is_final for c in chunks] != [False] * (len(chunks) - 1) + [True]:
        raise AssertionError(f"{path}: is_final {[c.is_final for c in chunks]}")
    if any(n % hop for n in sizes[:-1]):
        raise AssertionError(f"{path}: chunk sizes {sizes}")
    return np.concatenate([c.samples for c in chunks])


def phase_stream(torch, path: str, rt, atol: float) -> dict:
    """Incremental streaming on the card (`{path}_stream`; each window
    launches the voice's vocoder kernels their count per call):

    (a) the voice's f=8 JAX golden (ids, dp_noise, main_noise) streamed at
        the growing schedule and at 16-frame windows: the concatenation
        within `atol` of the golden's audio;
    (b) a seeded stream of the bench's 224-id utterance, fused head against
        the split path, within FUSED_SPLIT_ATOL;
    (c) dispatch_stream_head and the speculative window 1 (on the
        device-held frame count) under torch.cuda.set_sync_debug_mode
        ("error"), window 1 equal to the stream's second chunk;
    (d) dispatch_stream_head_batch of 4 streams in one bucket, row r against
        the solo head at its seed, and one dispatch_window_batch (rows at
        different offsets, row 3 wholly past its end) against each row's
        solo window: within `atol`, row 3 exactly zero.

    Then the bench's streaming row (bench.measure_streaming: TTFB and total
    p50, one profiled stream), the head's device busy time, and the head's
    wall alone (dispatch, copy, wait; p50 of REPS)."""
    from piper_tpu_torch import bench, golden
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.models.vits.hparams import receptive_field_frames
    from piper_tpu_torch.tools.timing import profile_call

    name = f"{path}_stream"
    hop, halo = rt.hparams.hop_length, receptive_field_frames(rt.hparams)
    g = golden.load(_voice(path), 8)
    counters = _zero_counts()
    windows, row = 0, {"halo": halo}

    goldens = []
    for kw in ({}, {"chunk_frames": 16}):
        chunks = list(rt.synthesize_stream_incremental(
            g["ids"].tolist(), dp_noise=g["dp_noise"], main_noise=g["main_noise"], **kw))
        windows += len(chunks)
        audio = _stream_chunks(name, chunks, hop)
        if audio.shape != g["audio"].shape:
            raise AssertionError(f"{name} golden {kw}: {audio.shape} vs {g['audio'].shape}")
        err = float(np.abs(audio - g["audio"]).max())
        if not err <= atol:
            raise AssertionError(f"{name} golden {kw}: max-abs {err} > {atol}")
        _note_mixed(name, f"golden {kw}", err, atol)
        goldens.append({"schedule": kw.get("chunk_frames", "growing"), "chunks": len(chunks),
                        "samples": len(audio), "max_abs_err": err, "atol": atol})
    row["golden"] = goldens

    ids_long = (FIXTURE_PHONEME_IDS * 16)[:4096]
    fused = list(rt.synthesize_stream_incremental(ids_long, seed=7))
    split = list(rt.synthesize_stream_incremental(ids_long, seed=7, fused_head=False))
    windows += len(fused) + len(split)
    a, b = _stream_chunks(name, fused, hop), _stream_chunks(name, split, hop)
    if [len(c.samples) for c in fused] != [len(c.samples) for c in split]:
        raise AssertionError(f"{name}: fused and split chunk sizes differ")
    err = float(np.abs(a - b).max())
    if not err <= FUSED_SPLIT_ATOL:
        raise AssertionError(f"{name}: fused head vs split max-abs {err} > {FUSED_SPLIT_ATOL}")
    row["fused_vs_split"] = {"chunks": len(fused), "samples": len(a), "max_abs_err": err,
                             "atol": FUSED_SPLIT_ATOL}

    stream = list(rt.synthesize_stream_incremental(ids_long, seed=3))
    windows += len(stream)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        enc, _, total, seed_t, ns = rt.dispatch_stream_head(ids_long, c0=STREAM_C0, halo=halo,
                                                            seed=3)
        spec1 = rt.dispatch_window_batch(enc, seed_t, [STREAM_C0 - halo], total, [ns],
                                         emit_frames=2 * STREAM_C0, halo=halo)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    windows += 2
    err = float(np.abs(spec1[0].cpu().numpy() - stream[1].samples).max())
    if len(stream[1].samples) != spec1.shape[1] or not err <= FUSED_SPLIT_ATOL:
        raise AssertionError(f"{name}: window 1 dispatched alone vs the stream's chunk 1: "
                             f"{err}")
    row["sync_free_dispatch"] = {"checked": ["dispatch_stream_head", "dispatch_window_batch"],
                                 "window1_vs_stream_max_abs_err": err}

    ids2 = FIXTURE_PHONEME_IDS * 2
    rows = [ids2, ids2[:20], ids2[3:], ids2[1:25]]  # one phoneme bucket, 32, alone or together
    seeds = [11, 12, 13, 14]
    enc, audio0, totals, seed_vals, ns_vals = rt.dispatch_stream_head_batch(
        rows, c0=STREAM_C0, halo=halo, seeds=seeds)
    y_len = totals.cpu().numpy()
    # window 1, a window over frame 0, one crossing its row's end, one wholly past it
    t_off = np.array([STREAM_C0 - halo, 5 - halo, int(y_len[2]) - STREAM_C0 // 2 - halo,
                      int(y_len[3]) + 1])
    batch = rt.dispatch_window_batch(enc, seed_vals, t_off, y_len, ns_vals,
                                     emit_frames=STREAM_C0, halo=halo).cpu().numpy()
    windows += 2
    head_errs, window_errs = [], []
    for r, ids in enumerate(rows):
        e1, a1, t1, s1, ns1 = rt.dispatch_stream_head(ids, c0=STREAM_C0, halo=halo,
                                                      seed=seeds[r])
        solo = rt.dispatch_window_batch(e1, s1, t_off[r:r + 1], t1, [ns1],
                                        emit_frames=STREAM_C0, halo=halo)
        windows += 2
        head_errs.append(float((audio0[r] - a1[0, halo * hop: (halo + STREAM_C0) * hop])
                               .abs().max()))
        window_errs.append(float(np.abs(batch[r] - solo[0].cpu().numpy()).max()))
    if not max(head_errs + window_errs) <= atol or np.count_nonzero(batch[3]):
        raise AssertionError(f"{name}: batched head {head_errs} / window {window_errs} > "
                             f"{atol}, or the row past its end is not zero")
    _note_mixed(name, "batched heads and windows vs solo", max(head_errs + window_errs), atol)
    row["batched"] = {"rows": len(rows), "frames": y_len.tolist(), "t_offsets": t_off.tolist(),
                      "head_max_abs_err": max(head_errs), "window_max_abs_err": max(window_errs),
                      "row_past_end_zero": True, "atol": atol}

    launches = _require_launches(name, counters)
    _require_per_call(name, launches, windows)
    symbol, names = VOCODER_KERNELS[_voice(path)]
    head = profile_call(lambda: rt.dispatch_stream_head(ids_long, c0=STREAM_C0, halo=halo),
                        symbol, [_counters()[n] for n in names])
    row["head_device_busy_ms"] = head["device_busy_ms"]
    row["head_device_kernels"] = head["device_kernels"]
    row["streaming"] = bench.measure_streaming(rt, REPS)
    # The head alone to its audio on the host: the first chunk's time were
    # window 1 queued after the fetch, not before it.
    walls = []
    for i in range(REPS):
        t0 = time.perf_counter()
        rt.dispatch_stream_head(ids_long, c0=STREAM_C0, halo=halo, seed=i)[1].cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
    row["head_wall_ms_p50"] = statistics.median(walls)
    emit(phase="stream", path=name, windows=windows, **row, launches=launches)
    return launches


def _pct(values, p):
    return float(np.percentile(values, p)) if values else None


def phase_serve(torch, voices: dict) -> dict:
    """The continuous batcher on the card: one MultiVoiceBatchingServer over
    the medium and x_low voices at the bench's mixed tiers, fused mode and
    int16 (serving_sim's runtime), prewarmed over the serving mix's grid.
    With every count at 0: SERVE_THREADS threads submit the seeded serving
    mix for SERVE_S seconds at SERVE_RATE requests/s in all, beside (a)
    zero-noise requests of f = 1/2/4/8 per voice, each held to the card's
    fp32 synthesize of the same ids at zero noise (int16 against the clipped
    float: the mixed gate, noted for the margin), and (b) submit_durations
    at noise_w=0, equal to the runtime's phoneme_durations. Before the
    prewarm, one group shape off the grid is timed at its first and next
    runs (what a first-seen shape costs). Every future
    must resolve, nothing fail or shed, K1 (x_low) and K2+K3 (medium)
    launch. Then close() must release each runtime's weights from the card
    (memory_allocated falls by >= 90% of hbm_bytes)."""
    import gc
    import threading

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.batcher import MultiVoiceBatchingServer
    from piper_tpu_torch.engine.bucketing import bucket_for
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu_torch.tools.serving_sim import LENGTH_MIX, run_traffic

    opts = RuntimeOptions(mode="fused", output_dtype="int16", **BENCH_MIX)
    runtimes = {q: PiperRuntime(*voices[q], opts, device="cuda") for q in ("medium", "x_low")}
    server = MultiVoiceBatchingServer(runtimes, max_batch=SERVE_MAX_BATCH, max_wait_ms=10.0)
    row = {}
    try:
        p_buckets = sorted({bucket_for(len((FIXTURE_PHONEME_IDS * f)[:4096]),
                                       runtimes["medium"].options.phoneme_buckets, "phoneme")
                            for f, _ in LENGTH_MIX})
        # What a (rows, frames) shape costs the first time it runs, against
        # its next runs: one fused group off the grid (3 rows, 128 frames).
        first_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            runtimes["medium"].fetch_batch(*runtimes["medium"].dispatch_batch(
                [FIXTURE_PHONEME_IDS * 4] * 3, fused=True, pad_rows_to=3, budget_frames=100))
            first_ms.append((time.perf_counter() - t0) * 1e3)
        row["first_seen_shape_ms"] = {"rows": 3, "frames": 128, "runs_ms": first_ms}
        t0 = time.perf_counter()
        warm = server.prewarm(p_buckets=p_buckets)
        row["prewarm"] = {"wall_s": time.perf_counter() - t0, **warm}
        zero = [(q, f) for q in runtimes for f in FACTORS]

        counters = _zero_counts()
        served: list = []
        keys = list(runtimes)

        def submit(rng, ids):
            return server.submit(keys[int(rng.integers(len(keys)))], ids)

        def submitter(i):
            served.append(run_traffic(submit, SERVE_S, np.random.default_rng(100 + i),
                                      SERVE_RATE / SERVE_THREADS, runtimes["medium"].sample_rate))

        threads = [threading.Thread(target=submitter, args=(i,), name=f"serve-client-{i}")
                   for i in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        zero_futs = [server.submit(q, FIXTURE_PHONEME_IDS * f, noise_scale=0.0, noise_w=0.0)
                     for q, f in zero]
        dur_futs = [server.submit_durations(q, FIXTURE_PHONEME_IDS * f, noise_w=0.0)
                    for q, f in zero]
        for t in threads:
            t.join()
        zero_audio = [fut.result(timeout=300) for fut in zero_futs]
        durs = [fut.result(timeout=300) for fut in dur_futs]
        launches = _require_launches("serve", counters)
        metrics = server.metrics()
    finally:
        server.close()
    for key, m in metrics.items():
        if m["failed"] or m["shed_overload"] or m["shed_deadline"]:
            raise AssertionError(f"serve: voice {key} failed or shed requests: {m}")
    if len(served) != SERVE_THREADS or any(sum(shed.values()) for _, _, _, shed in served):
        raise AssertionError(f"serve: a submitter failed or was shed: {[r[3] for r in served]}")
    lat = sorted(latency * 1e3 for results, _, _, _ in served for latency, _, _ in results)
    for pcm in zero_audio:
        if pcm.dtype != np.int16:
            raise AssertionError(f"serve: served {pcm.dtype}, not int16")

    errs = []
    fp32 = {q: PiperRuntime(*voices[q], device="cuda") for q in runtimes}
    for (q, f), got, d in zip(zero, zero_audio, durs):
        ids = FIXTURE_PHONEME_IDS * f
        want = np.clip(fp32[q].synthesize(ids, noise_scale=0.0, noise_w=0.0), -1.0, 1.0)
        if got.shape != want.shape:
            raise AssertionError(f"serve {q} f={f}: {got.shape} samples, fp32 {want.shape}")
        err = float(np.abs(got.astype(np.float32) / 32767.0 - want).max())
        if not err <= MIXED_ATOL:
            raise AssertionError(f"serve {q} f={f}: served vs fp32 max-abs {err} > {MIXED_ATOL}")
        _note_mixed(f"serve_{q}", f"served f={f} at zero noise vs fp32", err, MIXED_ATOL)
        plan = runtimes[q].phoneme_durations([ids], noise_w=0.0)[0]
        if not np.array_equal(d, plan):
            raise AssertionError(f"serve {q} f={f}: submit_durations {d} != phoneme_durations "
                                 f"{plan}")
        errs.append((q, f, err))

    released = {}
    for q, rt in runtimes.items():
        weights = rt.hbm_bytes()
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        rt.close()
        gc.collect()
        freed = before - torch.cuda.memory_allocated()
        if not (weights > 0 and freed >= 0.9 * weights and rt.closed):
            raise AssertionError(f"serve {q}: close() freed {freed} of {weights} weight bytes")
        released[q] = {"hbm_bytes": weights, "freed_bytes": freed}

    emit(phase="serve", voices=list(runtimes), rate_req_s=SERVE_RATE, threads=SERVE_THREADS,
         seconds=SERVE_S, requests=len(lat),
         latency_ms={"p50": _pct(lat, 50), "p95": _pct(lat, 95), "p99": _pct(lat, 99),
                     "max": lat[-1]},
         rows_per_group={q: m["rows_per_group"] for q, m in metrics.items()},
         groups={q: m["groups"] for q, m in metrics.items()},
         padded_rows={q: m["padded_rows"] for q, m in metrics.items()},
         wait_ms_mean={q: m["wait_ms_mean"] for q, m in metrics.items()},
         zero_noise_vs_fp32=[{"voice": q, "factor": f, "max_abs_err": e} for q, f, e in errs],
         durations_equal=True, released=released, **row, launches=launches)
    return launches


def _served_streams(name: str, rt, streams, atol: float, hop: int) -> float:
    """Each served stream [(ids, seed, chunks)]: chunks contiguous, the last
    final, the audio equal to the same-seed synthesize_stream_incremental
    on the card alone within `atol` (int16 compared as float / 32767; at
    the mixed tiers noted for the margin line). Returns the worst max-abs."""
    worst = 0.0
    for ids, seed, chunks in streams:
        got = _stream_chunks(name, chunks, hop)
        want = np.concatenate([c.samples for c in rt.synthesize_stream_incremental(
            ids, seed=seed)])
        if got.shape != want.shape:
            raise AssertionError(f"{name}: a stream of {len(ids)} ids, seed {seed}: "
                                 f"{got.shape} samples, alone {want.shape}")
        scale = 32767.0 if got.dtype == np.int16 else 1.0
        worst = max(worst, float(np.abs(got.astype(np.float32) - want.astype(np.float32))
                                 .max()) / scale)
    if not worst <= atol:
        raise AssertionError(f"{name}: served streams vs alone max-abs {worst} > {atol}")
    return worst


def phase_stream_serve(torch, path: str, rt, atol: float) -> dict:
    """Concurrent streams on the card (`{path}_stream_serve`): one
    StreamingServer over `rt` at STREAM_EMIT frames a window, prewarmed at
    the phrases' lengths. With every count at 0, STREAM_CLIENTS threads at
    once, client i streaming the fixture phrase x STREAM_FACTORS[i % 4]
    twice at its own seeds. Every stream must be contiguous and equal its
    same-seed synthesize_stream_incremental alone within `atol` (fp32 1e-4;
    the mixed tiers MIXED_TARGET, noted for the margin line); the windows
    must have batched rows (window_rows / window_dispatches > 1); each head
    and window dispatch must have launched the voice's vocoder kernels
    their count per call."""
    import threading

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.stream_server import StreamingServer

    name = f"{path}_stream_serve"
    hop = rt.hparams.hop_length
    srv = StreamingServer(rt, emit_frames=STREAM_EMIT)
    try:
        t0 = time.perf_counter()
        warm = srv.prewarm(phoneme_lengths=tuple(len(FIXTURE_PHONEME_IDS * f)
                                                 for f in STREAM_FACTORS),
                           row_rungs=tuple(r for r in srv.row_rungs if r <= STREAM_CLIENTS))
        warm["wall_s"] = time.perf_counter() - t0
        m0 = srv.metrics()
        counters = _zero_counts()
        served, ttfb, total, errors = [], [], [], []

        def client(i):
            try:
                for rep in range(2):
                    ids = FIXTURE_PHONEME_IDS * STREAM_FACTORS[i % len(STREAM_FACTORS)]
                    seed = 1000 + 10 * i + rep
                    t0c = time.perf_counter()
                    chunks = []
                    for chunk in srv.submit(ids, seed=seed):
                        if not chunks:
                            ttfb.append((time.perf_counter() - t0c) * 1e3)
                        chunks.append(chunk)
                    total.append((time.perf_counter() - t0c) * 1e3)
                    served.append((ids, seed, chunks))
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,), name=f"stream-client-{i}")
                   for i in range(STREAM_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = _require_launches(name, counters)
        m1 = srv.metrics()
    finally:
        srv.shutdown()
    if errors or len(served) != 2 * STREAM_CLIENTS:
        raise AssertionError(f"{name}: {len(served)} streams served, errors {errors}")
    m = {k: m1[k] - m0[k] for k in m0 if k != "open_sessions"}
    _require_per_call(name, launches, m["head_dispatches"] + m["window_dispatches"])
    if not m["window_rows"] > m["window_dispatches"]:
        raise AssertionError(f"{name}: windows not batched: {m}")
    bar = MIXED_TARGET if atol == MIXED_ATOL else atol
    err = _served_streams(name, rt, served, bar, hop)
    _note_mixed(name, "served streams vs alone", err, atol)
    audio_s = sum(sum(len(c.samples) for c in chunks) for _, _, chunks in served)
    audio_s /= rt.sample_rate
    emit(phase="stream_serve", path=name, clients=STREAM_CLIENTS, streams=len(served),
         factors=STREAM_FACTORS, emit_frames=STREAM_EMIT, c0=srv.c0, halo=srv.halo,
         ttfb_ms={"p50": _pct(ttfb, 50), "p95": _pct(ttfb, 95), "max": max(ttfb)},
         total_ms_p50=_pct(total, 50), wall_s=wall, audio_s=audio_s,
         aggregate_rtf=audio_s / wall,
         window_rows_per_dispatch=m["window_rows"] / m["window_dispatches"],
         max_abs_err=err, atol=bar, prewarm=warm, **m, launches=launches)
    return launches


def phase_unified(torch, voices: dict) -> dict:
    """Batch and stream traffic on one worker: a UnifiedServer of the medium
    and x_low voices at the mixed tiers (fused, int16, serving_sim's
    runtime), its batch grid and a stream grid prewarmed. With every count
    at 0: SERVE_THREADS threads submit the seeded serving mix for SERVE_S
    seconds at SERVE_RATE requests/s in all, zero-noise requests of f =
    1/2/4/8 per voice go in beside them, and the UNIFIED_STREAMS open during
    it, one thread each. Nothing may fail or be shed; the zero-noise rows
    must lie within ZERO_NOISE_ATOL of the card's fp32 synthesize, each
    stream within MIXED_TARGET of its synthesize_stream_incremental alone;
    K1-K3 must launch. Last, remove_voice("x_low", close_runtime=True):
    once its streams drained the worker closes the runtime, and
    memory_allocated falls by >= 90% of its hbm_bytes."""
    import gc
    import threading

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.bucketing import bucket_for
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu_torch.engine.unified import UnifiedServer
    from piper_tpu_torch.tools.serving_sim import LENGTH_MIX, run_traffic

    opts = RuntimeOptions(mode="fused", output_dtype="int16", **BENCH_MIX)
    runtimes = {q: PiperRuntime(*voices[q], opts, device="cuda") for q in ("medium", "x_low")}
    server = UnifiedServer(runtimes, max_batch=SERVE_MAX_BATCH, max_wait_ms=10.0,
                           stream_kwargs=dict(emit_frames=STREAM_EMIT))
    row = {}
    try:
        p_buckets = sorted({bucket_for(len((FIXTURE_PHONEME_IDS * f)[:4096]),
                                       runtimes["medium"].options.phoneme_buckets, "phoneme")
                            for f, _ in LENGTH_MIX})
        t0 = time.perf_counter()
        warm = server.prewarm(p_buckets=p_buckets, stream_kwargs=dict(
            phoneme_lengths=sorted({len(FIXTURE_PHONEME_IDS * f) for _, f, _ in UNIFIED_STREAMS}),
            row_rungs=(1, 2, 4), head_rungs=(1, 2)))
        row["prewarm"] = {"wall_s": time.perf_counter() - t0, **warm}
        zero = [(q, f) for q in runtimes for f in FACTORS]

        counters = _zero_counts()
        served, streams, errors = [], [], []
        keys = list(runtimes)
        t_start = time.perf_counter()

        def submit(rng, ids):
            return server.submit(keys[int(rng.integers(len(keys)))], ids)

        def submitter(i):
            served.append(run_traffic(submit, SERVE_S, np.random.default_rng(200 + i),
                                      SERVE_RATE / SERVE_THREADS, runtimes["medium"].sample_rate))

        def streamer(i, q, f, at):
            try:
                time.sleep(max(0.0, t_start + at - time.perf_counter()))
                ids, seed = FIXTURE_PHONEME_IDS * f, 2000 + i
                t0s = time.perf_counter()
                chunks = []
                for chunk in server.submit_stream(q, ids, seed=seed):
                    if not chunks:
                        ttfb = (time.perf_counter() - t0s) * 1e3
                    chunks.append(chunk)
                streams.append((q, ids, seed, chunks, ttfb))
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(repr(e))

        threads = ([threading.Thread(target=submitter, args=(i,), name=f"unified-client-{i}")
                    for i in range(SERVE_THREADS)]
                   + [threading.Thread(target=streamer, args=(i, *s), name=f"unified-stream-{i}")
                      for i, s in enumerate(UNIFIED_STREAMS)])
        for t in threads:
            t.start()
        zero_futs = [server.submit(q, FIXTURE_PHONEME_IDS * f, noise_scale=0.0, noise_w=0.0)
                     for q, f in zero]
        for t in threads:
            t.join()
        zero_audio = [fut.result(timeout=300) for fut in zero_futs]
        launches = _require_launches("unified", counters)
        metrics = server.metrics()
        if errors or len(streams) != len(UNIFIED_STREAMS):
            raise AssertionError(f"unified: {len(streams)} streams served, errors {errors}")
        for key, m in metrics["batch"].items():
            if m["failed"] or m["shed_overload"] or m["shed_deadline"]:
                raise AssertionError(f"unified: voice {key} failed or shed requests: {m}")
        if len(served) != SERVE_THREADS or any(sum(shed.values()) for *_, shed in served):
            raise AssertionError(f"unified: a submitter failed or was shed: "
                                 f"{[r[3] for r in served]}")
        stream_err = max(
            _served_streams(f"unified_{q}", runtimes[q], [(ids, seed, chunks)], MIXED_TARGET,
                            runtimes[q].hparams.hop_length)
            for q, ids, seed, chunks, _ in streams)
        _note_mixed("unified", "served streams vs alone", stream_err, MIXED_ATOL)

        x_low = runtimes["x_low"]
        weights = x_low.hbm_bytes()
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        server.remove_voice("x_low", close_runtime=True).result(timeout=120)
        deadline = time.monotonic() + 60
        while not x_low.closed and time.monotonic() < deadline:
            time.sleep(0.01)
        gc.collect()
        freed = before - torch.cuda.memory_allocated()
        if not (x_low.closed and weights > 0 and freed >= 0.9 * weights):
            raise AssertionError(f"unified: remove_voice(close_runtime=True) closed "
                                 f"{x_low.closed}, freed {freed} of {weights} weight bytes")
        row["released"] = {"x_low": {"hbm_bytes": weights, "freed_bytes": freed}}
    finally:
        server.close()

    errs = []
    fp32 = {q: PiperRuntime(*voices[q], device="cuda") for q in runtimes}
    for (q, f), got in zip(zero, zero_audio):
        want = np.clip(fp32[q].synthesize(FIXTURE_PHONEME_IDS * f, noise_scale=0.0, noise_w=0.0),
                       -1.0, 1.0)
        if got.dtype != np.int16 or got.shape != want.shape:
            raise AssertionError(f"unified {q} f={f}: {got.dtype} {got.shape}, fp32 {want.shape}")
        err = float(np.abs(got.astype(np.float32) / 32767.0 - want).max())
        if not err <= ZERO_NOISE_ATOL:
            raise AssertionError(f"unified {q} f={f}: served vs fp32 max-abs {err} > "
                                 f"{ZERO_NOISE_ATOL}")
        _note_mixed(f"unified_{q}", f"served f={f} at zero noise vs fp32", err, MIXED_ATOL)
        errs.append({"voice": q, "factor": f, "max_abs_err": err})
    lat = [latency * 1e3 for results, *_ in served for latency, _, _ in results]
    ttfb = [s[4] for s in streams]
    emit(phase="unified", voices=list(runtimes), rate_req_s=SERVE_RATE, threads=SERVE_THREADS,
         seconds=SERVE_S, requests=len(lat),
         latency_ms={"p50": _pct(lat, 50), "p95": _pct(lat, 95), "p99": _pct(lat, 99),
                     "max": max(lat)},
         streams=[{"voice": q, "phonemes": len(ids), "ttfb_ms": t} for q, ids, _, _, t in streams],
         stream_ttfb_ms={"p50": _pct(ttfb, 50), "p95": _pct(ttfb, 95)},
         stream_max_abs_err=stream_err,
         batch={q: {k: m[k] for k in ("rows_per_group", "groups", "padded_rows", "wait_ms_mean")}
                for q, m in metrics["batch"].items()},
         stream={q: {k: m[k] for k in ("head_dispatches", "window_dispatches", "window_rows",
                                       "padded_rows")}
                 for q, m in metrics["stream"].items()},
         zero_noise_vs_fp32=errs, atol=ZERO_NOISE_ATOL, **row, launches=launches)
    return launches


def _http_stream(host: str, port: int, body: dict):
    """POST /v1/stream and read the chunked body as it arrives: (status,
    headers, the concatenated int16 PCM, ms to the first body bytes)."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/stream", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        parts, ttfb = [], None
        while True:
            part = resp.read1(1 << 16)
            if not part:
                break
            if ttfb is None:
                ttfb = (time.perf_counter() - t0) * 1e3
            parts.append(part)
        return resp.status, dict(resp.getheaders()), np.frombuffer(b"".join(parts), "<i2"), ttfb
    finally:
        conn.close()


def _http_request(host: str, port: int, path: str, body=None):
    """(status, content type, body) of a POST of `body` as JSON, or of a
    GET when `body` is None."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=120)
    try:
        if body is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def phase_http(torch, voices: dict) -> dict:
    """The HTTP door on the card: PiperHTTPServer(stream=True) of the medium
    and x_low voices at the mixed tiers (fused, int16; the unified phase's
    runtimes and server), prewarmed as the unified phase prewarms. With
    every count at 0: SERVE_THREADS threads POST the seeded serving mix to
    /v1/synthesize ("format": "pcm") for SERVE_S seconds at SERVE_RATE
    requests/s in all through serving_sim's HttpClient; zero-noise requests
    of f = 1/2/4/8 per voice go beside them, every other one as a WAV (read
    back with utils/wav.py's parse_wav_bytes) and the rest as pcm; the
    UNIFIED_STREAMS go as chunked POST /v1/stream with their seeds;
    /v1/durations at noise_w=0 for f = 1 and 8 per voice; GET /healthz
    (ready), /v1/voices, /v1/metrics and /metrics; one unknown voice (404)
    and one bad body (400). Every request must answer as it should, nothing
    fail or be shed; each zero-noise response must lie within
    ZERO_NOISE_ATOL of the card's fp32 synthesize at zero noise, each
    stream's PCM within MIXED_TARGET of its synthesize_stream_incremental
    alone, each durations plan equal to phoneme_durations; K1-K3 must
    launch. Then the serving CLI as a user starts it: `python -m
    piper_tpu_torch.cli --serve --stream --port 0 --model <medium>,<x_low>
    --prewarm` on the card, one /v1/synthesize and one /v1/stream through
    it, then SIGTERM: it must drain ("draining") and exit 0."""
    import threading

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.bucketing import bucket_for
    from piper_tpu_torch.engine.http_server import PiperHTTPServer
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu_torch.tools.serving_sim import LENGTH_MIX, HttpClient, run_traffic
    from piper_tpu_torch.utils.wav import parse_wav_bytes

    t_phase = time.perf_counter()
    opts = RuntimeOptions(mode="fused", output_dtype="int16", **BENCH_MIX)
    runtimes = {q: PiperRuntime(*voices[q], opts, device="cuda") for q in ("medium", "x_low")}
    srv = PiperHTTPServer(runtimes, port=0, stream=True, max_batch=SERVE_MAX_BATCH,
                          max_wait_ms=10.0, stream_kwargs=dict(emit_frames=STREAM_EMIT))
    srv.start()
    client = HttpClient(srv.host, srv.port, workers=64)
    row = {}
    try:
        p_buckets = sorted({bucket_for(len((FIXTURE_PHONEME_IDS * f)[:4096]),
                                       runtimes["medium"].options.phoneme_buckets, "phoneme")
                            for f, _ in LENGTH_MIX})
        t0 = time.perf_counter()
        warm = srv.prewarm(p_buckets=p_buckets, stream_kwargs=dict(
            phoneme_lengths=sorted({len(FIXTURE_PHONEME_IDS * f) for _, f, _ in UNIFIED_STREAMS}),
            row_rungs=(1, 2, 4), head_rungs=(1, 2)))
        row["prewarm"] = {"wall_s": time.perf_counter() - t0, **warm}
        zero = [(q, f, ("wav", "pcm")[i % 2]) for q in runtimes
                for i, f in enumerate(FACTORS)]
        dur_cases = [(q, f) for q in runtimes for f in (1, 8)]

        counters = _zero_counts()
        served, streams, errors = [], [], []
        keys = list(runtimes)
        t_start = time.perf_counter()

        def submit(rng, ids):
            return client.post({"voice": keys[int(rng.integers(len(keys)))],
                                "phoneme_ids": list(ids), "format": "pcm"})

        def submitter(i):
            served.append(run_traffic(submit, SERVE_S, np.random.default_rng(300 + i),
                                      SERVE_RATE / SERVE_THREADS, runtimes["medium"].sample_rate))

        def streamer(i, q, f, at):
            try:
                time.sleep(max(0.0, t_start + at - time.perf_counter()))
                ids, seed = FIXTURE_PHONEME_IDS * f, 3000 + i
                st, headers, pcm, ttfb = _http_stream(srv.host, srv.port,
                                                      {"voice": q, "phoneme_ids": ids,
                                                       "seed": seed})
                if st != 200 or int(headers["X-Sample-Rate"]) != runtimes[q].sample_rate:
                    raise AssertionError(f"stream {i}: HTTP {st}, headers {headers}")
                streams.append((q, ids, seed, pcm, ttfb))
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(repr(e))

        threads = ([threading.Thread(target=submitter, args=(i,), name=f"http-client-{i}")
                    for i in range(SERVE_THREADS)]
                   + [threading.Thread(target=streamer, args=(i, *s), name=f"http-stream-{i}")
                      for i, s in enumerate(UNIFIED_STREAMS)])
        for t in threads:
            t.start()
        zero_futs = [client.post({"voice": q, "phoneme_ids": FIXTURE_PHONEME_IDS * f,
                                  "noise_scale": 0.0, "noise_w": 0.0,
                                  **({"format": "pcm"} if fmt == "pcm" else {})})
                     for q, f, fmt in zero]
        dur_futs = [client.post({"voice": q, "phoneme_ids": FIXTURE_PHONEME_IDS * f,
                                 "noise_w": 0.0}, path="/v1/durations") for q, f in dur_cases]
        for t in threads:
            t.join()
        zero_audio = [fut.result(timeout=300) for fut in zero_futs]
        durs = [fut.result(timeout=300) for fut in dur_futs]
        launches = _require_launches("http", counters)
        gets = {path: _http_request(srv.host, srv.port, path)
                for path in ("/healthz", "/v1/voices", "/v1/metrics", "/metrics")}
        not_found = _http_request(srv.host, srv.port, "/v1/synthesize",
                                  {"voice": "nope", "phoneme_ids": [1, 2]})[0]
        bad = _http_request(srv.host, srv.port, "/v1/synthesize",
                            {"phoneme_ids": "not-a-list"})[0]
        metrics = srv.server.metrics()
        sdk = _sdk_requests(srv.host, srv.port, list(runtimes))
    finally:
        client.close()
        srv.close()
    if errors or len(streams) != len(UNIFIED_STREAMS):
        raise AssertionError(f"http: {len(streams)} streams served, errors {errors}")
    for key, m in metrics["batch"].items():
        if m["failed"] or m["shed_overload"] or m["shed_deadline"]:
            raise AssertionError(f"http: voice {key} failed or shed requests: {m}")
    if (len(served) != SERVE_THREADS or any(sum(shed.values()) for *_, shed in served)
            or client.transport_errors):
        raise AssertionError(f"http: a client failed or was shed: {[r[3] for r in served]}, "
                             f"{client.transport_errors} failed connections")
    health = json.loads(gets["/healthz"][2])
    voices_doc = json.loads(gets["/v1/voices"][2])
    if any(st != 200 for st, _, _ in gets.values()) or health.get("ready") is not True:
        raise AssertionError(f"http: GETs {[(p, g[0]) for p, g in gets.items()]}, "
                             f"healthz {health}")
    if set(voices_doc) != set(runtimes) or "piper_tpu_completed{" not in gets["/metrics"][2].decode():
        raise AssertionError(f"http: /v1/voices {voices_doc} or /metrics lacks the counters")
    if (not_found, bad) != (404, 400):
        raise AssertionError(f"http: unknown voice {not_found}, bad body {bad}")
    stream_err = 0.0
    for q, ids, seed, pcm, _ in streams:
        want = np.concatenate([c.samples for c in runtimes[q].synthesize_stream_incremental(
            ids, seed=seed)])
        if pcm.shape != want.shape:
            raise AssertionError(f"http stream {q} of {len(ids)} ids: {pcm.shape} samples, "
                                 f"alone {want.shape}")
        stream_err = max(stream_err, float(np.abs(pcm.astype(np.float32) - want.astype(
            np.float32)).max()) / 32767.0)
    if not stream_err <= MIXED_TARGET:
        raise AssertionError(f"http: streams vs alone max-abs {stream_err} > {MIXED_TARGET}")
    _note_mixed("http", "streams over HTTP vs alone", stream_err, MIXED_ATOL)

    errs = []
    fp32 = {q: PiperRuntime(*voices[q], device="cuda") for q in runtimes}
    for (q, f, fmt), got in zip(zero, zero_audio):
        want = np.clip(fp32[q].synthesize(FIXTURE_PHONEME_IDS * f, noise_scale=0.0,
                                          noise_w=0.0), -1.0, 1.0)
        got = got.astype(np.float32) / 32767.0 if fmt == "pcm" else got
        if got.shape != want.shape:
            raise AssertionError(f"http {q} f={f} {fmt}: {got.shape} samples, fp32 {want.shape}")
        err = float(np.abs(got - want).max())
        if not err <= ZERO_NOISE_ATOL:
            raise AssertionError(f"http {q} f={f} {fmt}: served vs fp32 max-abs {err} > "
                                 f"{ZERO_NOISE_ATOL}")
        _note_mixed(f"http_{q}", f"served {fmt} f={f} at zero noise vs fp32", err, MIXED_ATOL)
        errs.append({"voice": q, "factor": f, "format": fmt, "max_abs_err": err})
    row["client"] = _check_sdk(sdk, fp32, runtimes)
    for (q, f), doc in zip(dur_cases, durs):
        plan = runtimes[q].phoneme_durations([FIXTURE_PHONEME_IDS * f], noise_w=0.0)[0]
        (utt,) = doc["utterances"]
        if [p["frames"] for p in utt["phonemes"]] != plan.tolist():
            raise AssertionError(f"http {q} f={f}: /v1/durations {utt['phonemes']} != "
                                 f"phoneme_durations {plan}")
    for rt in list(runtimes.values()) + list(fp32.values()):
        rt.close()
    lat = [latency * 1e3 for results, *_ in served for latency, _, _ in results]
    ttfb = [s[4] for s in streams]
    row["cli"] = _http_cli(voices)
    emit(phase="http", voices=list(runtimes), rate_req_s=SERVE_RATE, threads=SERVE_THREADS,
         seconds=SERVE_S, requests=len(lat),
         latency_ms={"p50": _pct(lat, 50), "p95": _pct(lat, 95), "p99": _pct(lat, 99),
                     "max": max(lat)},
         streams=[{"voice": q, "phonemes": len(ids), "ttfb_ms": t} for q, ids, _, _, t in streams],
         stream_ttfb_ms={"p50": _pct(ttfb, 50), "p95": _pct(ttfb, 95)},
         stream_max_abs_err=stream_err, zero_noise_vs_fp32=errs, atol=ZERO_NOISE_ATOL,
         durations_equal=True, healthz=health,
         batch={q: {k: m[k] for k in ("rows_per_group", "groups", "padded_rows", "wait_ms_mean")}
                for q, m in metrics["batch"].items()},
         **row, wall_s=time.perf_counter() - t_phase, launches=launches)
    return launches


def _sdk_requests(host: str, port: int, keys) -> dict:
    """Through piper_tpu_torch.client.PiperClient: health, voices, per voice
    one zero-noise synthesize of the f=2 phrase and its durations, and an
    unknown voice's status."""
    from piper_tpu_torch.client import PiperClient, PiperClientError
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS

    c = PiperClient(host, port)
    ids = FIXTURE_PHONEME_IDS * 2
    out = {"health": c.health(), "voices": sorted(c.voices()),
           "audio": {q: c.synthesize(phoneme_ids=ids, voice=q, noise_scale=0.0,
                                     noise_w=0.0)[0] for q in keys},
           "durations": {q: c.durations(phoneme_ids=ids, voice=q, noise_w=0.0) for q in keys}}
    try:
        c.synthesize(phoneme_ids=[1, 2], voice="nope")
        out["unknown_voice"] = 200
    except PiperClientError as e:
        out["unknown_voice"] = e.status
    return out


def _check_sdk(sdk: dict, fp32: dict, runtimes: dict) -> dict:
    """The PiperClient answers: healthy, both voices, each zero-noise WAV
    within ZERO_NOISE_ATOL of the card's fp32 synthesize, each plan equal to
    phoneme_durations, a 404 for an unknown voice."""
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS

    ids = FIXTURE_PHONEME_IDS * 2
    if not sdk["health"] or sdk["voices"] != sorted(runtimes) or sdk["unknown_voice"] != 404:
        raise AssertionError(f"http client: {({k: sdk[k] for k in ('health', 'voices')})}, "
                             f"unknown voice {sdk['unknown_voice']}")
    errs = {}
    for q, got in sdk["audio"].items():
        want = np.clip(fp32[q].synthesize(ids, noise_scale=0.0, noise_w=0.0), -1.0, 1.0)
        if got.shape != want.shape:
            raise AssertionError(f"http client {q}: {got.shape} samples, fp32 {want.shape}")
        errs[q] = float(np.abs(got - want).max())
        if not errs[q] <= ZERO_NOISE_ATOL:
            raise AssertionError(f"http client {q}: vs fp32 max-abs {errs[q]} > {ZERO_NOISE_ATOL}")
        plan = runtimes[q].phoneme_durations([ids], noise_w=0.0)[0]
        (utt,) = sdk["durations"][q]["utterances"]
        if [p["frames"] for p in utt["phonemes"]] != plan.tolist():
            raise AssertionError(f"http client {q}: durations {utt['phonemes']} != {plan}")
    return {"voices": sdk["voices"], "zero_noise_vs_fp32": errs, "unknown_voice": 404}


def _http_cli(voices: dict) -> dict:
    """`python -m piper_tpu_torch.cli --serve --stream --port 0 --model
    <medium>,<x_low> --prewarm` on the card as a subprocess: read its banner
    for the port, POST one /v1/synthesize and one /v1/stream, send SIGTERM,
    and require "draining" and exit 0 within 60 s. The process is killed
    if it outlives the phase."""
    import os
    import re
    import signal

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS

    keys = {q: Path(voices[q][0]).stem for q in ("medium", "x_low")}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "piper_tpu_torch.cli", "--serve", "--stream", "--port", "0",
         "--model", f"{voices['medium'][0]},{voices['x_low'][0]}", "--prewarm"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), stderr=subprocess.PIPE,
        text=True)
    try:
        port, lines = None, []
        while port is None:
            line = proc.stderr.readline()
            if not line and proc.poll() is not None:
                raise AssertionError(f"http cli: exited {proc.returncode} before its banner: "
                                     f"{lines[-20:]}")
            lines.append(line)
            m = re.search(r"serving voice\(s\) .* on http://[\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
            if time.perf_counter() - t0 > 300:
                raise AssertionError(f"http cli: no banner in 300 s: {lines[-20:]}")
        banner_s = time.perf_counter() - t0
        synth_st, _, wav = _http_request("127.0.0.1", port, "/v1/synthesize",
                                         {"voice": keys["medium"],
                                          "phoneme_ids": FIXTURE_PHONEME_IDS})
        st, _, pcm, ttfb = _http_stream("127.0.0.1", port, {"voice": keys["x_low"],
                                                            "phoneme_ids": FIXTURE_PHONEME_IDS,
                                                            "seed": 1})
        if synth_st != 200 or wav[:4] != b"RIFF" or st != 200 or not len(pcm):
            raise AssertionError(f"http cli: synthesize {synth_st}, stream {st}")
        proc.send_signal(signal.SIGTERM)
        rest = proc.stderr.read()
        code = proc.wait(timeout=60)
        if code != 0 or "draining" not in rest:
            raise AssertionError(f"http cli: exit {code} after SIGTERM: {rest[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    prewarmed = next((ln.strip() for ln in lines if ln.startswith("prewarmed")), None)
    return {"banner": lines[-1].strip(), "banner_s": banner_s, "prewarmed": prewarmed,
            "stream_ttfb_ms": ttfb, "exit_code": code, "wall_s": time.perf_counter() - t0}


def phase_probe() -> dict:
    """The folded-kernel probe's main function, reduced to a batch of 2 and
    one timed window of 2 calls per kernel, at its default tier ("high");
    the counts are set to 0 just before it and read just after."""
    from piper_tpu_torch.tools import folded_probe

    counters = _zero_counts()
    rows = folded_probe.main(["--b", "2", "--shapes", "32:16384,64:4096", "--folds", "2,4",
                              "--iters", "2", "--reps", "1"])
    launches = _require_launches("probe", counters)
    kernels = sorted({r["kernel"] for r in rows})
    if kernels != ["folded_f2", "folded_f4", "mrf", "per_branch"]:
        raise AssertionError(f"the probe ran {kernels}")
    emit(phase="probe", rows=len(rows), launches=launches)
    return launches


def phase_ct_probe() -> dict:
    """The conv-transpose probe's main function at each of its four
    levels, reduced to a batch of 2 at 128 frames and one timed window of 2
    calls per piece, at "highest" (TF32 off), so that poly_ct and native_ct
    must agree with full_ct within CT_ATOL. The counts are set to 0 just
    before each level and read just after; each level must launch K5."""
    from piper_tpu_torch.tools import ct_probe

    total = {}
    for level in range(len(MEDIUM_UPSAMPLE)):
        counters = _zero_counts()
        out = ct_probe.main(["--b", "2", "--frames", "128", "--iters", "2", "--reps", "1",
                             "--level", str(level), "--precision", "highest"])
        launches = _require_launches("ct_probe", counters)
        pieces = [r["piece"] for r in out["rows"]]
        if pieces != ["poly_conv_folded_out", "interleave_pair(2x)", "full_ct", "poly_ct",
                      "native_ct_lhs_dilated", "mosaic_interleave"]:
            raise AssertionError(f"ct_probe level {level} ran {pieces}")
        agree = out["agreement"]
        errs = {k: v for k, v in agree.items() if k.endswith("_vs_full_ct")}
        if not max(errs.values()) <= CT_ATOL:
            raise AssertionError(f"ct_probe level {level}: {errs} > {CT_ATOL}")
        emit(phase="ct_probe", level=level, shapes=out["shapes"], errs=errs, atol=CT_ATOL,
             ms={r["piece"]: r["ms_per_call"] for r in out["rows"]}, launches=launches)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return total


def phase_level_probe() -> dict:
    """The level probe's main function at level 3 (C=32: K3), reduced to a
    batch of 2 at 32 frames and one timed window of 2 calls per piece, at
    its default tier ("high"); the counts are set to 0 just before it and
    read just after. Every piece must time (none refused)."""
    from piper_tpu_torch.tools import level_probe

    counters = _zero_counts()
    rows = level_probe.main(["--b", "2", "--frames", "32", "--level", "3", "--iters", "2",
                             "--reps", "1"])
    launches = _require_launches("level_probe", counters)
    pieces = [r["piece"] for r in rows]
    if pieces != ["lrelu_only", "lrelu+conv_transpose", "mrf_fused", "whole_level"] or any(
            "error" in r or not r["ms_per_call"] > 0 or not r["kernels"] for r in rows):
        raise AssertionError(f"level_probe: {rows}")
    emit(phase="level_probe", rows=rows, launches=launches)
    return launches


def phase_resblock_probe() -> dict:
    """K2 and K3's probe reduced to its B=1 shape (128 frames) at every
    tier ("highest", "high", "default" and bf16 activations), windows of 3
    calls; the counts are set to 0 just before it and read just after. Both
    kernels must launch, and each row's kernel time lie above its bound."""
    from piper_tpu_torch.tools import resblock_probe

    counters = _zero_counts()
    t0 = time.perf_counter()
    rows = resblock_probe.main(["--shapes", "b1", "--reps", "3"])
    seconds = time.perf_counter() - t0
    launches = _require_launches("resblock_probe", counters)
    timed = [r for r in rows if "kernel" in r]
    if len(timed) != 8 or not all(0 < r["kernel_bound_frac"] <= 1.0 for r in timed):
        raise AssertionError(f"resblock_probe: {timed}")
    emit(phase="resblock_probe", rows=[{k: r[k] for k in (
        "kernel", "precision", "wrapper_ms", "kernel_ms", "bound_ms", "kernel_bound_frac",
        "wrapper_kernels")} for r in timed], sums=rows[-1]["k2_plus_k3"],
        nvidia_smi=rows[-1]["nvidia_smi"], seconds=seconds, launches=launches)
    return launches


def phase_roofline(torch, runtimes: dict) -> dict:
    """piper_tpu_torch.utils.roofline on the card: the ceilings measured once
    and printed beside the published peaks with the card's name and power
    limit, then roofline_report at ROOFLINE_SHAPE on medium mixed
    (`roofline_medium`: K2 at level 2, K3 at level 3) and on x_low at fp32
    (`roofline_x_low`: K1), every level's row. The counts are set to 0 just
    before each report and read just after. Every stage must have a device
    time, its kernels per call, and mfu and hbm_frac in
    (0, ROOFLINE_MAX_FRAC]."""
    from piper_tpu_torch.tools.timing import card
    from piper_tpu_torch.utils import roofline as rl

    t0 = time.perf_counter()
    ceilings = rl.measure_ceilings(iters=4)
    peaks = rl.published_peaks()
    emit(phase="roofline_ceilings", device=card("cuda"), ceilings=ceilings, peaks=peaks,
         of_peak={k: ceilings[k] / peaks[k] for k in ceilings},
         seconds=time.perf_counter() - t0)
    total = {}
    for path, key in (("roofline_medium", "medium_mixed"), ("roofline_x_low", "x_low")):
        rt = runtimes[key]
        t0 = time.perf_counter()
        counters = _zero_counts()
        rep = rl.roofline_report(rt, *ROOFLINE_SHAPE, iters=ROOFLINE_ITERS, ceilings=ceilings)
        launches = _require_launches(path, counters)
        want = ["encode(enc+dp)", "flow", "vocoder"] + [
            f"vocoder.up{i}" for i in range(rt.hparams.num_upsamples)]
        if [s["stage"] for s in rep["stages"]] != want:
            raise AssertionError(f"{path}: stages {[s['stage'] for s in rep['stages']]}")
        for s in rep["stages"]:
            if not (s["ms"] > 0 and s["kernels"] and 0 < s["mfu"] <= ROOFLINE_MAX_FRAC
                    and 0 < s["hbm_frac"] <= ROOFLINE_MAX_FRAC):
                raise AssertionError(f"{path}: stage {s}")
        emit(phase="roofline", path=path, voice=key, **rep, launches=launches,
             seconds=time.perf_counter() - t0)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return total


def phase_cli(torch, voices: dict, card: dict) -> dict:
    """The command line on the card. In this process, with every count at
    0: `--record-vectors` of the medium voice's f=2 phrase (launches K2 and
    K3, read just after) and `--microbench` (both chain times). Then, as
    subprocesses at once: one-shot `--phoneme-ids` on the medium voice file
    at zero noise, its WAV within WAV_ATOL of the card's fp32 synthesize of
    the same ids, and `--verify-summary --tolerance 1e-4` of the recorded
    vector: exit 0, max_abs_err_worst <= REPLAY_ATOL, lengths equal."""
    import contextlib
    import io
    import os
    import shutil

    from piper_tpu_torch import cli
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.utils.wav import read_wav

    t_phase = time.perf_counter()
    model = str(voices["medium"][0])
    ids = FIXTURE_PHONEME_IDS * 2
    ids_arg = ",".join(map(str, ids))
    out_dir = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    counters = _zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--model", model, "--phoneme-ids", ids_arg, "--record-vectors",
                  str(out_dir / "vectors"), "--test-id", "medium_f2"])
        recorded = buf.getvalue()
        cli.main(["--microbench"])
    launches = _require_launches("cli", counters)
    micro = json.loads(buf.getvalue()[len(recorded):])
    if not (micro["eager_chain_ms"] > 0 and micro["jit_chain_ms"] > 0):
        raise AssertionError(f"cli --microbench: {micro}")

    env = {k: v for k, v in os.environ.items() if not k.startswith("PIPER_TPU_")}
    env["PYTHONPATH"] = str(ROOT)
    wav = out_dir / "oneshot.wav"
    cmds = {"oneshot": ["--model", model, "--phoneme-ids", ids_arg, "--noise-scale", "0",
                        "--noise-w", "0", "-o", str(wav)],
            "verify": ["--verify-summary", str(out_dir / "vectors" / "test_summary.json"),
                       "--tolerance", str(REPLAY_ATOL)]}
    procs = {k: subprocess.Popen([sys.executable, "-m", "piper_tpu_torch.cli", *argv], cwd=ROOT,
                                 env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True) for k, argv in cmds.items()}
    outs = {}
    try:
        for k, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"cli {k}: exit {proc.returncode}: {err[-2000:]}")
            outs[k] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    got, sr = read_wav(wav)
    want = np.clip(card["medium"].synthesize(ids, noise_scale=0.0, noise_w=0.0), -1.0, 1.0)
    if got.shape != want.shape or sr != card["medium"].sample_rate:
        raise AssertionError(f"cli one-shot: {got.shape} at {sr} Hz, synthesize {want.shape}")
    wav_err = float(np.abs(got - want).max())
    if not wav_err <= WAV_ATOL:
        raise AssertionError(f"cli one-shot WAV vs synthesize max-abs {wav_err} > {WAV_ATOL}")
    verify = json.loads(outs["verify"])
    if not (verify["passed"] and verify["max_abs_err_worst"] <= REPLAY_ATOL
            and all(r["length_match"] for r in verify["results"])):
        raise AssertionError(f"cli --verify-summary: {verify}")
    emit(phase="cli", oneshot=outs["oneshot"].strip(), oneshot_vs_synthesize=wav_err,
         atol=WAV_ATOL, recorded=recorded.strip(),
         verify={k: verify[k] for k in ("passed", "max_abs_err_worst", "tolerance")},
         microbench=micro, launches=launches, wall_s=time.perf_counter() - t_phase)
    return launches


def _bf16_batch(rt, rows: int, f: int) -> dict:
    """A B=`rows` batch of the f-times phrase: its blocking wall (median of
    3), audio seconds per wall second, and one call under torch.profiler:
    device busy, and the voice's vocoder kernels by symbol against their
    counters. In the "bfloat16" mode a second window also requires every
    one of those kernels to be a bf16 variant (`__nv_bfloat16` in its
    symbol)."""
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.tools.timing import profile_call, profiled

    batch = [FIXTURE_PHONEME_IDS * f] * rows
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        audios = rt.synthesize_batch(batch)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    audio_s = sum(len(a) for a in audios) / rt.sample_rate
    symbol, names = VOCODER_KERNELS[_voice(rt.config.audio.quality)]
    counters = _counters()
    row = profile_call(lambda: rt.synthesize_batch(batch), symbol,
                       [counters[n] for n in names])
    if rt.options.precision == "bfloat16":
        events = next(filter(None, (profiled(lambda: rt.synthesize_batch(batch))
                                    for _ in range(3))), None)
        keys = [(e.key, e.count) for e in events or () if symbol in e.key]
        row["bf16_variant_launches"] = sum(c for k, c in keys if "__nv_bfloat16" in k)
        if events is None or row["bf16_variant_launches"] != row["kernel_launches"]:
            raise AssertionError(f"{rt.config.audio.quality} bf16 batch: vocoder kernels "
                                 f"{keys}, not all bf16 variants")
    return {"wall_ms": wall * 1e3, "rtf_blocking": audio_s / wall, **row}


def phase_bf16(torch, voices: dict, card: dict) -> dict:
    """The "bfloat16" capacity tier (bf16 weights and activations, K1-K3 on
    bf16 at "default") on medium and x_low at full width: synthesize at f=1
    and f=8, a B=32 batch of f=8, one seeded incremental stream; float32
    PCM, finite, |x| <= 1; each vocoder kernel its count per call (and the
    profiled batch's bf16 kernels, by symbol, equal to the launches). Not
    gated, printed: the waveform's max-abs against the card's fp32 run with
    injected noise, the share of phonemes whose w_ceil differs from fp32,
    and medium's batch beside medium mixed's (device busy, rtf)."""
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions

    total = {name: 0 for name in _counters()}
    for quality in ("medium", "x_low"):
        path = f"{quality}_bf16"
        rt = PiperRuntime(*voices[quality], RuntimeOptions(precision="bfloat16"),
                          device="cuda")
        batch = [FIXTURE_PHONEME_IDS * 8] * SERVING_BATCH
        for f in (1, 8):  # first run of each shape
            rt.synthesize(FIXTURE_PHONEME_IDS * f)
        rt.synthesize_batch(batch)
        counters = _zero_counts()
        outs = {f"f{f}": rt.synthesize(FIXTURE_PHONEME_IDS * f) for f in (1, 8)}
        outs.update({f"batch_row{i}": a for i, a in enumerate(rt.synthesize_batch(batch))})
        launches = {name: fn.launches for name, fn in counters.items()}
        _require_per_call(path, launches, 3)
        _zero_counts()
        chunks = list(rt.synthesize_stream(FIXTURE_PHONEME_IDS * 8, incremental=True, seed=1))
        stream = _stream_chunks(path, chunks, rt.hparams.hop_length)
        outs["stream"] = stream
        stream_launches = {name: fn.launches for name, fn in counters.items()}
        for name in LAUNCHES_PER_CALL[quality]:
            launches[name] += stream_launches[name]
            if stream_launches[name] <= 0:
                raise AssertionError(f"{path} stream: {name} launched no time")
        for what, a in outs.items():
            if a.dtype != np.float32 or not len(a) or not np.isfinite(a).all() \
                    or float(np.abs(a).max()) > 1.0:
                raise AssertionError(f"{path} {what}: {a.dtype}, {len(a)} samples, not "
                                     f"finite float32 PCM in [-1, 1]")
        for name, n in launches.items():
            total[name] += n
        ids = FIXTURE_PHONEME_IDS * 8
        dp_noise, main_noise = _injected_noise(rt.hparams, len(ids))
        fp32 = card[quality]
        wc = rt._durations([ids], dp_noise=dp_noise[None])[1]
        wc32 = fp32._durations([ids], dp_noise=dp_noise[None])[1]
        a = rt.synthesize(ids, dp_noise=dp_noise, main_noise=main_noise)
        b = fp32.synthesize(ids, dp_noise=dp_noise, main_noise=main_noise)
        n = min(len(a), len(b))
        row = {"path": path, "launches": launches, "stream_chunks": len(chunks),
               "vs_fp32_max_abs": float(np.abs(a[:n] - b[:n]).max()),
               "vs_fp32_samples": [len(a), len(b)],
               "w_ceil_differs_share": float(np.mean(wc != wc32)),
               "hbm_bytes": rt.hbm_bytes(), "fp32_hbm_bytes": fp32.hbm_bytes(),
               "batch": _bf16_batch(rt, SERVING_BATCH, 8)}
        if quality == "medium":
            row["medium_mixed_batch"] = _bf16_batch(card["medium_mixed"], SERVING_BATCH, 8)
        emit(phase="bf16", **row)
        rt.close()
    return total


def phase_debug_trace(torch, voices: dict, card: dict) -> dict:
    """synthesize_debug(per_layer=True) of medium fp32 on the card against
    the port on the CPU, one seed: the same keys in the same order (the
    layers', then the module boundaries'), w_ceil equal, audio within 1e-4,
    every other module tensor within 2e-5 (logw 5e-5) per unit of its peak
    where that exceeds 1; each layer's max-abs printed, the
    worst named. On the card the debug path's narrow unfused convs run
    K1."""
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime

    cpu = PiperRuntime(*voices["medium"], device="cpu")
    counters = _zero_counts()
    got = card["medium"].synthesize_debug(FIXTURE_PHONEME_IDS, seed=3, per_layer=True)
    launches = _require_launches("debug_trace", counters)
    want = cpu.synthesize_debug(FIXTURE_PHONEME_IDS, seed=3, per_layer=True)
    if list(got) != list(want) or list(got)[-len(DEBUG_MODULE_KEYS):] != DEBUG_MODULE_KEYS:
        raise AssertionError(f"debug_trace: keys differ: {list(got)} vs {list(want)}")
    if not np.array_equal(got["w_ceil"], want["w_ceil"]):
        raise AssertionError(f"debug_trace: w_ceil {got['w_ceil']} vs {want['w_ceil']}")
    errs = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
    bars = {k: (1e-4 if k == "audio" else 5e-5 if k == "logw" else 2e-5)
            * max(1.0, float(np.abs(want[k]).max())) for k in DEBUG_MODULE_KEYS}
    over = {k: errs[k] for k, bar in bars.items() if not errs[k] <= bar}
    layers = {k: v for k, v in errs.items() if k not in bars}
    worst = max(layers, key=layers.get)
    emit(phase="debug_trace", keys=len(got), layers=len(layers), module_errs=
         {k: errs[k] for k in DEBUG_MODULE_KEYS}, module_bars=bars, worst_layer=worst,
         worst_layer_max_abs=layers[worst],
         worst_layers=dict(sorted(layers.items(), key=lambda kv: -kv[1])[:8]),
         launches=launches)
    if over:
        raise AssertionError(f"debug_trace: above the parity bars: {over}")
    return launches


def phase_tools(torch, voices: dict) -> dict:
    """The operator's tools, reduced, one after another: bench_sessions (2
    fresh processes of a small x_low bench), cold_start's built-kernels and
    warm rows (one fresh process), padding_tax --iters 2 and
    streaming_bench --streams 4 --rounds 1 --ab-heads in this process (both
    on medium mixed: K2 and K3 launch). Each must print its line with the
    JAX tool's keys; the numbers are printed."""
    import contextlib
    import io

    from piper_tpu_torch.tools import bench_sessions, cold_start, padding_tax, streaming_bench

    model, config = voices["x_low"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_sessions.main(["--sessions", "2", "--", "--quick", "--model", str(model),
                                  "--config", str(config), "--quality", "x_low",
                                  "--batch", "4", "--multi-speaker", "0", "--no-pipeline"])
    sessions = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or sessions["sessions"] != 2 or not sessions["value"]:
        raise AssertionError(f"bench_sessions: rc {rc}: {sessions}")
    sessions.pop("all")
    emit(phase="tools", tool="bench_sessions", **sessions)
    with contextlib.redirect_stdout(io.StringIO()):
        cold = cold_start.main(["--model", str(voices["medium"][0]),
                                "--config", str(voices["medium"][1])])
    if not cold["cold_process_warm_cache"]["samples"]:
        raise AssertionError(f"cold_start: {cold}")
    emit(phase="tools", tool="cold_start", **cold)
    counters = _zero_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        tax = padding_tax.main(["--iters", "2"])
        streams = streaming_bench.main(["--streams", "4", "--rounds", "1", "--ab-heads"])
    launches = _require_launches("tools", counters)
    if not tax["rows"] or not tax["waste"] or len(streams["ab"]) != 2 \
            or not all(run["rows"] for run in streams["ab"]):
        raise AssertionError(f"padding_tax / streaming_bench: {tax} {streams}")
    emit(phase="tools", tool="padding_tax", **tax)
    emit(phase="tools", tool="streaming_bench", **streams)
    return launches


def phase_calibrate() -> None:
    """A short run of piper_tpu_torch.tools.calibrate_precision per voice
    (medium and x_low, f=8, 2 rows): the "high" schedule against the fp32
    run, the table by stage (each decode stage alone at "high": its PyTorch
    convs as "high" runs them and in TF32, its kernels) and the serving
    batch of 32 against four of its rows at the mixed tiers. The schedule
    and the batch are held to the mixed gate and noted for the margin."""
    from piper_tpu_torch.tools import calibrate_precision

    for quality in ("medium", "x_low"):
        out = calibrate_precision.main(["--quality", quality, "--schedules", "high",
                                        "--batch", "2", "--iters", "1"])
        checks = [("\"high\" schedule vs fp32", out["rows"][0]["max_abs_err"]),
                  ("serving batch vs its rows", out["batch_vs_rows"]["max_abs_err"])]
        for what, err in checks:
            if not err <= MIXED_ATOL:
                raise AssertionError(f"calibrate {quality} {what}: max-abs {err} > {MIXED_ATOL}")
            _note_mixed(f"calibrate_{quality}", what, err, MIXED_ATOL)
        emit(phase="calibrate", quality=quality, schedules=out["rows"], stages=out["stages"],
             batch_vs_rows=out["batch_vs_rows"])


def phase_mixed_margin() -> None:
    """Every comparison held to the mixed gate, against MIXED_TARGET: fails
    if any lands above it."""
    worst = max(MIXED_MARGINS, key=lambda m: m["max_abs_err"])
    above = [m for m in MIXED_MARGINS if not m["within_target"]]
    emit(phase="mixed_margin", gate=MIXED_ATOL, target=MIXED_TARGET,
         comparisons=len(MIXED_MARGINS), worst=worst, all_within_target=not above,
         above_target=above)
    if above:
        raise AssertionError(f"{len(above)} mixed comparisons above {MIXED_TARGET}: {above}")


def _mesh_timing(torch, fn) -> dict:
    """One call's wall (host clock, to numpy) and device busy (its
    kernels' summed device time under torch.profiler, every stream)."""
    from piper_tpu_torch.tools.timing import device_kernels, profiled

    t0 = time.perf_counter()
    fn()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(3):
        events = profiled(fn)
        if events is not None:
            n, us = device_kernels(events)
            return {"wall_ms": wall_ms, "device_busy_ms": us / 1e3, "device_kernels": n}
    raise AssertionError("mesh: torch.profiler lost every window of the call")


def _medium_weights(torch, model: str):
    """(hparams, the weights as CPU tensors) of a voice's checkpoint."""
    from piper_tpu_torch.core.config import VoiceConfig
    from piper_tpu_torch.models.vits.hparams import derive_hparams
    from piper_tpu_torch.models.vits.params import host_arrays_from_graph
    from piper_tpu_torch.onnx import load_model

    cfg = VoiceConfig.load(f"{model}.json")
    graph = load_model(model).graph
    hp = derive_hparams(graph, sample_rate=cfg.audio.sample_rate, n_speakers=cfg.num_speakers)
    return hp, {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in host_arrays_from_graph(graph).items()}


def _slot_kernels(path: str, mesh, want: dict) -> list:
    """Every slot's launches; each must be `want` ({name: n}) exactly."""
    per_slot = [dict(c) for c in mesh.slot_launches]
    for slot, got in enumerate(per_slot):
        if got != want:
            raise AssertionError(f"{path}: slot {slot} launched {got}, expected {want}")
    return per_slot


def phase_mesh(torch, voices: dict) -> dict:
    """The multi-slot layer (parallel/) on virtual slots of cuda:0, medium
    at full width. Every count is set to 0 just before each path's call and
    read just after. dp=2 (ShardedVits.synthesize_batch, MESH_B rows of f=8)
    against the one-slot call with the same numpy noise (1e-4), the mixed
    tiers against their one-slot call and the fp32 one (1e-3); sp=2
    (synthesize_long) against the one-device decode_window windows with the
    same noise (1e-4); tp=2 against the one-slot (replicated) call; dp=1 x
    pp=2 (synthesize_pipelined) against synthesize_batch at the same seed.
    Each path against the same call on the port's CPU slots (sp at zero
    noise: the card's and the CPU's torch generators draw different
    duration noise). dp and sp slots must launch K2, K3 and K1's wide
    design their count per call each (counted per slot); tp and pp launch
    no kernel."""
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.models.vits import model as vits
    from piper_tpu_torch.models.vits.hparams import receptive_field_frames
    from piper_tpu_torch.ops.kernels.precision import tier_scope
    from piper_tpu_torch.parallel.mesh import make_mesh
    from piper_tpu_torch.engine.runtime import seeded_noise
    from piper_tpu_torch.parallel.serving import ShardedVits

    hp, params = _medium_weights(torch, voices["medium"][0])
    per_call = {**LAUNCHES_PER_CALL["medium"], "conv1d_same": WIDE_LAUNCHES_PER_CALL["medium"]}

    def mesh(n, dev="cuda", **kw):
        return make_mesh(n, devices=[torch.device(dev)] * n, **kw)

    def batch(b, f):
        ids = np.asarray([FIXTURE_PHONEME_IDS * f] * b, np.int64)
        return ids, np.full((b,), ids.shape[1], np.int64)

    def check(path, got, want, atol, what):
        if got.shape != want.shape:
            raise AssertionError(f"{path}: {what}: shape {got.shape} != {want.shape}")
        err = float(np.abs(got - want).max())
        if not err <= atol:
            raise AssertionError(f"{path}: {what}: max-abs {err} > {atol}")
        return err

    totals = {}

    def counted(path, sv, call, want_slot):
        counters = _zero_counts()
        sv.mesh.reset_launches()
        out = call()
        launches = {name: fn.launches for name, fn in counters.items()}
        if want_slot:
            launches = _require_launches(path, counters)
        elif any(launches.values()):
            raise AssertionError(f"{path}: launched {launches}; tp and pp run no kernel")
        per_slot = _slot_kernels(path, sv.mesh, want_slot)
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
        return out, launches, per_slot

    rows = []
    t_path = time.perf_counter()
    # dp=2
    ids, lengths = batch(MESH_B, MESH_F)
    kw = dict(max_frames=MESH_FRAMES, seed=MESH_SEED)
    one = ShardedVits.create(mesh(1), params, hp)
    dp2 = ShardedVits.create(mesh(2), params, hp)
    ref, ref_len = one.synthesize_batch(ids, lengths, **kw)
    dp2.synthesize_batch(ids, lengths, **kw)  # first call per shape
    (got, y_len), launches, per_slot = counted(
        "mesh_dp", dp2, lambda: dp2.synthesize_batch(ids, lengths, **kw), per_call)
    if not np.array_equal(y_len, ref_len):
        raise AssertionError(f"mesh_dp: y_len {y_len} != one slot's {ref_len}")
    err = check("mesh_dp", got, ref, WAVE_ATOL, "dp=2 vs one slot")
    t_cpu = time.perf_counter()
    cpu_got, cpu_len = ShardedVits.create(mesh(2, "cpu"), params, hp).synthesize_batch(
        ids, lengths, **kw)
    cpu_s = time.perf_counter() - t_cpu
    cpu_err = check("mesh_dp", got, cpu_got, WAVE_ATOL, "card vs CPU")
    mix_one = ShardedVits.create(mesh(1), params, hp, **{k: v for k, v in BENCH_MIX.items()})
    mix_dp2 = ShardedVits.create(mesh(2), params, hp, **{k: v for k, v in BENCH_MIX.items()})
    mix_got, _ = mix_dp2.synthesize_batch(ids, lengths, **kw)
    mix_err = check("mesh_dp", mix_got, mix_one.synthesize_batch(ids, lengths, **kw)[0],
                    MIXED_ATOL, "mixed dp=2 vs mixed one slot")
    mix_fp32 = check("mesh_dp", mix_got, ref, MIXED_ATOL, "mixed dp=2 vs fp32")
    _note_mixed("mesh_dp_mixed", "dp=2 mixed vs fp32 one slot", mix_fp32, MIXED_ATOL)
    timing = {"dp1": _mesh_timing(torch, lambda: one.synthesize_batch(ids, lengths, **kw)),
              "dp2": _mesh_timing(torch, lambda: dp2.synthesize_batch(ids, lengths, **kw))}
    rows.append({"path": "mesh_dp", "mesh": dp2.mesh.shape, "b": MESH_B, "factor": MESH_F,
                 "frames": MESH_FRAMES, "max_abs_err": err, "cpu_max_abs_err": cpu_err,
                 "mixed_vs_mixed_one_slot": mix_err, "mixed_vs_fp32": mix_fp32,
                 "launches": launches, "slot_launches": per_slot, **timing,
                 "cpu_s": cpu_s, "wall_s": time.perf_counter() - t_path})

    # sp=2: synthesize_long against the one-device windows
    t_path = time.perf_counter()
    ids, lengths = batch(MESH_SMALL_B, 2)
    sp2 = ShardedVits.create(mesh(2, seq_parallel=2), params, hp)
    sp2.synthesize_long(ids, lengths, span=MESH_SPAN, seed=SP_SEED)
    (got, y_len), launches, per_slot = counted(
        "mesh_sp", sp2, lambda: sp2.synthesize_long(ids, lengths, span=MESH_SPAN, seed=SP_SEED),
        per_call)
    halo = receptive_field_frames(hp)
    window, total, hop = MESH_SPAN + 2 * halo, 2 * MESH_SPAN, hp.hop_length
    dev, p0 = torch.device("cuda"), {k: v.cuda() for k, v in params.items()}
    with torch.inference_mode(), tier_scope(sp2.precision, dev):
        enc = vits.encode(p0, hp, torch.as_tensor(ids, device=dev),
                          torch.as_tensor(lengths, device=dev),
                          seeded_noise(SP_SEED, 0, (2, ids.shape[1]), len(ids), dev))
        pieces = []
        for k in range(2):
            t_off = k * MESH_SPAN - halo
            noise = vits.per_frame_noise(SP_SEED, t_off + torch.arange(window, device=dev),
                                         len(ids), hp.inter_channels)
            aw = vits.decode_window(p0, hp, enc, noise, t_off, window=window,
                                    total_frames=total)
            pieces.append(aw.cpu().numpy()[:, halo * hop:(halo + MESH_SPAN) * hop])
    err = check("mesh_sp", got, np.concatenate(pieces, axis=1), WAVE_ATOL,
                "sp=2 vs one-device windows")
    zero = (0.0, 1.0, 0.0)
    z_card, _ = sp2.synthesize_long(ids, lengths, span=MESH_SPAN, seed=SP_SEED, scales=zero)
    t_cpu = time.perf_counter()
    z_cpu, _ = ShardedVits.create(mesh(2, "cpu", seq_parallel=2), params, hp).synthesize_long(
        ids, lengths, span=MESH_SPAN, seed=SP_SEED, scales=zero)
    cpu_s = time.perf_counter() - t_cpu
    cpu_err = check("mesh_sp", z_card, z_cpu, WAVE_ATOL, "card vs CPU at zero noise")
    timing = _mesh_timing(torch, lambda: sp2.synthesize_long(ids, lengths, span=MESH_SPAN,
                                                             seed=SP_SEED))
    rows.append({"path": "mesh_sp", "mesh": sp2.mesh.shape, "b": MESH_SMALL_B, "factor": 2,
                 "span": MESH_SPAN, "halo": halo, "max_abs_err": err,
                 "cpu_zero_noise_max_abs_err": cpu_err, "launches": launches,
                 "slot_launches": per_slot, **timing, "cpu_s": cpu_s,
                 "wall_s": time.perf_counter() - t_path})

    # tp=2 and dp=1 x pp=2 against the one-slot call
    kw = dict(max_frames=MESH_SMALL_FRAMES, seed=MESH_SEED)
    ref, ref_len = one.synthesize_batch(ids, lengths, **kw)
    for path, shape, call_name in (("mesh_tp", dict(tensor_parallel=2), "synthesize_batch"),
                                   ("mesh_pp", dict(pipeline_parallel=2),
                                    "synthesize_pipelined")):
        t_path = time.perf_counter()
        sv = ShardedVits.create(mesh(2, **shape), params, hp)
        call = getattr(sv, call_name)
        call(ids, lengths, **kw)
        (got, y_len), launches, per_slot = counted(path, sv, lambda: call(ids, lengths, **kw),
                                                   {})
        if not np.array_equal(np.asarray(y_len).astype(np.int64), ref_len.astype(np.int64)):
            raise AssertionError(f"{path}: y_len {y_len} != one slot's {ref_len}")
        err = check(path, got, ref, WAVE_ATOL, "vs one slot (replicated)")
        t_cpu = time.perf_counter()
        cpu_sv = ShardedVits.create(mesh(2, "cpu", **shape), params, hp)
        cpu_got = getattr(cpu_sv, call_name)(ids, lengths, **kw)[0]
        cpu_s = time.perf_counter() - t_cpu
        cpu_err = check(path, got, cpu_got, WAVE_ATOL, "card vs CPU")
        rows.append({"path": path, "mesh": sv.mesh.shape, "b": MESH_SMALL_B, "factor": 2,
                     "frames": MESH_SMALL_FRAMES, "max_abs_err": err,
                     "cpu_max_abs_err": cpu_err, "launches": launches,
                     "slot_launches": per_slot, **_mesh_timing(torch, lambda: call(
                         ids, lengths, **kw)), "cpu_s": cpu_s,
                     "wall_s": time.perf_counter() - t_path})
    for row in rows:
        emit(phase="mesh", **row)
    return totals


def phase_mesh_serve(torch, voices: dict) -> dict:
    """PiperRuntime(mesh=dp2) on two virtual slots of cuda:0 behind a
    BatchingServer (fused, fp32): the serving mix from two threads for
    MESH_SERVE_S seconds beside zero-noise requests of f = 1/2/4/8, each
    held to the one-device runtime's synthesize at zero noise (1e-4).
    Nothing fails or is shed; both slots launch K2 and K3."""
    import threading

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.batcher import BatchingServer
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu_torch.parallel.mesh import make_mesh
    from piper_tpu_torch.tools.serving_sim import run_traffic

    t_phase = time.perf_counter()
    mesh = make_mesh(2, devices=[torch.device("cuda")] * 2)
    rt = PiperRuntime(*voices["medium"], RuntimeOptions(mode="fused"), mesh=mesh)
    single = PiperRuntime(*voices["medium"], device="cuda")
    served: list = []
    with BatchingServer(rt, max_batch=8, max_wait_ms=10.0) as server:
        server.prewarm(p_buckets=[16, 32, 64, 128])
        counters = _zero_counts()
        mesh.reset_launches()
        threads = [threading.Thread(target=lambda i=i: served.append(run_traffic(
            lambda rng, ids: server.submit(ids), MESH_SERVE_S, np.random.default_rng(200 + i),
            MESH_SERVE_RATE / 2, rt.sample_rate)), name=f"mesh-client-{i}") for i in range(2)]
        for t in threads:
            t.start()
        zero = [(f, server.submit(FIXTURE_PHONEME_IDS * f, noise_scale=0.0, noise_w=0.0))
                for f in FACTORS]
        for t in threads:
            t.join()
        zero_audio = [(f, fut.result(timeout=300)) for f, fut in zero]
        launches = _require_launches("mesh_serve", counters)
        metrics = server.metrics()
    per_slot = [dict(c) for c in mesh.slot_launches]
    if not all(c.get("resblock1_branch", 0) > 0 and c.get("resblock1_mrf", 0) > 0
               for c in per_slot):
        raise AssertionError(f"mesh_serve: a slot launched no K2/K3: {per_slot}")
    if metrics["failed"] or metrics["shed_overload"] or metrics["shed_deadline"]:
        raise AssertionError(f"mesh_serve: failed or shed: {metrics}")
    if len(served) != 2 or any(sum(shed.values()) for _, _, _, shed in served):
        raise AssertionError(f"mesh_serve: a submitter failed or was shed")
    errs = []
    for f, got in zero_audio:
        want = single.synthesize(FIXTURE_PHONEME_IDS * f, noise_scale=0.0, noise_w=0.0)
        if got.shape != want.shape:
            raise AssertionError(f"mesh_serve f={f}: {got.shape} vs one device {want.shape}")
        err = float(np.abs(got - want).max())
        if not err <= WAVE_ATOL:
            raise AssertionError(f"mesh_serve f={f}: max-abs {err} > {WAVE_ATOL}")
        errs.append({"factor": f, "max_abs_err": err})
    lat = sorted(x * 1e3 for results, _, _, _ in served for x, _, _ in results)
    emit(phase="mesh_serve", mesh=mesh.shape, batch_ladder=list(rt.batch_ladder),
         rate_req_s=MESH_SERVE_RATE, seconds=MESH_SERVE_S, requests=len(lat),
         latency_ms={"p50": _pct(lat, 50), "p95": _pct(lat, 95), "max": lat[-1]},
         rows_per_group=metrics["rows_per_group"], groups=metrics["groups"],
         zero_noise_vs_one_device=errs, launches=launches, slot_launches=per_slot,
         hbm_bytes=rt.hbm_bytes(), wall_s=time.perf_counter() - t_phase)
    rt.close()
    return launches


def phase_onnx_native(voices: dict) -> None:
    """load_model of the medium voice through the native parser (built at
    first use from piper_tpu_torch/native/onnx_parser.cpp) and through the
    Python decoder: equal initializers and nodes; the best of three load
    times of each."""
    from piper_tpu_torch.native.build import library_path
    from piper_tpu_torch.onnx.loader import _load_model_python, load_model

    model = voices["medium"][0]
    times = {}
    for name, fn in (("native", load_model), ("python", _load_model_python)):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            m = fn(model)
            best = min(best, time.perf_counter() - t0)
        times[name] = (best, m)
    nat, py = times["native"][1], times["python"][1]
    if set(nat.graph.initializers) != set(py.graph.initializers):
        raise AssertionError("onnx_native: the initializer names differ")
    for k, t in py.graph.initializers.items():
        u = nat.graph.initializers[k]
        if u.dims != t.dims or u.data_type != t.data_type or not np.array_equal(
                np.asarray(u.array), np.asarray(t.array)):
            raise AssertionError(f"onnx_native: initializer {k} differs")
    if [(n.op_type, n.inputs, n.outputs, sorted(n.attributes)) for n in nat.graph.nodes] != \
            [(n.op_type, n.inputs, n.outputs, sorted(n.attributes)) for n in py.graph.nodes]:
        raise AssertionError("onnx_native: the nodes differ")
    if next(iter(nat.graph.initializers.values())).array.flags.writeable:
        raise AssertionError("onnx_native: load_model did not take the native parser")
    emit(phase="onnx_native", voice="synthetic medium, seed 0",
         bytes=Path(model).stat().st_size, initializers=len(py.graph.initializers),
         nodes=len(py.graph.nodes), native_s=times["native"][0], python_s=times["python"][0],
         library=library_path(["onnx_parser.cpp"], "libpiper_onnx").name)


def phase_soak(torch, voices: dict) -> dict:
    """SOAK_S seconds of tests/test_torch_unified_soak.py's churn on the
    card: one UnifiedServer over the medium voice and a 3-speaker medium
    voice at the mixed tiers, mixed submits, streams, cancels,
    add_voice/remove_voice and sheds; no hang, no unexpected error, no
    leaked thread; K2 and K3 launched."""
    import importlib.util

    from piper_tpu_torch.engine.runtime import RuntimeOptions
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

    t_phase = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "torch_unified_soak", ROOT / "tests" / "test_torch_unified_soak.py")
    soak = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak)
    multi = make_synthetic_voice(ROOT / "build" / "chip_smoke_voice_medium_soak",
                                 quality="medium", seed=2, n_speakers=3)
    counters = _zero_counts()
    stats = soak.run_soak(voices["medium"], multi, SOAK_S, device="cuda",
                          options=RuntimeOptions(**BENCH_MIX))
    launches = _require_launches("soak", counters)
    if stats["submits"] < 20 or stats["streams"] < 5:
        raise AssertionError(f"soak: too little traffic: {stats}")
    emit(phase="soak", **stats, launches=launches, wall_s=time.perf_counter() - t_phase)
    return launches


def _kernel_entry(name: str, tiers: dict, launches: int) -> dict:
    """A kernel's entry in the kernels line, at the "highest" tier: `ms`
    and `plain_ms` are device times (torch.profiler), beside `bound_ms`;
    the CUDA-event times are `event_ms` and `plain_event_ms`."""
    row = tiers["highest"]
    entry = {"name": name, "route": "cuda", "source": KERNELS[name][0],
             "replaces": KERNELS[name][1], "launches": launches,
             "max_abs_err": row["max_abs_err"], "ms": row["device_ms"],
             "plain_ms": row["plain_device_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"],
             # K5's plain version is the one PyTorch call that computes it;
             # K1's wide rows time the library route they replaced.
             "library_ms": row["library_ms"] if "library_ms" in row else
             None if name in NO_LIBRARY_CALL else row["plain_device_ms"],
             "event_ms": row["ms"], "plain_event_ms": row["plain_ms"]}
    if name in NO_LIBRARY_CALL:
        entry["no_library_call"] = NO_LIBRARY_CALL[name]
    if len(tiers) > 1:
        entry["tiers"] = tiers
    return entry


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU and has no CPU path")
    if not (ROOT / "piper_tpu_torch").is_dir():
        fail(f"run from the root of a piper-tpu checkout ({ROOT} holds no piper_tpu_torch)")
    sys.path.insert(0, str(ROOT))
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

    phase_device(torch)
    phase_build()
    kernels = phase_kernels(torch)
    launches = {name: 0 for name in KERNELS}

    def count(path_launches):
        for name, n in path_launches.items():
            launches[name] += n

    # The probes first: their many short torch.profiler windows have come
    # back empty late in a long process.
    count(phase_probe())
    count(phase_ct_probe())
    count(phase_level_probe())
    count(phase_resblock_probe())
    phase_calibrate()
    voices, card = {}, {}
    for quality in ("medium", "x_low"):
        model, config = make_synthetic_voice(ROOT / "build" / f"chip_smoke_voice_{quality}",
                                             quality=quality, seed=0)
        voices[quality] = (model, config)
        rt, counts = phase_main_path(torch, quality, model, config)
        count(counts)
        phase_compare(torch, quality, rt, PiperRuntime(model, config, device="cpu"),
                      WAVE_ATOL, "cpu")
        mixed = f"{quality}_mixed"
        rt_mixed, counts = phase_main_path(torch, mixed, model, config,
                                           RuntimeOptions(**BENCH_MIX))
        count(counts)
        phase_compare(torch, mixed, rt_mixed, rt, MIXED_ATOL, "card highest")
        card[quality], card[mixed] = rt, rt_mixed
        phase_profile(torch, {quality: rt, mixed: rt_mixed})
        count(phase_stream(torch, quality, rt, WAVE_ATOL))
        count(phase_stream(torch, mixed, rt_mixed, MIXED_ATOL))
        count(phase_golden(quality, rt))
        count(phase_golden(mixed, rt_mixed))
        if quality == "medium":
            count(phase_seeded(torch, rt, model, config))
        serving = quality == "medium"
        count(phase_batch(quality, rt, WAVE_ATOL, serving))
        count(phase_batch(mixed, rt_mixed, MIXED_ATOL, serving))
        if serving:
            count(phase_pipeline(model, config))
    count(phase_serve(torch, voices))
    count(phase_stream_serve(torch, "medium_mixed", card["medium_mixed"], MIXED_ATOL))
    count(phase_stream_serve(torch, "x_low_mixed", card["x_low_mixed"], MIXED_ATOL))
    count(phase_stream_serve(torch, "medium", card["medium"], WAVE_ATOL))
    count(phase_unified(torch, voices))
    count(phase_http(torch, voices))
    count(phase_roofline(torch, card))
    count(phase_cli(torch, voices, card))
    count(phase_bf16(torch, voices, card))
    count(phase_debug_trace(torch, voices, card))
    del card
    count(phase_mesh(torch, voices))
    count(phase_mesh_serve(torch, voices))
    phase_onnx_native(voices)
    count(phase_soak(torch, voices))
    count(phase_tools(torch, voices))
    count(phase_high(torch))
    count(phase_multispeaker(torch))
    count(phase_bench())
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "piper_tpu"))
    if foreign:
        raise AssertionError(f"imported {foreign}")
    phase_mixed_margin()
    from piper_tpu_torch.tools.timing import SENTINELS, WINDOWS
    emit(phase="profiler_windows", sentinels=SENTINELS, **WINDOWS)
    # conv1d_same's counter counts both of K1's designs: its entry is the
    # narrow one's.
    launches["conv1d_same"] -= launches["conv1d_same_wide"]
    emit(kernels=[_kernel_entry(name, tiers, launches[name]) for name, tiers in kernels.items()])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
