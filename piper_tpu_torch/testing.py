"""Test-vector recording.

Produces `test_summary.json` bundles in the reference's schema
(PiperTestVector.swift:3-52, bench/fixtures/test_summary.json): phoneme ids,
synthesis metadata, recorded float32/int16/WAV audio, audio stats, and —
crucially — the recorded RNG tensors (`random_files`) that make the waveform
bit-reproducible when injected back (the reference relied on vectors recorded
by an external tool; here recording is built in)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from piper_tpu_torch.core.audio import float_to_int16
from piper_tpu_torch.engine.runtime import PiperRuntime
from piper_tpu_torch.utils.wav import write_wav


def record_test_vector(
    rt: PiperRuntime,
    phoneme_ids: Sequence[int],
    out_dir: str | Path,
    test_id: str,
    *,
    noise_scale: Optional[float] = None,
    length_scale: Optional[float] = None,
    noise_w: Optional[float] = None,
    speaker_id: Optional[int] = None,
    seed: int = 0,
    description: str = "",
) -> Dict:
    """Synthesize once with freshly drawn, recorded noise; write all artifacts.

    Returns the test-vector dict (paths relative to out_dir)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    hp = rt.hparams
    rng = np.random.default_rng(seed)
    p = len(phoneme_ids)
    dp_noise = rng.standard_normal((1, 2, p)).astype(np.float32)

    # Probe durations to size the recorded main noise to the frame bucket.
    rt.synthesize(
        phoneme_ids,
        noise_scale=noise_scale,
        length_scale=length_scale,
        noise_w=noise_w,
        speaker_id=speaker_id,
        dp_noise=dp_noise,
    )
    frame_bucket = rt.last_run_timings.frame_bucket
    main_noise = rng.standard_normal((1, hp.inter_channels, frame_bucket)).astype(np.float32)

    # Time only the recorded synthesis (the probe above is bookkeeping).
    t0 = time.perf_counter()
    audio = rt.synthesize(
        phoneme_ids,
        noise_scale=noise_scale,
        length_scale=length_scale,
        noise_w=noise_w,
        speaker_id=speaker_id,
        dp_noise=dp_noise,
        main_noise=main_noise,
    )
    elapsed = time.perf_counter() - t0

    dp_path = f"{test_id}_dp_noise.bin"
    main_path = f"{test_id}_main_noise.bin"
    f32_path = f"{test_id}_audio_f32.bin"
    i16_path = f"{test_id}_audio_i16.bin"
    wav_path = f"{test_id}.wav"
    dp_noise.astype("<f4").tofile(out_dir / dp_path)
    main_noise.astype("<f4").tofile(out_dir / main_path)
    audio.astype("<f4").tofile(out_dir / f32_path)
    i16 = float_to_int16(audio)
    i16.astype("<i2").tofile(out_dir / i16_path)
    write_wav(out_dir / wav_path, audio, rt.sample_rate)

    inf = rt.config.inference
    duration_s = len(audio) / rt.sample_rate
    return {
        "test_id": test_id,
        "phoneme_ids": [int(x) for x in phoneme_ids],
        "metadata": {
            "inference_time_sec": elapsed,
            "audio_duration_sec": duration_s,
            "real_time_factor": duration_s / elapsed if elapsed > 0 else 0,
            "num_samples": int(len(audio)),
            "sample_rate": rt.sample_rate,
            "input_length": p,
            "noise_scale": inf.noise_scale if noise_scale is None else noise_scale,
            "length_scale": inf.length_scale if length_scale is None else length_scale,
            "noise_w": inf.noise_w if noise_w is None else noise_w,
            "speaker_id": speaker_id,
            "raw_output_shape": [1, 1, 1, int(len(audio))],
        },
        "audio_files": {"float32": f32_path, "int16": i16_path, "wav": wav_path},
        "audio_stats": {
            "float32_min": float(audio.min()),
            "float32_max": float(audio.max()),
            "float32_mean": float(audio.mean()),
            "float32_std": float(audio.std()),
            "int16_min": int(i16.min()),
            "int16_max": int(i16.max()),
            "int16_mean": float(i16.mean()),
            "int16_std": float(i16.std()),
        },
        "random_files": {
            "dp_randomnormalike": dp_path,
            "main_randomnormalike": main_path,
            "dp_shape": [1, 2, p],
            "main_shape": [1, hp.inter_channels, frame_bucket],
        },
        "description": description,
    }


def write_test_summary(
    rt: PiperRuntime,
    vectors: List[Dict],
    out_path: str | Path,
) -> Path:
    out_path = Path(out_path)
    summary = {
        "model_path": str(rt.model_path),
        "config_path": str(rt.config_path),
        "num_tests": len(vectors),
        "results": vectors,
    }
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(summary, f, indent=2)
    return out_path


def replay_test_vector(rt: PiperRuntime, summary_path: str | Path, index: int = 0) -> Dict:
    """Re-run a recorded vector with injected RNG; return comparison stats."""
    from piper_tpu_torch.core.test_vector import TestSummary

    s = TestSummary.load(summary_path)
    tv = s.results[index]
    dp = tv.random_files.load_dp(s.base_dir)
    main = tv.random_files.load_main(s.base_dir)
    recorded = np.fromfile(s.base_dir / tv.audio_files["float32"], dtype="<f4")
    audio = rt.synthesize(
        tv.phoneme_ids,
        noise_scale=tv.metadata.noise_scale,
        length_scale=tv.metadata.length_scale,
        noise_w=tv.metadata.noise_w,
        speaker_id=tv.metadata.speaker_id,
        dp_noise=dp,
        main_noise=main,
    )
    n = min(len(audio), len(recorded))
    max_abs = float(np.max(np.abs(audio[:n] - recorded[:n]))) if n else float("inf")
    return {
        "test_id": tv.test_id,
        "samples": int(len(audio)),
        "recorded_samples": int(len(recorded)),
        "length_match": len(audio) == len(recorded),
        "max_abs_err": max_abs,
    }
