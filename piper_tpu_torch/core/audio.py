"""Streaming audio value types (reference: PiperAudio.swift:3-27)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class AudioFormat:
    sample_rate: int
    channels: int = 1


@dataclass(frozen=True)
class AudioChunk:
    """A chunk of synthesized PCM audio — float32 in [-1, 1] by default,
    int16 when the producing runtime's output_dtype is "int16".

    `start_sample_index` is the absolute offset of this chunk's first sample
    within the full utterance; `is_final` marks the last chunk of a stream.
    """

    format: AudioFormat
    start_sample_index: int
    samples: np.ndarray  # shape (n,); dtype follows the runtime's output_dtype
    is_final: bool = False

    @property
    def duration_seconds(self) -> float:
        return float(len(self.samples)) / float(self.format.sample_rate)


def float_to_int16(samples: np.ndarray) -> np.ndarray:
    """Convert float32 PCM in [-1, 1] to int16 with clipping (int16 input —
    audio from an output_dtype='int16' runtime — passes through)."""
    arr = np.asarray(samples)
    if arr.dtype == np.int16:
        return arr
    scaled = np.clip(arr.astype(np.float32), -1.0, 1.0) * 32767.0
    return scaled.astype(np.int16)


def join_with_silence(audios, gap_samples: int) -> np.ndarray:
    """Concatenate float32 audio arrays with `gap_samples` of silence
    between consecutive parts (one join helper so the CLI, REPL, and HTTP
    sentence paths cannot drift)."""
    gap_samples = int(gap_samples)
    if gap_samples < 0:
        raise ValueError(f"sentence_silence must be >= 0 (gap of "
                         f"{gap_samples} samples requested)")
    gap = np.zeros(gap_samples, np.float32)
    parts = []
    for i, a in enumerate(audios):
        if i and gap_samples:
            parts.append(gap)
        # int16-runtime output normalizes to [-1, 1] — a bare float32
        # upcast would leave +/-32767-scale values that saturate every
        # downstream encoder.
        parts.append(pcm_to_float32(a))
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


def pcm_to_float32(samples) -> np.ndarray:
    """Normalize audio to float32 in [-1, 1]: int16 PCM (an
    output_dtype='int16' runtime's native output) scales down; float
    passes through. Inverse companion of float_to_int16."""
    arr = np.asarray(samples)
    if arr.dtype == np.int16:
        return arr.astype(np.float32) / 32767.0
    return arr.astype(np.float32)
