"""Phoneme-level alignment of synthesized audio (a copy of
piper_tpu.core.alignment, which imports only numpy; the port keeps its own
so it imports nothing of the JAX package).

The duration predictor gives every input phoneme an integer number of
frames (`w_ceil`), and the decoder expands the prior along exactly that
plan, so each phoneme owns a contiguous span of the waveform: subtitles,
lip sync, karaoke highlighting. The runtime's seeded duration noise is one
draw per row, so `PiperRuntime.phoneme_durations()` returns the plan that
any synthesis with the same arguments realized, however it was batched.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass(frozen=True)
class PhonemeAlignment:
    """Per-phoneme timing of one synthesized utterance.

    `durations_frames[i]` is the number of mel frames phoneme `i` was
    assigned; its audio spans samples
    `[start_samples[i], end_samples[i])` at `sample_rate`.

    `total_samples` is the length of the audio actually produced. When the
    planned frames exceed the runtime's largest frame bucket the audio is
    truncated (the runtime warns) — spans are clipped to the audio and
    `truncated` is True.
    """

    phoneme_ids: tuple
    durations_frames: np.ndarray  # (P,) int64 — planned frames per phoneme
    hop_length: int
    sample_rate: int
    total_samples: int

    def __post_init__(self):
        if len(self.phoneme_ids) != len(self.durations_frames):
            raise ValueError(
                f"{len(self.phoneme_ids)} phonemes vs "
                f"{len(self.durations_frames)} durations")

    @property
    def total_frames(self) -> int:
        """Planned frames (pre-truncation)."""
        return int(self.durations_frames.sum())

    @property
    def truncated(self) -> bool:
        return self.total_frames * self.hop_length > self.total_samples

    @property
    def start_samples(self) -> np.ndarray:
        """(P,) inclusive start sample of each phoneme's span (clipped)."""
        starts = np.concatenate(
            ([0], np.cumsum(self.durations_frames)[:-1])) * self.hop_length
        return np.minimum(starts, self.total_samples)

    @property
    def end_samples(self) -> np.ndarray:
        """(P,) exclusive end sample of each phoneme's span (clipped)."""
        ends = np.cumsum(self.durations_frames) * self.hop_length
        return np.minimum(ends, self.total_samples)

    @property
    def start_seconds(self) -> np.ndarray:
        return self.start_samples / float(self.sample_rate)

    @property
    def end_seconds(self) -> np.ndarray:
        return self.end_samples / float(self.sample_rate)

    def to_dict(self, offset_samples: int = 0) -> dict:
        """JSON-able form; `offset_samples` shifts every span (the position
        of this utterance inside a joined multi-sentence waveform)."""
        starts = self.start_samples + offset_samples
        ends = self.end_samples + offset_samples
        sr = float(self.sample_rate)
        return {
            "sample_rate": self.sample_rate,
            "hop_length": self.hop_length,
            "total_samples": self.total_samples,
            "truncated": self.truncated,
            "phonemes": [
                {
                    "id": int(pid),
                    "frames": int(self.durations_frames[i]),
                    "start_sample": int(starts[i]),
                    "end_sample": int(ends[i]),
                    "start_s": round(float(starts[i]) / sr, 6),
                    "end_s": round(float(ends[i]) / sr, 6),
                }
                for i, pid in enumerate(self.phoneme_ids)
            ],
        }


def make_alignment(
    phoneme_ids: Sequence[int],
    durations_frames: np.ndarray,
    *,
    hop_length: int,
    sample_rate: int,
    total_samples: int,
) -> PhonemeAlignment:
    return PhonemeAlignment(
        phoneme_ids=tuple(int(i) for i in phoneme_ids),
        durations_frames=np.asarray(durations_frames, np.int64),
        hop_length=int(hop_length),
        sample_rate=int(sample_rate),
        total_samples=int(total_samples),
    )


def alignments_to_json(
    alignments: List[PhonemeAlignment],
    offsets_samples: Sequence[int],
) -> dict:
    """Multi-utterance (e.g. per-sentence) alignment document: one entry per
    utterance, spans shifted to positions inside the joined waveform."""
    if len(alignments) != len(offsets_samples):
        raise ValueError(
            f"{len(alignments)} alignments vs {len(offsets_samples)} offsets")
    return {
        "utterances": [
            a.to_dict(offset_samples=int(off))
            for a, off in zip(alignments, offsets_samples)
        ]
    }
