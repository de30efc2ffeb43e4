"""Incremental audio playback: pipe PCM chunks into a player process.

The reference schedules synthesized buffers into a live AVAudioEngine as
they arrive (AudioPlayer.swift:4-43, wired to the CLI's playback latch at
PiperCLI.swift:7-29). The TPU-side analog streams raw 16-bit PCM into an
external player's stdin (aplay/paplay read raw streams natively), so
playback starts after the FIRST chunk of an incremental decode instead of
after the whole utterance.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from typing import List, Optional

import numpy as np


def _default_player_cmd(sample_rate: int) -> Optional[List[str]]:
    """A player command that accepts raw s16le mono PCM on stdin, or None.

    afplay (macOS) cannot read a raw stream from stdin — callers should fall
    back to whole-file playback there (cli._play does)."""
    if shutil.which("aplay"):
        return ["aplay", "-q", "-f", "S16_LE", "-r", str(sample_rate),
                "-c", "1", "-t", "raw", "-"]
    if shutil.which("paplay"):
        return ["paplay", "--raw", "--format=s16le",
                f"--rate={sample_rate}", "--channels=1"]
    if shutil.which("ffplay"):
        return ["ffplay", "-nodisp", "-autoexit", "-loglevel", "quiet",
                "-f", "s16le", "-ar", str(sample_rate), "-ch_layout", "mono",
                "-i", "-"]
    return None


def to_int16_pcm(samples: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] (or already-int16) samples -> int16 PCM, the exact
    device-side conversion semantics (clip then scale by 32767)."""
    a = np.asarray(samples)
    if a.dtype == np.int16:
        return a
    return (np.clip(a.astype(np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)


class StreamingPlayer:
    """Feeds PCM chunks to a player subprocess as synthesis produces them.

    Usage:
        with StreamingPlayer(sample_rate) as sp:
            for chunk in rt.synthesize_stream(ids, incremental=True):
                sp.play(chunk.samples)

    `player_cmd` overrides the auto-detected player (tests inject a
    recording stub). Raises RuntimeError at construction when no streaming-
    capable player exists, so callers can fall back to file playback."""

    def __init__(self, sample_rate: int,
                 player_cmd: Optional[List[str]] = None):
        cmd = player_cmd or _default_player_cmd(sample_rate)
        if cmd is None:
            raise RuntimeError(
                "no streaming-capable audio player found (aplay/paplay/ffplay)"
            )
        self.sample_rate = sample_rate
        self._proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        self.samples_played = 0

    def play(self, samples: np.ndarray) -> None:
        """Append one chunk (blocking only on the player's own buffering —
        i.e. roughly real time once its buffer fills, which is the natural
        pacing for live playback)."""
        pcm = to_int16_pcm(samples)
        if self._proc.stdin is None or self._proc.poll() is not None:
            return  # player died (e.g. no audio device); keep synthesizing
        try:
            self._proc.stdin.write(pcm.tobytes())
            self._proc.stdin.flush()
            self.samples_played += len(pcm)
        except (BrokenPipeError, OSError):
            pass

    def close(self, wait: bool = True) -> None:
        """End of stream: close stdin so the player drains and exits."""
        if self._proc.stdin is not None:
            try:
                self._proc.stdin.close()
            except OSError:
                pass
        if wait:
            try:
                self._proc.wait(timeout=600)
            except subprocess.TimeoutExpired:
                self._proc.terminate()

    def __enter__(self) -> "StreamingPlayer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def play_stream(chunks, sample_rate: int,
                player_cmd: Optional[List[str]] = None,
                on_first=None):
    """Drive a chunk iterator through a StreamingPlayer; returns total
    samples. `on_first` is called right after the first chunk is handed to
    the player (the TTFB hook the CLI uses)."""
    n = 0
    with StreamingPlayer(sample_rate, player_cmd=player_cmd) as sp:
        for chunk in chunks:
            sp.play(chunk.samples)
            if n == 0 and on_first is not None:
                on_first()
            n += len(chunk.samples)
    return n
