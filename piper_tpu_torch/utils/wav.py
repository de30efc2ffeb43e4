"""Streaming mono 16-bit PCM WAV writer (reference: WavFileWriter.swift:4-78);
the port's copy of piper_tpu.utils.wav.

Header sizes are patched on finalize so chunks can stream to disk as they
arrive."""

from __future__ import annotations

import struct
from pathlib import Path
from typing import BinaryIO, Optional, Union

import numpy as np

from piper_tpu_torch.core.audio import float_to_int16


class WavWriter:
    def __init__(self, path: Union[str, Path, BinaryIO], sample_rate: int, channels: int = 1):
        if hasattr(path, "write"):
            self._f: BinaryIO = path  # type: ignore[assignment]
            self._owns = False
        else:
            self._f = open(path, "wb")
            self._owns = True
        self.sample_rate = sample_rate
        self.channels = channels
        self._data_bytes = 0
        self._finalized = False
        self._write_header(data_bytes=0)

    def _write_header(self, data_bytes: int) -> None:
        f = self._f
        byte_rate = self.sample_rate * self.channels * 2
        block_align = self.channels * 2
        f.seek(0)
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + data_bytes))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, self.channels, self.sample_rate,
                            byte_rate, block_align, 16))
        f.write(b"data")
        f.write(struct.pack("<I", data_bytes))

    def append_float32(self, samples: np.ndarray) -> None:
        if self._finalized:
            raise RuntimeError("WavWriter already finalized")
        pcm = float_to_int16(samples)
        self._f.write(pcm.astype("<i2").tobytes())
        self._data_bytes += pcm.size * 2

    def append_int16(self, samples: np.ndarray) -> None:
        if self._finalized:
            raise RuntimeError("WavWriter already finalized")
        pcm = np.asarray(samples, dtype="<i2")
        self._f.write(pcm.tobytes())
        self._data_bytes += pcm.size * 2

    def finalize(self) -> None:
        if self._finalized:
            return
        self._write_header(self._data_bytes)
        self._f.flush()
        if self._owns:
            self._f.close()
        self._finalized = True

    def __enter__(self) -> "WavWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.finalize()


def write_wav(path: Union[str, Path], samples: np.ndarray, sample_rate: int) -> None:
    with WavWriter(path, sample_rate) as w:
        if np.asarray(samples).dtype == np.int16:
            w.append_int16(samples)  # already device-converted PCM16
        else:
            w.append_float32(samples)


def parse_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an in-memory WAV of the layout WavWriter produces: returns
    (float32 samples in [-1, 1], sample_rate). Used by the HTTP client on
    response bodies and by read_wav on files."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a WAV payload")
    # fmt chunk at fixed offset for files we write.
    (sample_rate,) = struct.unpack_from("<I", data, 24)
    pos = 36
    if data[pos : pos + 4] != b"data":
        raise ValueError("unexpected WAV chunk layout")
    (n,) = struct.unpack_from("<I", data, pos + 4)
    pcm = np.frombuffer(data, dtype="<i2", count=n // 2, offset=pos + 8)
    return pcm.astype(np.float32) / 32767.0, sample_rate


def read_wav(path: Union[str, Path]) -> tuple[np.ndarray, int]:
    """Minimal reader for our own files (tests): returns (float32 samples, rate)."""
    with open(path, "rb") as f:
        return parse_wav_bytes(f.read())
