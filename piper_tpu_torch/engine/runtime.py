"""PiperRuntime: load a Piper voice and synthesize one utterance.

Counterpart of piper_tpu.engine.runtime's split mode: pad the phoneme ids to
a bucket, encode, read the frame count on the host once, pick the frame
bucket, decode, and return PCM. The device is explicit; weights go to it
once. Synthesis runs in fp32 with TF32 off for matmuls and cuDNN convs: a
duration error can flip a ceil() and shift the whole waveform.

Seeded noise comes from a torch.Generator seeded from (seed, 0) for the
duration predictor and (seed, 1) for the prior; each is one per-row draw
broadcast over the rows, so a row's noise does not depend on what is
batched beside it. The numbers differ from the JAX package's threefry by
design; parity checks inject the noise instead.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from piper_tpu.core.config import VoiceConfig
from piper_tpu.models.vits.hparams import VitsHParams, derive_hparams
from piper_tpu.onnx.loader import load_model
from piper_tpu_torch.engine.bucketing import (
    DEFAULT_FRAME_BUCKETS,
    DEFAULT_PHONEME_BUCKETS,
    BucketOverflowError,
    bucket_for,
    pad_to,
)
from piper_tpu_torch.models.vits import model as vits
from piper_tpu_torch.models.vits.params import host_arrays_from_graph, params_to_torch


@dataclass(frozen=True)
class RuntimeOptions:
    """The knobs of piper_tpu's RuntimeOptions that this slice carries.

    Only the "highest" (fp32) tier and split mode exist so far; other values
    raise, naming the later change that brings them."""

    seed: int = 1234
    precision: str = "highest"
    vocoder_precision: Optional[str] = None
    flow_precision: Optional[str] = None
    mode: str = "split"
    phoneme_buckets: Tuple[int, ...] = tuple(DEFAULT_PHONEME_BUCKETS)
    frame_buckets: Tuple[int, ...] = tuple(DEFAULT_FRAME_BUCKETS)
    output_dtype: str = "float32"  # or "int16": clip * 32767, cast on the device

    def validate(self) -> None:
        if self.precision != "highest":
            raise ValueError(f"precision {self.precision!r}: only 'highest' (fp32) "
                             f"is ported; lower tiers come in a later change")
        for name in ("vocoder_precision", "flow_precision"):
            tier = getattr(self, name)
            if tier not in (None, "highest"):
                raise ValueError(f"{name} {tier!r}: only None or 'highest' is "
                                 f"ported; lower tiers come in a later change")
        if self.mode != "split":
            raise ValueError(f"mode {self.mode!r}: only 'split' is ported; "
                             f"fused mode comes in a later change")
        if self.output_dtype not in ("float32", "int16"):
            raise ValueError(f"output_dtype must be 'float32' or 'int16', "
                             f"got {self.output_dtype!r}")


@dataclass
class RunTimings:
    """Per-run accounting (host clock; both phases end in a host read)."""

    wall_ms: float = 0.0
    encode_ms: float = 0.0
    decode_ms: float = 0.0
    phoneme_bucket: int = 0
    frame_bucket: int = 0
    frames: int = 0
    samples: int = 0
    rtf: float = 0.0  # real-time factor (audio seconds per wall second)


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for matmuls and cuDNN convs within the block, restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def seeded_noise(seed: int, stream: int, shape: Tuple[int, ...], rows: int,
                 device) -> torch.Tensor:
    """One standard-normal draw of `shape` from the generator of
    (seed, stream), broadcast to (rows, *shape)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(seed) & 0xFFFFFFFF) << 8) | stream)
    draw = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return draw.expand(rows, *shape)


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {device!r}")
    return dev


class PiperRuntime:
    """Loads a Piper voice checkpoint and synthesizes speech on one device."""

    def __init__(
        self,
        model_path: Union[str, Path],
        config_path: Union[str, Path, None] = None,
        options: Optional[RuntimeOptions] = None,
        *,
        device: Union[str, torch.device],
    ):
        self.options = options or RuntimeOptions()
        self.options.validate()
        self.device = _resolve_device(device)
        self.model_path = Path(model_path)
        if not self.model_path.exists():
            raise FileNotFoundError(f"model checkpoint not found: {self.model_path}")
        self.config_path = Path(config_path) if config_path else Path(str(model_path) + ".json")
        self.config = VoiceConfig.load(self.config_path)
        graph = load_model(self.model_path).graph
        self.hparams: VitsHParams = derive_hparams(
            graph, sample_rate=self.config.audio.sample_rate,
            n_speakers=self.config.num_speakers)
        if self.hparams.n_speakers > 1:
            raise NotImplementedError("multi-speaker voices are not ported yet")
        self.params = params_to_torch(host_arrays_from_graph(graph), self.device)
        self.last_run_timings: Optional[RunTimings] = None

    @property
    def sample_rate(self) -> int:
        return self.config.audio.sample_rate

    def _scales(self, noise_scale, length_scale, noise_w):
        inf = self.config.inference
        ns = inf.noise_scale if noise_scale is None else float(noise_scale)
        ls = inf.length_scale if length_scale is None else float(length_scale)
        nw = inf.noise_w if noise_w is None else float(noise_w)
        if not (math.isfinite(ls) and ls > 0):
            raise ValueError(f"length_scale must be > 0, got {ls}")
        for name, v in (("noise_scale", ns), ("noise_w", nw)):
            if not (math.isfinite(v) and v >= 0):
                raise ValueError(f"{name} must be finite and >= 0, got {v}")
        return ns, ls, nw

    def _frame_bucket(self, needed: int) -> int:
        try:
            return bucket_for(max(1, needed), self.options.frame_buckets, "frame")
        except BucketOverflowError:
            largest = self.options.frame_buckets[-1]
            print(f"[piper-tpu-torch] warning: predicted {needed} frames exceeds the "
                  f"largest bucket {largest}; audio will be truncated", file=sys.stderr)
            return largest

    def synthesize(
        self,
        phoneme_ids: Sequence[int],
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        seed: Optional[int] = None,
        dp_noise: Optional[np.ndarray] = None,
        main_noise: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Synthesize one utterance; PCM in the runtime's output_dtype.

        `dp_noise` (2, P') and `main_noise` (C, F') inject the noise tensors
        (zero-padded to the buckets) in place of the seeded draws."""
        t_start = time.perf_counter()
        hp = self.hparams
        ids = list(phoneme_ids)
        if not ids:
            raise ValueError("empty phoneme sequence")
        bad = [i for i in ids if not 0 <= i < hp.n_vocab]
        if bad:
            raise ValueError(f"phoneme id(s) {bad[:5]} out of range [0, {hp.n_vocab}) — "
                             f"check the voice's phoneme_id_map")
        ns, ls, nw = self._scales(noise_scale, length_scale, noise_w)
        base_seed = self.options.seed if seed is None else seed
        p_bucket = bucket_for(len(ids), self.options.phoneme_buckets, "phoneme")
        dev = self.device

        with torch.inference_mode(), fp32_exact():
            ids_t = torch.from_numpy(pad_to(np.asarray(ids, np.int64), p_bucket)[None]).to(dev)
            lengths_t = torch.tensor([len(ids)], dtype=torch.int64, device=dev)
            if dp_noise is not None:
                src = np.asarray(dp_noise, np.float32).reshape(1, 2, -1)
                dpn = np.zeros((1, 2, p_bucket), np.float32)
                dpn[:, :, : src.shape[-1]] = src
                dpn_t = torch.from_numpy(dpn).to(dev)
            else:
                dpn_t = seeded_noise(base_seed, 0, (2, p_bucket), 1, dev)
            enc = vits.encode(self.params, hp, ids_t, lengths_t, dpn_t,
                              length_scale=ls, noise_w=nw)
            # The one host read between the phases: the frame count picks
            # the decode bucket.
            y_total = int(enc.y_total.max().item())
            t_encode = time.perf_counter()

            if main_noise is not None:
                src = np.asarray(main_noise, np.float32).reshape(1, hp.inter_channels, -1)
                try:
                    f_bucket = bucket_for(max(1, y_total, src.shape[-1]),
                                          self.options.frame_buckets, "frame")
                except BucketOverflowError:
                    f_bucket = self.options.frame_buckets[-1]
                    src = src[:, :, :f_bucket]
                mn = np.zeros((1, hp.inter_channels, f_bucket), np.float32)
                mn[:, :, : src.shape[-1]] = src
                mn_t = torch.from_numpy(mn).to(dev)
            else:
                f_bucket = self._frame_bucket(y_total)
                mn_t = seeded_noise(base_seed, 1, (hp.inter_channels, f_bucket), 1, dev)
            audio, _ = vits.decode(self.params, hp, enc, mn_t, max_frames=f_bucket,
                                   noise_scale=ns)
            if self.options.output_dtype == "int16":
                audio = (torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16)
            audio = audio.cpu().numpy()
        t_end = time.perf_counter()

        y_len = min(max(y_total, 1), f_bucket)
        out = audio[0, : y_len * hp.hop_length]
        wall = t_end - t_start
        self.last_run_timings = RunTimings(
            wall_ms=wall * 1e3,
            encode_ms=(t_encode - t_start) * 1e3,
            decode_ms=(t_end - t_encode) * 1e3,
            phoneme_bucket=p_bucket,
            frame_bucket=f_bucket,
            frames=y_len,
            samples=len(out),
            rtf=(len(out) / self.sample_rate) / wall if wall > 0 else 0.0,
        )
        return out
