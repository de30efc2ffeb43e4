"""Full VITS inference graph (counterpart of piper_tpu.models.vits.model).

`encode` / `decode` are the split entry points: the runtime reads the
frame count on the host between them to pick the frame bucket. `infer` runs
both; `debug_infer` returns every module-boundary tensor, with the same keys
as the JAX package's, for parity checks. Single-speaker only so far.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from piper_tpu.models.vits.hparams import VitsHParams
from piper_tpu_torch.models.vits.duration_predictor import stochastic_duration_predictor_reverse
from piper_tpu_torch.models.vits.flows import flow_reverse
from piper_tpu_torch.models.vits.hifigan import hifigan_generator
from piper_tpu_torch.models.vits.params import Params
from piper_tpu_torch.models.vits.text_encoder import text_encoder
from piper_tpu_torch.ops.masking import generate_path, sequence_mask


@dataclass(frozen=True)
class EncodeResult:
    """Everything the decode phase needs, all phoneme-axis shaped."""

    m_p: torch.Tensor        # (B, C, P) prior mean
    logs_p: torch.Tensor     # (B, C, P) prior log-std
    x_mask: torch.Tensor     # (B, 1, P)
    w_ceil: torch.Tensor     # (B, P) integer-valued frame durations
    y_total: torch.Tensor    # (B,) total frame counts (sum of w_ceil)
    g: Optional[torch.Tensor]  # (B, gin, 1) speaker embedding; None (single speaker)


def _single_speaker(hp: VitsHParams) -> None:
    if hp.n_speakers > 1:
        raise NotImplementedError("multi-speaker voices are not ported yet")


def encode(
    params: Params,
    hp: VitsHParams,
    phoneme_ids: torch.Tensor,
    lengths: torch.Tensor,
    dp_noise: torch.Tensor,
    *,
    length_scale: float = 1.0,
    noise_w: float = 0.8,
) -> EncodeResult:
    """Text encoder + duration predictor: ids (B, P) -> durations + prior."""
    _single_speaker(hp)
    x, m_p, logs_p, x_mask = text_encoder(phoneme_ids, lengths, params, hp)
    logw = stochastic_duration_predictor_reverse(
        x, x_mask, dp_noise.to(x.dtype), params, hp, noise_scale=noise_w)
    w = torch.exp(logw) * x_mask * length_scale
    w_ceil = torch.ceil(w)[:, 0]  # (B, P)
    return EncodeResult(m_p=m_p, logs_p=logs_p, x_mask=x_mask, w_ceil=w_ceil,
                        y_total=w_ceil.sum(dim=-1), g=None)


def _expand_prior(enc_m_p, enc_logs_p, w_ceil, x_mask, max_frames, main_noise, noise_scale):
    y_lengths = torch.clamp(w_ceil.sum(dim=-1), 1, max_frames)
    y_mask = sequence_mask(y_lengths.to(torch.int32), max_frames).to(enc_m_p.dtype)
    path = generate_path(w_ceil, x_mask, y_mask)  # (B, T, P)
    m_p = torch.einsum("btp,bcp->bct", path, enc_m_p)
    logs_p = torch.einsum("btp,bcp->bct", path, enc_logs_p)
    z_p = m_p + main_noise.to(m_p.dtype) * torch.exp(logs_p) * noise_scale
    return y_lengths, y_mask, path, m_p, logs_p, z_p


def decode(
    params: Params,
    hp: VitsHParams,
    enc: EncodeResult,
    main_noise: torch.Tensor,
    *,
    max_frames: int,
    noise_scale: float = 0.667,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Durations + prior -> waveform.

    main_noise: (B, C, max_frames) standard normal. Returns
    (audio (B, max_frames * hop), y_lengths (B,) in frames).
    """
    y_lengths, y_mask, _, _, _, z_p = _expand_prior(
        enc.m_p, enc.logs_p, enc.w_ceil, enc.x_mask, max_frames, main_noise, noise_scale)
    z = flow_reverse(z_p, y_mask, params, hp, g=enc.g)
    # t_mask makes every vocoder conv see zeros beyond y_len, like a decode
    # whose array ends at y_len; the bounds route the narrow levels through
    # the fused kernels with the same per-row masking.
    audio = hifigan_generator(z * y_mask, params, hp, g=enc.g, t_mask=y_mask,
                              t_bounds=y_lengths.to(torch.int32))
    return audio[:, 0, :], y_lengths


def debug_infer(
    params: Params,
    hp: VitsHParams,
    phoneme_ids: torch.Tensor,
    lengths: torch.Tensor,
    dp_noise: torch.Tensor,
    main_noise: torch.Tensor,
    *,
    max_frames: int,
    noise_scale: float = 0.667,
    length_scale: float = 1.0,
    noise_w: float = 0.8,
) -> dict:
    """Full inference returning every module-boundary tensor (the keys of
    piper_tpu.models.vits.model.debug_infer, without its per-layer trace).
    Like the reference, the vocoder gets the mask and no bounds here, so it
    runs the unfused path."""
    _single_speaker(hp)
    x, m_p, logs_p, x_mask = text_encoder(phoneme_ids, lengths, params, hp)
    logw = stochastic_duration_predictor_reverse(x, x_mask, dp_noise, params, hp,
                                                 noise_scale=noise_w)
    w = torch.exp(logw) * x_mask * length_scale
    w_ceil = torch.ceil(w)[:, 0]
    y_lengths, y_mask, path, m_p_exp, logs_p_exp, z_p = _expand_prior(
        m_p, logs_p, w_ceil, x_mask, max_frames, main_noise, noise_scale)
    z = flow_reverse(z_p, y_mask, params, hp)
    audio = hifigan_generator(z * y_mask, params, hp, t_mask=y_mask)
    return {
        "enc_hidden": x,
        "m_p": m_p,
        "logs_p": logs_p,
        "x_mask": x_mask,
        "logw": logw,
        "w_ceil": w_ceil,
        "y_lengths": y_lengths,
        "y_mask": y_mask,
        "path": path,
        "m_p_expanded": m_p_exp,
        "logs_p_expanded": logs_p_exp,
        "z_p": z_p,
        "z": z,
        "audio": audio[:, 0, :],
    }


def infer(
    params: Params,
    hp: VitsHParams,
    phoneme_ids: torch.Tensor,
    lengths: torch.Tensor,
    dp_noise: torch.Tensor,
    main_noise: torch.Tensor,
    *,
    max_frames: int,
    noise_scale: float = 0.667,
    length_scale: float = 1.0,
    noise_w: float = 0.8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthesis in one call: ids -> (audio, y_lengths)."""
    enc = encode(params, hp, phoneme_ids, lengths, dp_noise,
                 length_scale=length_scale, noise_w=noise_w)
    return decode(params, hp, enc, main_noise, max_frames=max_frames,
                  noise_scale=noise_scale)
