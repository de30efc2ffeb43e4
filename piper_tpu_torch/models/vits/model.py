"""Full VITS inference graph (counterpart of piper_tpu.models.vits.model).

`encode` / `decode` are the split entry points: the runtime reads the
frame count on the host between them to pick the frame bucket.
`encode_forced` takes the caller's per-phoneme frame plan in place of the
duration predictor. `infer` runs encode and decode; `debug_infer` returns
every module-boundary tensor, with the same keys as the JAX package's, for
parity checks, and with per_layer=True one tensor per layer under its
parameter path (`utils/debug_trace.py`). A multi-speaker voice takes `sid`:
(B,) speaker ids or (B, n_speakers) mixing weights (`speaker_embedding`).

Every function runs in the weights' dtype (fp32, or bf16 in the runtime's
"bfloat16" mode, as in the JAX package): noise arrives fp32 and is cast to
it, masks and the alignment path take m_p's. The frame durations (w,
w_ceil, y_total) and the path's frame arithmetic stay fp32 in every mode:
bf16 holds integers exactly only up to 256, so a cumulative frame index or
a frame count past that would round (the JAX package's bf16 mode rounds
them; ROADMAP §3).

Streaming decodes frame windows: `decode_window` decodes frames
[t_offset, t_offset + window) of each row, whose prior noise comes from
`per_frame_noise` / `per_row_frame_noise`, a function of (seed, absolute
frame) so that overlapping windows agree.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch

from piper_tpu_torch.models.vits.duration_predictor import stochastic_duration_predictor_reverse
from piper_tpu_torch.models.vits.flows import flow_reverse
from piper_tpu_torch.models.vits.hifigan import hifigan_generator
from piper_tpu_torch.models.vits.hparams import VitsHParams
from piper_tpu_torch.models.vits.params import Params
from piper_tpu_torch.models.vits.text_encoder import text_encoder
from piper_tpu_torch.ops.kernels.precision import tier_scope
from piper_tpu_torch.ops.masking import generate_path, sequence_mask
from piper_tpu_torch.utils.debug_trace import collecting


@dataclass(frozen=True)
class EncodeResult:
    """Everything the decode phase needs, all phoneme-axis shaped."""

    m_p: torch.Tensor        # (B, C, P) prior mean
    logs_p: torch.Tensor     # (B, C, P) prior log-std
    x_mask: torch.Tensor     # (B, 1, P)
    w: torch.Tensor          # (B, P) frame durations before their ceil, fp32
    w_ceil: torch.Tensor     # (B, P) integer-valued frame durations, fp32
    y_total: torch.Tensor    # (B,) total frame counts (sum of w_ceil), fp32
    g: Optional[torch.Tensor]  # (B, gin, 1) speaker embedding; None (single speaker)


def speaker_embedding(params: Params, hp: VitsHParams,
                      sid: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The speaker conditioning vector (B, gin, 1), or None for a
    single-speaker voice. `sid` is (B,) integer ids (a row lookup of
    emb_g) or (B, n_speakers) float mixing weights: g = weights @ emb_g in
    true fp32 (TF32 off on the card whatever the caller's tier), so a
    one-hot row equals the id lookup bit for bit (it adds exact zeros).
    Weights need not sum to 1. The caller validates ids: an out-of-range
    index on the card is a device-side assert."""
    if hp.n_speakers <= 1 or "emb_g.weight" not in params:
        return None
    if sid is None:
        raise ValueError("multi-speaker model requires a speaker id")
    emb = params["emb_g.weight"]
    if sid.ndim == 2:
        with tier_scope("highest", emb.device):
            g = torch.matmul(sid.to(torch.float32), emb.float()).to(emb.dtype)
        return g[..., None]
    return emb[sid.long()][..., None]


def encode(
    params: Params,
    hp: VitsHParams,
    phoneme_ids: torch.Tensor,
    lengths: torch.Tensor,
    dp_noise: torch.Tensor,
    *,
    length_scale: float = 1.0,
    noise_w: float = 0.8,
    sid: Optional[torch.Tensor] = None,
) -> EncodeResult:
    """Text encoder + duration predictor: ids (B, P) -> durations + prior."""
    x, m_p, logs_p, x_mask = text_encoder(phoneme_ids, lengths, params, hp)
    g = speaker_embedding(params, hp, sid)
    logw = stochastic_duration_predictor_reverse(
        x, x_mask, dp_noise.to(x.dtype), params, hp, g=g, noise_scale=noise_w)
    w = _durations(logw, x_mask, length_scale)
    w_ceil = torch.ceil(w)
    return EncodeResult(m_p=m_p, logs_p=logs_p, x_mask=x_mask, w=w, w_ceil=w_ceil,
                        y_total=w_ceil.sum(dim=-1), g=g)


def encode_forced(
    params: Params,
    hp: VitsHParams,
    phoneme_ids: torch.Tensor,
    lengths: torch.Tensor,
    durations: torch.Tensor,
    *,
    sid: Optional[torch.Tensor] = None,
) -> EncodeResult:
    """Text encoder with the caller's per-phoneme frame durations (B, P):
    the duration predictor is skipped and `durations`, masked to each row's
    length, is the plan the decoder expands, as a predicted w_ceil is."""
    x, m_p, logs_p, x_mask = text_encoder(phoneme_ids, lengths, params, hp)
    g = speaker_embedding(params, hp, sid)
    w_ceil = durations.to(torch.float32) * x_mask[:, 0].float()
    return EncodeResult(m_p=m_p, logs_p=logs_p, x_mask=x_mask, w=w_ceil, w_ceil=w_ceil,
                        y_total=w_ceil.sum(dim=-1), g=g)


def _durations(logw, x_mask, length_scale) -> torch.Tensor:
    """(B, P) fp32 frame durations before their ceil: exp(logw) * x_mask *
    length_scale (`length_scale` a float or a (B, 1, 1) tensor)."""
    return (torch.exp(logw.float()) * x_mask.float() * length_scale)[:, 0]


def _prior(path, enc_m_p, enc_logs_p, noise, noise_scale):
    """The prior expanded along `path` (B, T, P) and its sample z_p."""
    m_p = torch.einsum("btp,bcp->bct", path, enc_m_p)
    logs_p = torch.einsum("btp,bcp->bct", path, enc_logs_p)
    z_p = m_p + noise.to(m_p.dtype) * torch.exp(logs_p) * noise_scale
    return m_p, logs_p, z_p


def _expand_prior(enc_m_p, enc_logs_p, w_ceil, x_mask, max_frames, main_noise, noise_scale):
    y_lengths = torch.clamp(w_ceil.float().sum(dim=-1), 1, max_frames)
    y_mask = sequence_mask(y_lengths.to(torch.int32), max_frames).to(enc_m_p.dtype)
    path = generate_path(w_ceil, x_mask, y_mask)  # (B, T, P)
    return (y_lengths, y_mask, path) + _prior(path, enc_m_p, enc_logs_p, main_noise,
                                              noise_scale)


def decode(
    params: Params,
    hp: VitsHParams,
    enc: EncodeResult,
    main_noise: torch.Tensor,
    *,
    max_frames: int,
    noise_scale: float = 0.667,
    vocoder_precision: Union[str, Sequence[Optional[str]], None] = None,
    flow_precision: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Durations + prior -> waveform.

    main_noise: (B, C, max_frames) standard normal. `vocoder_precision`
    (one tier, or one per upsample level) and `flow_precision` set the tiers
    of HiFi-GAN and of the reverse flows; None inherits the caller's.
    Returns (audio (B, max_frames * hop), y_lengths (B,) in frames).
    """
    y_lengths, y_mask, _, _, _, z_p = _expand_prior(
        enc.m_p, enc.logs_p, enc.w_ceil, enc.x_mask, max_frames, main_noise, noise_scale)
    with tier_scope(flow_precision, z_p.device):
        z = flow_reverse(z_p, y_mask, params, hp, g=enc.g)
    # t_mask makes every vocoder conv see zeros beyond y_len, like a decode
    # whose array ends at y_len; the bounds route the narrow levels through
    # the fused kernels with the same per-row masking.
    audio = hifigan_generator(z * y_mask, params, hp, g=enc.g,
                              level_precisions=vocoder_precision, t_mask=y_mask,
                              t_bounds=y_lengths.to(torch.int32))
    return audio[:, 0, :], y_lengths


_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # 2^32 / golden ratio: spreads the lane counter over the word


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (two multiply-xorshift rounds, multiplier
    0x45D9F3B) on int64 tensors holding values in [0, 2^32): every product
    stays below 2^59, so the bits are the same on every device."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def _counter_normals(seeds: torch.Tensor, t_idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B,) int64 seeds, (B, W) int64 absolute frames -> (B, n, W) standard
    normals, value q of frame t a pure function of (seed, t, q)."""
    key = _hash32((_hash32(seeds & _M32)[:, None] + t_idx) & _M32)  # (B, W)
    lane = torch.arange(2 * n, device=t_idx.device, dtype=torch.int64) * _GOLDEN
    bits = _hash32((key[:, None, :] + lane[None, :, None]) & _M32)  # (B, 2n, W)
    bits = bits.view(bits.shape[0], n, 2, bits.shape[-1])
    # 24-bit uniforms (exact in fp32): u1 in (0, 1], u2 in [0, 1).
    u1 = ((bits[:, :, 0] >> 8) + 1).to(torch.float32) * 2.0 ** -24
    u2 = (bits[:, :, 1] >> 8).to(torch.float32) * 2.0 ** -24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def per_frame_noise(seed, t_idx: torch.Tensor, b: int, ch: int) -> torch.Tensor:
    """Prior noise derived per ABSOLUTE frame index -> (b, ch, len(t_idx)).

    Counterpart of the JAX package's per_frame_noise, which folds each frame
    into a threefry key: threefry cannot be reproduced without JAX, so the
    values differ from it (parity checks inject the noise). Here a frame's
    values are a counter-based hash of (seed, frame, lane) turned into
    normals by Box-Muller, in one vectorized pass of int64 ops:

        key  = h(h(seed) + t)                  per frame t
        bits = h(key + lane * 0x9E3779B9)      lane = 2 * q + j, j in {0, 1}
        u1 = ((bits_0 >> 8) + 1) / 2^24, u2 = (bits_1 >> 8) / 2^24
        z[q] = sqrt(-2 ln u1) * cos(2 pi u2)

    with h = _hash32, sums taken mod 2^32 and value q = r * ch + c for row r,
    channel c. The integer part is bit-equal on every device; the normals
    differ between the CPU and the card only by the rounding of log, sqrt
    and cos. Overlapping windows see the same values at the same frames,
    and row r equals per_row_frame_noise at that row's (seed, frames) only
    for r = 0 (the rows of one stream's draw differ from each other, as in
    JAX). `seed` is an int or a 0-d tensor; t_idx (W,) integer, any sign."""
    t = t_idx.to(torch.int64).reshape(1, -1)
    z = _counter_normals(_rows(seed, 1, t.device, torch.int64), t, b * ch)  # (1, b*ch, W)
    return z.view(b, ch, -1)


def per_row_frame_noise(seeds, t_idx: torch.Tensor, ch: int) -> torch.Tensor:
    """Per-row per-frame prior noise -> (B, C, W): seeds (B,) (a tensor,
    or ints), t_idx (B, W) absolute frames. Row r equals
    per_frame_noise(seeds[r], t_idx[r], 1, ch) bit for bit, so a stream
    batched with others sees exactly the noise it sees decoding alone."""
    t = t_idx.to(torch.int64)
    if not isinstance(seeds, torch.Tensor):
        seeds = torch.tensor([int(s) & _M32 for s in seeds], dtype=torch.int64)
    return _counter_normals(_rows(seeds, t.shape[0], t.device, torch.int64), t, ch)


def _rows(v, b: int, device, dtype) -> torch.Tensor:
    """A scalar or (B,) value (int, float or tensor) as (b,) on `device`; a
    Python number is filled there, with no copy from the host."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype).reshape(-1).expand(b)
    return torch.full((b,), v, dtype=dtype, device=device)


def decode_window(
    params: Params,
    hp: VitsHParams,
    enc: EncodeResult,
    main_noise_win: torch.Tensor,
    t_offset,
    *,
    window: int,
    total_frames,
    noise_scale=0.667,
    vocoder_precision: Union[str, Sequence[Optional[str]], None] = None,
    flow_precision: Optional[str] = None,
) -> torch.Tensor:
    """Decode only frames [t_offset, t_offset + window): streaming.

    `t_offset` and `total_frames` are scalars for a single stream, or (B,)
    to decode one window PER ROW at independent positions (the batched
    multi-stream case). Pass them as tensors on enc's device (or Python
    ints, filled there): nothing here reads the device from the host.
    `noise_scale` is a float or a tensor broadcasting against (B, C, W).

    `total_frames` is the virtual full-sequence length (the array edge):
    frames outside [0, total_frames) are masked through every conv, so a
    window edge reproduces the full run's zero padding exactly. With a halo
    of `receptive_field_frames(hp)` on each side, the central region of the
    returned audio equals the same slice of a full decode.

    main_noise_win: (B, C, window), the prior noise of these absolute
    frames (the same across overlapping windows). Returns (B, window * hop).
    """
    b = enc.m_p.shape[0]
    dev = enc.m_p.device
    t_off = _rows(t_offset, b, dev, torch.int64)
    total = _rows(total_frames, b, dev, torch.int64)
    t_idx = t_off[:, None] + torch.arange(window, device=dev)[None, :]  # (B, W) absolute
    y_lengths = torch.minimum(torch.clamp(enc.w_ceil.sum(dim=-1), min=1),
                              total.to(enc.w_ceil.dtype))
    # Validity inside the sequence (for the prior and the flows)...
    inside = t_idx >= 0
    y_mask = ((t_idx < y_lengths[:, None]) & inside)[:, None, :].to(enc.m_p.dtype)
    # ...and inside the virtual array (for the convs' zero padding).
    arr_mask = (inside & (t_idx < total[:, None]))[:, None, :].to(enc.m_p.dtype)
    path = generate_path(enc.w_ceil, enc.x_mask, y_mask, t_idx=t_idx)  # (B, W, P)
    _, _, z_p = _prior(path, enc.m_p, enc.logs_p, main_noise_win, noise_scale)
    with tier_scope(flow_precision, dev):
        z = flow_reverse(z_p * arr_mask, y_mask * arr_mask, params, hp, g=enc.g)
    # The valid region in window coordinates is the interval [lo, hi): lo is
    # the left halo clipped at the sequence start, hi min(y_len, total)
    # relative to the window. As per-row bounds the vocoder's kernels apply
    # it themselves; the mask is the same interval for the other convs.
    lo = torch.clamp(-t_off, 0, window)
    hi = torch.clamp(y_lengths.to(torch.int64) - t_off, 0, window)
    audio = hifigan_generator(z * y_mask, params, hp, g=enc.g,
                              level_precisions=vocoder_precision, t_mask=y_mask * arr_mask,
                              t_bounds=torch.stack([lo, hi], dim=1).to(torch.int32))
    return audio[:, 0, :]


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
    sid: Optional[torch.Tensor] = None,
    per_layer: bool = False,
) -> dict:
    """Full inference returning every module-boundary tensor, with the keys
    of piper_tpu.models.vits.model.debug_infer. Like the reference, the
    vocoder gets the mask and no bounds here, so it runs the unfused path.

    With per_layer=True the dict first carries one entry per conv, flow
    step and attention layer, keyed by the checkpoint parameter path that
    produced it (e.g. "flow.flows.2.enc.in_layers.1"), in the order they
    ran: the JAX package's keys in its order, for bisecting a divergence to
    one layer. The collector is detached when the body raises."""
    layer_trace: dict = {}
    with collecting(layer_trace) if per_layer else contextlib.nullcontext():
        x, m_p, logs_p, x_mask = text_encoder(phoneme_ids, lengths, params, hp)
        g = speaker_embedding(params, hp, sid)
        logw = stochastic_duration_predictor_reverse(x, x_mask, dp_noise.to(x.dtype), params,
                                                     hp, g=g, noise_scale=noise_w)
        w_ceil = torch.ceil(_durations(logw, x_mask, length_scale))
        y_lengths, y_mask, path, m_p_exp, logs_p_exp, z_p = _expand_prior(
            m_p, logs_p, w_ceil, x_mask, max_frames, main_noise, noise_scale)
        z = flow_reverse(z_p, y_mask, params, hp, g=g)
        audio = hifigan_generator(z * y_mask, params, hp, g=g, t_mask=y_mask)
    return {
        **layer_trace,
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
    sid: Optional[torch.Tensor] = None,
    vocoder_precision: Union[str, Sequence[Optional[str]], None] = None,
    flow_precision: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthesis in one call: ids -> (audio, y_lengths)."""
    enc = encode(params, hp, phoneme_ids, lengths, dp_noise,
                 length_scale=length_scale, noise_w=noise_w, sid=sid)
    return decode(params, hp, enc, main_noise, max_frames=max_frames,
                  noise_scale=noise_scale, vocoder_precision=vocoder_precision,
                  flow_precision=flow_precision)
