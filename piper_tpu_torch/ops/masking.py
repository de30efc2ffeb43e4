"""Sequence-mask helpers (counterpart of piper_tpu.ops.masking)."""

from __future__ import annotations

from typing import Optional

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, 1, max_length) float mask of 1.0 for valid steps."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    mask = pos[None, :] < lengths[:, None]
    return mask[:, None, :].to(torch.float32)


def generate_path(w_ceil: torch.Tensor, x_mask: torch.Tensor, y_mask: torch.Tensor,
                  t_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Monotonic duration -> alignment path.

    w_ceil: (B, P) integer-valued durations (float dtype), already masked;
    x_mask: (B, 1, P); y_mask: (B, 1, T). Returns (B, T, P) in y_mask's
    dtype with path[b, t, p] = 1 iff cum[p-1] <= t_idx[b, t] < cum[p],
    where t_idx, the absolute frame of each column, is 0..T-1 by default or
    (B, T) for a window of frames (streaming's decode_window). The
    comparisons run in fp32 whatever the dtype: bf16 frame indices would
    round past 256.
    """
    cum = torch.cumsum(w_ceil.float(), dim=-1)  # (B, P)
    if t_idx is None:
        t_idx = torch.arange(y_mask.shape[-1], device=w_ceil.device)[None, :]
    t_idx = t_idx.to(torch.float32)
    below = t_idx[:, :, None] < cum[:, None, :]
    cum_prev = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=-1)
    below_prev = t_idx[:, :, None] < cum_prev[:, None, :]
    path = (below & ~below_prev).to(y_mask.dtype)
    return path * y_mask.transpose(1, 2) * x_mask
