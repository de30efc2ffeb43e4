"""Sequence-mask helpers (counterpart of piper_tpu.ops.masking)."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, 1, max_length) float mask of 1.0 for valid steps."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    mask = pos[None, :] < lengths[:, None]
    return mask[:, None, :].to(torch.float32)


def generate_path(w_ceil: torch.Tensor, x_mask: torch.Tensor, y_mask: torch.Tensor) -> torch.Tensor:
    """Monotonic duration -> alignment path.

    w_ceil: (B, P) integer-valued durations (float dtype), already masked;
    x_mask: (B, 1, P); y_mask: (B, 1, T). Returns (B, T, P) with
    path[b, t, p] = 1 iff cum[p-1] <= t < cum[p].
    """
    cum = torch.cumsum(w_ceil, dim=-1)  # (B, P)
    t_idx = torch.arange(y_mask.shape[-1], device=w_ceil.device, dtype=w_ceil.dtype)
    below = t_idx[None, :, None] < cum[:, None, :]
    cum_prev = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=-1)
    below_prev = t_idx[None, :, None] < cum_prev[:, None, :]
    path = (below & ~below_prev).to(w_ceil.dtype)
    return path * y_mask.transpose(1, 2) * x_mask
