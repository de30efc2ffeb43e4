"""Relative-position windowed multi-head attention (VITS text encoder).

Counterpart of piper_tpu.ops.attention: the same pad/reshape formulation of
the relative logits, on (B, C, T) tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def get_relative_embeddings(emb: torch.Tensor, length: int, window_size: int) -> torch.Tensor:
    """(heads_or_1, 2*window+1, D) -> (heads_or_1, 2*length-1, D)."""
    pad_length = max(length - (window_size + 1), 0)
    start = max((window_size + 1) - length, 0)
    if pad_length > 0:
        emb = F.pad(emb, (0, 0, pad_length, pad_length))
    return emb[:, start : start + 2 * length - 1]


def relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, 2L-1) relative-position logits -> (B, H, L, L) absolute."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1)).reshape(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1 :]


def absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, L) attention weights -> (B, H, L, 2L-1) relative layout."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).reshape(b, h, l * (2 * l - 1))
    x = F.pad(x, (l, 0)).reshape(b, h, l, 2 * l)
    return x[:, :, :, 1:]


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    n_heads: int,
    attn_mask: Optional[torch.Tensor] = None,
    emb_rel_k: Optional[torch.Tensor] = None,
    emb_rel_v: Optional[torch.Tensor] = None,
    window_size: Optional[int] = None,
) -> torch.Tensor:
    """Self-attention core on projected (B, C, T) q/k/v with optional
    relative bias; attn_mask (B, 1, T, T) is 0 at disallowed positions
    (masked to -1e4, matching VITS)."""
    b, c, t = q.shape
    k_channels = c // n_heads

    def split_heads(x):
        return x.reshape(b, n_heads, k_channels, t).transpose(2, 3)  # (B,H,T,D)

    qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
    qs = qh * (1.0 / math.sqrt(k_channels))
    scores = torch.matmul(qs, kh.transpose(2, 3))

    if window_size is not None and emb_rel_k is not None:
        rel_k = get_relative_embeddings(emb_rel_k, t, window_size)  # (1orH, 2T-1, D)
        rel_logits = torch.matmul(qs, rel_k.unsqueeze(0).transpose(2, 3))
        scores = scores + relative_to_absolute(rel_logits)

    if attn_mask is not None:
        scores = scores.masked_fill(attn_mask == 0, -1e4)
    weights = torch.softmax(scores, dim=-1)
    out = torch.matmul(weights, vh)

    if window_size is not None and emb_rel_v is not None:
        rel_v = get_relative_embeddings(emb_rel_v, t, window_size)
        out = out + torch.matmul(absolute_to_relative(weights), rel_v.unsqueeze(0))

    return out.transpose(2, 3).reshape(b, c, t)
