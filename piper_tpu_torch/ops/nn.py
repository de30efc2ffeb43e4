"""Small neural-net ops (counterpart of piper_tpu.ops.nn)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm_channels(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the channel axis of a (B, C, T) tensor (VITS-style)."""
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).square().mean(dim=1, keepdim=True)
    normed = (x - mean) * torch.rsqrt(var + eps)
    return normed * gamma[None, :, None] + beta[None, :, None]


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based GELU (torch's default; the tanh approximation is not VITS)."""
    return F.gelu(x, approximate="none")


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def fused_add_tanh_sigmoid_multiply(
    a: torch.Tensor, b: torch.Tensor, channels: int
) -> torch.Tensor:
    """WaveNet gate: tanh(x[:C]) * sigmoid(x[C:]) of (a + b)."""
    s = a + b
    return torch.tanh(s[:, :channels]) * torch.sigmoid(s[:, channels:])
