"""Stochastic duration predictor, reverse (inference) path.

Counterpart of piper_tpu.models.vits.duration_predictor: masked convs plus
spline flows.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from piper_tpu.models.vits.hparams import VitsHParams
from piper_tpu_torch.models.vits.params import Params, Prefix
from piper_tpu_torch.ops.conv import conv1d, conv1d_same
from piper_tpu_torch.ops.nn import gelu_exact, layer_norm_channels
from piper_tpu_torch.ops.spline import rational_quadratic_spline_inverse


def _dds_conv(
    x: torch.Tensor,
    x_mask: torch.Tensor,
    p: Prefix,
    n_layers: int,
    kernel_size: int,
    g: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dilated depth-separable conv stack (VITS DDSConv) with residuals."""
    if g is not None:
        x = x + g
    channels = x.shape[1]
    for i in range(n_layers):
        y = conv1d_same(
            x * x_mask, p[f"convs_sep.{i}.weight"], p[f"convs_sep.{i}.bias"],
            dilation=kernel_size**i, groups=channels,
        )
        n1 = p.sub(f"norms_1.{i}")
        y = gelu_exact(layer_norm_channels(y, n1["gamma"], n1["beta"]))
        y = conv1d(y, p[f"convs_1x1.{i}.weight"], p[f"convs_1x1.{i}.bias"])
        n2 = p.sub(f"norms_2.{i}")
        y = gelu_exact(layer_norm_channels(y, n2["gamma"], n2["beta"]))
        x = x + y
    return x * x_mask


def _elementwise_affine_reverse(
    x: torch.Tensor, x_mask: torch.Tensor, p: Prefix
) -> torch.Tensor:
    return (x - p["m"][None]) * torch.exp(-p["logs"][None]) * x_mask


def _conv_flow_reverse(
    x: torch.Tensor,
    x_mask: torch.Tensor,
    p: Prefix,
    hp: VitsHParams,
    g: Optional[torch.Tensor],
) -> torch.Tensor:
    """Inverse of the spline coupling flow on (B, 2, P)."""
    half = x.shape[1] // 2  # == 1
    x0, x1 = x[:, :half], x[:, half:]
    h = conv1d(x0, p["pre.weight"], p["pre.bias"])
    h = _dds_conv(h, x_mask, p.sub("convs"), n_layers=3, kernel_size=hp.dp_kernel_size, g=g)
    h = conv1d(h, p["proj.weight"], p["proj.bias"]) * x_mask

    b, _, t = x0.shape
    nb = hp.dp_num_bins
    h = h.reshape(b, half, 3 * nb - 1, t).permute(0, 1, 3, 2)  # (B, half, P, 3nb-1)
    denom = math.sqrt(hp.dp_filter_channels)
    x1_new = rational_quadratic_spline_inverse(
        x1, h[..., :nb] / denom, h[..., nb : 2 * nb] / denom, h[..., 2 * nb :],
        tail_bound=hp.dp_tail_bound,
    )
    return torch.cat([x0, x1_new], dim=1) * x_mask


def stochastic_duration_predictor_reverse(
    x: torch.Tensor,
    x_mask: torch.Tensor,
    noise: torch.Tensor,
    params: Params,
    hp: VitsHParams,
    g: Optional[torch.Tensor] = None,
    noise_scale: float = 0.8,
    prefix: str = "dp",
) -> torch.Tensor:
    """Sample log-durations.

    x: (B, H, P) text-encoder output; noise: (B, 2, P) standard normal.
    Returns logw: (B, 1, P).
    """
    p = Prefix(params, prefix)
    h = conv1d(x, p["pre.weight"], p["pre.bias"])
    if g is not None:
        h = h + conv1d(g, p["cond.weight"], p["cond.bias"])
    h = _dds_conv(h, x_mask, p.sub("convs"), n_layers=3, kernel_size=hp.dp_kernel_size)
    h = conv1d(h, p["proj.weight"], p["proj.bias"]) * x_mask

    z = noise * noise_scale
    # VITS drops the first ConvFlow in reverse: with flows [EA, CF@1, Flip,
    # CF@3, Flip, ...], the reverse pass visits Flip, CF@(2n-1), ...,
    # Flip, CF@3, Flip, then EA, skipping CF@1.
    conv_flow_indices = [2 * i + 1 for i in range(hp.dp_n_flows)]  # [1,3,5,7]
    for idx in reversed(conv_flow_indices[1:]):  # 7, 5, 3
        z = torch.flip(z, dims=[1])
        z = _conv_flow_reverse(z, x_mask, p.sub(f"flows.{idx}"), hp, g=h)
    z = torch.flip(z, dims=[1])
    z = _elementwise_affine_reverse(z, x_mask, p.sub("flows.0"))
    return z[:, :1]
