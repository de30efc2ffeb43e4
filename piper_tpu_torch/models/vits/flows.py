"""Residual-coupling flow decoder (z_p -> z) and the shared WaveNet stack.

Counterpart of piper_tpu.models.vits.flows. Weight-norm is already fused in
exported checkpoints, so parameters are plain conv weights.
"""

from __future__ import annotations

from typing import Optional

import torch

from piper_tpu.models.vits.hparams import VitsHParams
from piper_tpu_torch.models.vits.params import Params, Prefix
from piper_tpu_torch.ops.conv import conv1d, conv1d_same
from piper_tpu_torch.ops.nn import fused_add_tanh_sigmoid_multiply


def wavenet(
    x: torch.Tensor,
    x_mask: torch.Tensor,
    p: Prefix,
    *,
    hidden_channels: int,
    n_layers: int,
    dilation_rate: int,
    g: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Non-causal WaveNet (VITS `WN`) on (B, H, T)."""
    output = torch.zeros_like(x)
    g_all = None
    if g is not None:
        g_all = conv1d(g, p["cond_layer.weight"], p["cond_layer.bias"])
    for i in range(n_layers):
        x_in = conv1d_same(
            x, p[f"in_layers.{i}.weight"], p[f"in_layers.{i}.bias"],
            dilation=dilation_rate**i,
        )
        if g_all is not None:
            g_l = g_all[:, i * 2 * hidden_channels : (i + 1) * 2 * hidden_channels]
        else:
            g_l = torch.zeros_like(x_in)
        acts = fused_add_tanh_sigmoid_multiply(x_in, g_l, hidden_channels)
        res_skip = conv1d(
            acts, p[f"res_skip_layers.{i}.weight"], p[f"res_skip_layers.{i}.bias"]
        )
        if i < n_layers - 1:
            x = (x + res_skip[:, :hidden_channels]) * x_mask
            output = output + res_skip[:, hidden_channels:]
        else:
            output = output + res_skip
    return output * x_mask


def _residual_coupling_reverse(
    x: torch.Tensor,
    x_mask: torch.Tensor,
    p: Prefix,
    hp: VitsHParams,
    g: Optional[torch.Tensor],
) -> torch.Tensor:
    """Inverse of a mean-only residual coupling layer on (B, C, T)."""
    half = x.shape[1] // 2
    x0, x1 = x[:, :half], x[:, half:]
    h = conv1d(x0, p["pre.weight"], p["pre.bias"]) * x_mask
    h = wavenet(
        h, x_mask, p.sub("enc"),
        hidden_channels=hp.flow_hidden_channels,
        n_layers=hp.flow_n_layers,
        dilation_rate=hp.flow_dilation_rate,
        g=g,
    )
    m = conv1d(h, p["post.weight"], p["post.bias"]) * x_mask  # mean_only
    x1 = (x1 - m) * x_mask
    return torch.cat([x0, x1], dim=1)


def flow_reverse(
    z_p: torch.Tensor,
    y_mask: torch.Tensor,
    params: Params,
    hp: VitsHParams,
    g: Optional[torch.Tensor] = None,
    prefix: str = "flow",
) -> torch.Tensor:
    """Run the residual-coupling block in reverse: prior sample -> latent z.

    Forward order is [RCL@0, Flip, RCL@1, Flip, ...]; reverse visits flips
    and couplings in the opposite order (RCL at the even ModuleList indices).
    """
    p = Prefix(params, prefix)
    z = z_p
    for i in reversed(range(hp.flow_n_flows)):
        z = torch.flip(z, dims=[1])  # inverse of the Flip that follows RCL@2i
        z = _residual_coupling_reverse(z, y_mask, p.sub(f"flows.{2 * i}"), hp, g)
    return z
