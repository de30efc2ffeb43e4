"""HiFi-GAN generator (the `dec.*` weights): latent frames -> waveform.

Counterpart of piper_tpu.models.vits.hifigan with its routing: a ResBlock1
level narrower than 128 channels, given per-row bounds (or no mask at all),
goes through the fused resblock kernels — the whole-MRF kernel when it has
at most 32 channels, one branch kernel per branch otherwise. Wider levels,
the upsampling and the pre/post convs are PyTorch convs. On a CPU tensor the
kernel wrappers run their plain versions, so the CPU path is the unfused
reference with the kernels' mask semantics.
"""

from __future__ import annotations

from typing import Optional

import torch

from piper_tpu.models.vits.hparams import VitsHParams
from piper_tpu_torch.models.vits.params import Params, Prefix
from piper_tpu_torch.ops.conv import conv1d, conv_transpose1d
from piper_tpu_torch.ops.kernels.resblock import (
    resblock1_branch,
    resblock1_chain_plain,
    resblock1_mrf,
)
from piper_tpu_torch.ops.nn import leaky_relu

LRELU_SLOPE = 0.1


def _branch_weights(rb: Prefix, n_d: int):
    """(w1s, b1s, w2s, b2s) of one ResBlock1 branch, each a list over dilations."""
    return tuple([rb[f"{conv}.{m}.{kind}"] for m in range(n_d)]
                 for conv, kind in (("convs1", "weight"), ("convs1", "bias"),
                                    ("convs2", "weight"), ("convs2", "bias")))


def _stacked(rb: Prefix, n_d: int):
    """The same, each stacked into one (M, ...) tensor, as the kernels take them."""
    return tuple(torch.stack(ws) for ws in _branch_weights(rb, n_d))


def hifigan_generator(
    z: torch.Tensor,
    params: Params,
    hp: VitsHParams,
    g: Optional[torch.Tensor] = None,
    prefix: str = "dec",
    t_mask: Optional[torch.Tensor] = None,
    t_bounds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, C, T_frames) latent -> (B, 1, T_frames * hop_length) waveform.

    `t_mask` (B, 1, T_frames) zeroes activations outside the sequence before
    every conv, so the bucket padding behaves like the array's end.
    `t_bounds` gives each row's valid FRAME interval, (B,) [0, hi) or (B, 2)
    [lo, hi); with it the narrow ResBlock1 levels run the fused kernels,
    which apply the same masking per row.
    """
    def masked(x, m):
        return x if m is None else x * m

    if f"{prefix}.resblocks.0.convs.0.weight" in params:
        raise NotImplementedError(
            "ResBlock2 voices need the port of pallas_conv1d_same "
            "(piper_tpu/ops/pallas/conv.py), which is not ported yet")

    m = t_mask
    p = Prefix(params, prefix)
    x = conv1d(masked(z, m), p["conv_pre.weight"], p["conv_pre.bias"], padding=3)
    if g is not None:
        x = x + conv1d(g, p["cond.weight"], p["cond.bias"])

    num_kernels = hp.num_resblock_kernels
    bounds = None
    if t_bounds is not None:
        bounds = t_bounds.to(torch.int32)
        if bounds.ndim == 1:
            bounds = torch.stack([torch.zeros_like(bounds), bounds], dim=1)
    for i in range(hp.num_upsamples):
        x = leaky_relu(masked(x, m), LRELU_SLOPE)
        k, u = hp.upsample_kernel_sizes[i], hp.upsample_rates[i]
        x = conv_transpose1d(masked(x, m), p[f"ups.{i}.weight"], p[f"ups.{i}.bias"],
                             stride=u, padding=(k - u) // 2)
        if m is not None:
            m = torch.repeat_interleave(m, u, dim=2)
            x = x * m
        if bounds is not None:
            bounds = bounds * u
        ch_here = x.shape[1]
        fused = ch_here < 128 and (m is None or bounds is not None)
        rbs = [p.sub(f"resblocks.{i * num_kernels + j}") for j in range(num_kernels)]
        if fused and ch_here <= 32:
            branches = [
                (*_stacked(rb, len(hp.resblock_dilation_sizes[j])),
                 hp.resblock_kernel_sizes[j], hp.resblock_dilation_sizes[j])
                for j, rb in enumerate(rbs)
            ]
            x = resblock1_mrf(x, branches, bounds=bounds, slope=LRELU_SLOPE)
            continue
        acc = None
        for j, rb in enumerate(rbs):
            kernel = hp.resblock_kernel_sizes[j]
            dils = hp.resblock_dilation_sizes[j]
            if fused:
                y = resblock1_branch(x, *_stacked(rb, len(dils)), kernel=kernel,
                                     dilations=dils, bounds=bounds, slope=LRELU_SLOPE)
            else:
                y = resblock1_chain_plain(x, *_branch_weights(rb, len(dils)), kernel, dils,
                                          mask=m, slope=LRELU_SLOPE)
            acc = y if acc is None else acc + y
        x = acc / num_kernels

    x = leaky_relu(masked(x, m))  # final activation: torch default slope 0.01
    x = conv1d(masked(x, m), p["conv_post.weight"], p["conv_post.bias"], padding=3)
    out = torch.tanh(x)
    return out if m is None else out * m
