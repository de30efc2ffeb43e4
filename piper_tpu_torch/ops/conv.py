"""1-D convolutions in VITS's native (B, C, T) layout.

Counterpart of piper_tpu.ops.conv. These convs ran in XLA outside any Pallas
kernel, so here they are PyTorch's own, at the precision of the caller's
tier_scope: fp32 at "highest" and "high", TF32 at "default". The
production `conv_transpose1d` is PyTorch's (cuDNN's on the card).
`conv_transpose1d_polyphase` is the JAX package's lowering of it (one
dense conv to stride*C_out channels, then an interleave through K5), kept
for `piper_tpu_torch.tools.ct_probe`, which times the two against each
other. The packed narrow conv, which exists to fill the TPU's matrix unit,
is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from piper_tpu_torch.ops.kernels.interleave import interleave


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """x: (B, C_in, T); weight: (C_out, C_in/groups, K); bias: (C_out,)."""
    return F.conv1d(x, weight, bias, stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def conv_transpose1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: int = 0,
    output_padding: int = 0,
) -> torch.Tensor:
    """x: (B, C_in, T); weight: (C_in, C_out, K), the transposed-conv layout."""
    return F.conv_transpose1d(x, weight, bias, stride=stride, padding=padding,
                              output_padding=output_padding)


def polyphase_weight(weight: torch.Tensor, stride: int) -> Tuple[torch.Tensor, int]:
    """The phase kernels of a transposed-conv weight (C_in, C_out, K): taps
    padded with zeros to a multiple of the stride, then
    wp[r*C_out + o, i, j] = weight[i, o, r + (kr-1-j)*stride], reversed in j
    so that a correlation computes sum_j x[q-j] * w_phase[j]. Returns
    (wp (stride*C_out, C_in, kr), kr)."""
    c_in, c_out, k = weight.shape
    k_pad = -(-k // stride) * stride
    if k_pad != k:
        weight = F.pad(weight, (0, k_pad - k))
    kr = k_pad // stride
    wp = weight.reshape(c_in, c_out, kr, stride).flip(2)  # [i, o, j, r]
    return wp.permute(3, 1, 0, 2).reshape(stride * c_out, c_in, kr), kr


def conv_transpose1d_polyphase(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: int = 0,
    output_padding: int = 0,
) -> torch.Tensor:
    """conv_transpose1d by the polyphase lowering of piper_tpu.ops.conv
    (lines 55-129). Output phase r (= (n + padding) mod stride) is a dense
    conv of x with the taps w[..., r::stride], so one conv to stride*C_out
    channels and an interleave of its output compute the transposed conv at
    1/stride of the input-dilated conv's products. The interleave is K5
    (`ops/kernels/interleave.py`): on a CUDA tensor it launches the kernel.

    x: (B, C_in, T); weight: (C_in, C_out, K), the transposed-conv layout."""
    if stride == 1:
        k = weight.shape[-1]
        w = weight.flip(-1).transpose(0, 1)  # (C_out, C_in, K)
        lo = k - 1 - padding
        out = F.conv1d(F.pad(x, (lo, lo + output_padding)), w)
        return out if bias is None else out + bias[None, :, None]

    if output_padding >= stride:
        raise ValueError("output_padding must be < stride")
    b, _, t = x.shape
    c_out, k = weight.shape[1], weight.shape[2]
    t_out = (t - 1) * stride + k - 2 * padding + output_padding
    wp, kr = polyphase_weight(weight, stride)
    y = F.conv1d(x, wp, padding=kr - 1)  # 'full': (B, stride*C_out, Q), Q = T + kr - 1
    q = y.shape[-1]
    # Sample n (before the crop) lives at phase n % stride, position n // stride.
    y = interleave(y.reshape(b, stride, c_out, q))
    short = padding + t_out - y.shape[-1]
    if short > 0:
        # the output_padding region beyond the last kernel tap: zeros (+ bias)
        y = F.pad(y, (0, short))
    out = y[:, :, padding:padding + t_out]
    return out if bias is None else out + bias[None, :, None]


def conv1d_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Same-padded conv1d for odd kernels (padding=(k-1)//2 * dilation)."""
    k = weight.shape[-1]
    return conv1d(x, weight, bias, padding=(k - 1) // 2 * dilation,
                  dilation=dilation, groups=groups)
