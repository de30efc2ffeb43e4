"""1-D convolutions in VITS's native (B, C, T) layout.

Counterpart of piper_tpu.ops.conv without its TPU lowerings (the polyphase
conv-transpose and the packed narrow conv exist to fill the TPU's matrix
unit). These convs ran in XLA outside any Pallas kernel, so here they are
PyTorch's own; the runtime keeps them at full fp32 (no TF32).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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
