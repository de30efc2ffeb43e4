"""The whole HiFi-GAN MRF stage on the folded layout (K4).

Counterpart of piper_tpu.ops.pallas.folded.pallas_resblock1_mrf_folded: the
contract of K3 (`resblock.py`: every ResBlock1 branch and their mean, the
[lo, hi) mask, zero outside it) with the time axis folded into channels,

    x (B, C, N)  ->  xf (B, F*C, ceil(N/F)),   xf[r*C + c, q] = x[c, F*q + r],

outside the kernel, and unfolded after it, as on the TPU. The kernel
(`csrc/resblock1.cu`, piper_resblock1_mrf_folded) walks K3's chain over the
folded tensor with a folded gather and scatter; the TPU kernel's
zero-padded folded weight GEMM, which buys MXU rows with S/k redundant
FLOPs, is not carried over. The kernel reads and writes only the folded
layout; the mask is applied on the sample g = F*q + r.

K4 runs only in `tools/folded_probe.py`, never on synthesis's path, so it
keeps fp32 activations at every tier: bf16 activations (the runtime's
"bfloat16" mode) go through K3, and this wrapper refuses them.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. `resblock1_mrf_folded.launches` counts the launches.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from piper_tpu_torch.ops.kernels.precision import tier_code
from piper_tpu_torch.ops.kernels.resblock import (
    _bounds_array,
    _stream,
    mrf_launch_args,
    resblock1_mrf_plain,
)


def fold_time_axis(x: torch.Tensor, fold: int) -> torch.Tensor:
    """(B, C, N) -> (B, F*C, ceil(N/F)) with xf[r*C+c, q] = x[c, F*q+r],
    zero-padded past N."""
    b, ch, n = x.shape
    nq = -(-n // fold)
    xp = F.pad(x, (0, nq * fold - n))
    return xp.reshape(b, ch, nq, fold).permute(0, 3, 1, 2).reshape(b, fold * ch, nq)


def unfold_time_axis(xf: torch.Tensor, fold: int, n: int) -> torch.Tensor:
    """Inverse of fold_time_axis, sliced back to length n."""
    b, ch_f, nq = xf.shape
    ch = ch_f // fold
    return xf.reshape(b, fold, ch, nq).permute(0, 2, 3, 1).reshape(b, ch, nq * fold)[:, :, :n]


def _check_fold(fold: int, x: torch.Tensor) -> None:
    if not isinstance(fold, int) or fold < 1:
        raise ValueError(f"fold must be a positive int, got {fold!r}")
    if x.dtype != torch.float32:
        raise ValueError(f"resblock1_mrf_folded takes float32 activations only, got {x.dtype} "
                         f"(bf16 activations go through resblock1_mrf)")


def resblock1_mrf_folded_plain(x, branches: Sequence[tuple], *, fold: int = 4, bounds=None,
                               slope: float = 0.1, tile: int = 512,
                               precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch K4: fold, unfold, then K3's plain version at the tier.
    `tile` is accepted for signature parity and has no effect."""
    _check_fold(fold, x)
    n = x.shape[2]
    xu = unfold_time_axis(fold_time_axis(x, fold), fold, n)
    return resblock1_mrf_plain(xu, branches, bounds=bounds, slope=slope, precision=precision)


def resblock1_mrf_folded(x, branches: Sequence[tuple], *, fold: int = 4, bounds=None,
                         slope: float = 0.1, tile: int = 512,
                         precision: str = "highest") -> torch.Tensor:
    """Every ResBlock1 branch and their mean, through the folded layout.

    x (B, C, N); `branches` holds (w1s, b1s, w2s, b2s, kernel, dilations);
    `bounds` (B,) [0, hi) or (B, 2) [lo, hi), clamped to [0, N]. `tile` caps
    the kernel's time tile at fold*tile samples, as the TPU kernel's tile
    counts folded lanes (the result does not depend on it)."""
    _check_fold(fold, x)
    if x.device.type == "cpu":
        return resblock1_mrf_folded_plain(x, branches, fold=fold, bounds=bounds, slope=slope,
                                          tile=tile, precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"resblock1_mrf_folded runs on cpu or cuda, not {x.device}")
    tier = tier_code(precision)
    config, args, _keep = mrf_launch_args(x, branches, fold * tile, tier)
    from piper_tpu_torch.ops.kernels import build

    lib = build.load()
    b, c, n = x.shape
    bnd = _bounds_array(bounds, b, n, x.device)
    xf = fold_time_axis(x, fold).contiguous()
    out = torch.empty_like(xf)
    code = lib.piper_resblock1_mrf_folded(
        xf.data_ptr(), *args, bnd.data_ptr(), out.data_ptr(), b, c, xf.shape[2], fold,
        *config, slope, tier, x.device.index or 0, _stream(x))
    build.check(lib, code, "piper_resblock1_mrf_folded")
    resblock1_mrf_folded.launches += 1
    return unfold_time_axis(out, fold, n).contiguous()


resblock1_mrf_folded.launches = 0
