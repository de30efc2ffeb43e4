"""The lane interleave of the polyphase conv-transpose (K5).

Counterpart of the Pallas kernel `mosaic_interleave` of tools/ct_probe.py
(lines 147-167: `_int_kernel` and its pallas_call), which times the
interleave step of piper_tpu.ops.conv.conv_transpose1d's polyphase lowering
(piper_tpu/ops/conv.py:121). The kernel is CUDA C++ for Hopper
(`csrc/interleave.cu`, whose header says what bounds it and how the design
answers it); it sits beside its plain PyTorch version.

Contract: y (B, r, c, q) float32, contiguous, 1 <= r <= 8, in; (B, c, q*r)
out, out[b, ci, qi*r + ri] = y[b, ri, ci, qi]. A permutation: the kernel is
bit-equal to the plain version.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. `interleave.launches` counts the kernel launches.
"""

from __future__ import annotations

import torch

from piper_tpu_torch.ops.kernels.resblock import _stream

MAX_PHASES = 8


def interleave_plain(y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K5. One PyTorch call computes the same function (the
    copy behind the reshape), so this is also K5's library yardstick."""
    b, r, c, q = y.shape
    return y.permute(0, 2, 3, 1).reshape(b, c, q * r)


def _check(y: torch.Tensor) -> None:
    """The contract, checked on every device."""
    if not isinstance(y, torch.Tensor) or y.ndim != 4:
        raise ValueError(f"y must be a (B, r, c, q) tensor, got "
                         f"{tuple(y.shape) if isinstance(y, torch.Tensor) else type(y)}")
    if y.dtype != torch.float32:
        raise ValueError(f"y must be float32, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    if not 1 <= y.shape[1] <= MAX_PHASES:
        raise ValueError(f"r = {y.shape[1]} phases: the kernel takes 1 to {MAX_PHASES}")


def interleave(y: torch.Tensor) -> torch.Tensor:
    """(B, r, c, q) -> (B, c, q*r): out[b, ci, qi*r + ri] = y[b, ri, ci, qi]."""
    _check(y)
    if y.device.type == "cpu":
        return interleave_plain(y)
    if y.device.type != "cuda":
        raise ValueError(f"interleave runs on cpu or cuda, not {y.device}")
    from piper_tpu_torch.ops.kernels import build

    lib = build.load()
    b, r, c, q = y.shape
    out = torch.empty((b, c, q * r), dtype=y.dtype, device=y.device)
    code = lib.piper_interleave(y.data_ptr(), out.data_ptr(), b, r, c, q,
                                y.device.index or 0, _stream(y))
    build.check(lib, code, "piper_interleave")
    interleave.launches += 1
    return out


interleave.launches = 0
