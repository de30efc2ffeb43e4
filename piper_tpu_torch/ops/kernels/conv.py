"""Same-padded dilated conv1d with a fused leaky-ReLU input (K1).

Counterpart of piper_tpu.ops.pallas.conv.pallas_conv1d_same: the ResBlock2
convs and the unfused narrow ResBlock1 convs. The kernel is CUDA C++ for
Hopper (`csrc/conv1d.cu`, whose header says what bounds it on the H100 and
how the design answers it); it sits beside its plain PyTorch version.

Contract, as on the TPU: out = conv1d_same(leaky_relu(x, act_slope), w, b,
dilation=d), zero padding on both sides, odd k, square weights (C, C, k);
act_slope 0 is the identity. No mask and no bounds: a caller that masks
passes x * mask, and the output is not masked. `precision` is the tier of
the conv's products (`precision.py`), as mxu_dot gives it on the TPU.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. `conv1d_same.launches` counts the kernel launches.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from piper_tpu_torch.ops.kernels.precision import tier_code, tiered_conv1d
from piper_tpu_torch.ops.kernels.resblock import _SMEM_LIMIT, _THREADS, _stream
from piper_tpu_torch.ops.nn import leaky_relu

_TILES = (256, 128, 64, 32)
_props = functools.lru_cache(maxsize=None)(torch.cuda.get_device_properties)


def conv1d_same_plain(x, weight, bias=None, *, dilation: int = 1, act_slope: float = 0.0,
                      tile: int = 4096, precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch K1. `tile` is accepted for signature parity and has no
    effect."""
    k = weight.shape[-1]
    xin = leaky_relu(x, act_slope) if act_slope else x
    return tiered_conv1d(xin, weight, bias, padding=(k - 1) // 2 * dilation,
                         dilation=dilation, precision=precision)


def _check_args(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """The contract's shapes, checked on every device."""
    if x.ndim != 3 or weight.ndim != 3:
        raise ValueError(f"x must be (B, C, N) and weight (C, C, k), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    c_out, c_in, k = weight.shape
    c = x.shape[1]
    if c_out != c_in or c_in != c:
        raise ValueError(f"square-channel convs only: weight {tuple(weight.shape)}, C={c}")
    if k % 2 == 0:
        raise ValueError(f"kernel size {k} must be odd")
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"bias must be ({c},), got {tuple(bias.shape)}")


def _pick_tile(x: torch.Tensor, k: int, pad: int, tile_max: int) -> int:
    """Largest time tile (256/128/64/32, at most `tile_max`) that one pass of
    the block covers (C/8 * tile/2 threads, at most 512), whose window
    (tile + 2*pad samples) fits in shared memory beside the weights, and
    whose grid still gives half the SMs a block; else the smallest that
    fits. K1 recomputes no halo, so the tile trades the per-block staging
    of the weights against spreading the same warps over more SMs:
    measured on the H100 at x_low's shapes, this rule took the fastest tile
    or one within 7% of it. The output does not depend on the tile."""
    b, c, n = x.shape
    props = _props(x.device)
    limit = getattr(props, "shared_memory_per_block_optin", _SMEM_LIMIT)
    fits = [t for t in _TILES if t <= tile_max and c // 8 * (t // 2) <= _THREADS
            and 4 * c * (k * c + t + 2 * pad) <= limit]
    if not fits:
        raise ValueError(f"no time tile <= {tile_max} fits C={c}, k={k}, pad={pad}: "
                         f"the weights and the window exceed {limit} bytes of shared memory")
    half = props.multi_processor_count // 2
    return next((t for t in fits if b * -(-n // t) >= half), fits[-1])


def conv1d_same(x, weight, bias=None, *, dilation: int = 1, act_slope: float = 0.0,
                tile: int = 4096, precision: str = "highest") -> torch.Tensor:
    """conv1d_same(leaky_relu(x, act_slope), weight, bias, dilation=dilation).

    x (B, C, N) float32; weight (C, C, k), k odd; bias (C,) or None. `tile`
    caps the kernel's time tile (the result does not depend on it)."""
    tier = tier_code(precision)
    _check_args(x, weight, bias)
    if x.device.type == "cpu":
        return conv1d_same_plain(x, weight, bias, dilation=dilation,
                                 act_slope=act_slope, tile=tile, precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_same runs on cpu or cuda, not {x.device}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is not None and (t.device != x.device or t.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 on {x.device}, got {t.dtype} on {t.device}")
    if not x.is_contiguous() or x.shape[1] % 8:
        raise ValueError(f"x must be contiguous with C a multiple of 8, got C={x.shape[1]} "
                         f"contiguous={x.is_contiguous()}")
    from piper_tpu_torch.ops.kernels import build

    lib = build.load()
    b, c, n = x.shape
    k = weight.shape[-1]
    # (C_out, C_in, K) -> (C_in, K, C_out): 8 output channels of one (input
    # channel, tap) are two float4 loads.
    wt = weight.permute(1, 2, 0).contiguous()
    if wt.data_ptr() % 16:
        raise ValueError("transposed conv weights must be 16-byte aligned")
    bc = torch.zeros(c, device=x.device) if bias is None else bias.contiguous()
    t = _pick_tile(x, k, (k - 1) // 2 * dilation, tile)
    out = torch.empty_like(x)
    # slope 1 is the identity: act_slope 0 means no activation, as on the TPU.
    code = lib.piper_conv1d_same(
        x.data_ptr(), wt.data_ptr(), bc.data_ptr(), out.data_ptr(), b, c, n, k, dilation,
        t, act_slope if act_slope else 1.0, tier, x.device.index or 0, _stream(x))
    build.check(lib, code, "piper_conv1d_same")
    conv1d_same.launches += 1
    return out


conv1d_same.launches = 0
