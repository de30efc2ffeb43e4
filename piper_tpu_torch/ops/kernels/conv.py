"""Same-padded dilated conv1d with a fused leaky-ReLU input (K1).

Counterpart of piper_tpu.ops.pallas.conv.pallas_conv1d_same: the ResBlock2
convs and the unfused narrow ResBlock1 convs. The kernel is CUDA C++ for
Hopper (`csrc/conv1d.cu`, whose header says what bounds it on the H100 and
how the design answers it): fp32 FMAs on CUDA cores at "highest", bf16
mma.sync on the tensor cores at "high" and "default". It sits beside its
plain PyTorch version.

Contract, as on the TPU: out = conv1d_same(leaky_relu(x, act_slope), w, b,
dilation=d), zero padding on both sides, odd k, square weights (C, C, k);
act_slope 0 is the identity. `bounds`, where given, is (B,) meaning
[0, hi) or (B, 2) meaning [lo, hi), clamped to [0, N], as the ResBlock1
kernels take it: the activated input is also zero outside it, which is the
TPU kernel on x * mask for the 0/1 mask of those bounds. The output is not
masked. `precision` is the tier of the conv's products (`precision.py`), as
mxu_dot gives it on the TPU.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. `conv1d_same.launches` counts the kernel launches.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from piper_tpu_torch.ops.kernels.precision import tier_code, tiered_conv1d
from piper_tpu_torch.ops.kernels.resblock import (_MMA_PAD, _SMEM_LIMIT, _THREADS,
                                                  _bounds_array, _mask, _stream)
from piper_tpu_torch.ops.nn import leaky_relu

_TILES = (256, 128, 64, 32)
_MMA_TILES = (256, 128, 64, 32, 16)  # "high"/"default": multiples of 2 n-tiles of 8 lanes
_MMA_STAGE_PAD = 8  # the output stage's row is tile + 8 floats (conv1d.cu)
_props = functools.lru_cache(maxsize=None)(torch.cuda.get_device_properties)


def conv1d_same_plain(x, weight, bias=None, *, dilation: int = 1, act_slope: float = 0.0,
                      bounds=None, tile: int = 4096,
                      precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch K1. `tile` is accepted for signature parity and has no
    effect."""
    k = weight.shape[-1]
    xin = leaky_relu(x, act_slope) if act_slope else x
    if bounds is not None:
        b, _, n = x.shape
        xin = xin * _mask(_bounds_array(bounds, b, n, x.device), n)
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


def _kernel_bounds(bounds, b: int, device: torch.device) -> Tuple[Optional[torch.Tensor], int]:
    """The bounds as the kernel reads them, (int32 tensor, columns): (B,)
    is 1 column ([0, hi)), (B, 2) two ([lo, hi)), None none. The kernel
    clamps them to [0, N], so bounds already int32 on the device cost no
    launch."""
    if bounds is None:
        return None, 0
    t = torch.as_tensor(bounds, device=device)
    if t.dtype != torch.int32:
        t = t.to(torch.int32)
    if tuple(t.shape) not in ((b,), (b, 2)):
        raise ValueError(f"bounds must be (B,) or (B, 2) with B={b}, got {tuple(t.shape)}")
    return t.contiguous(), 1 if t.ndim == 1 else 2


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


def mma_smem_bytes(c: int, k: int, tile: int, pad: int, tier: int) -> int:
    """The tensor-core kernel's shared memory: the weights as bf16 planes
    [tap][C_out][C_in + 8] (two at "high", one at "default", C padded to a
    multiple of 16), then the window's planes [lane][C_in + 8] or the fp32
    output stage (C, tile + 8) over them, whichever is larger."""
    cp = -(-c // 16) * 16
    planes = 2 if tier == 1 else 1
    row = 2 * (cp + _MMA_PAD)
    window = planes * (tile + 2 * pad) * row
    return planes * k * cp * row + max(window, 4 * c * (tile + _MMA_STAGE_PAD))


def _mma_warps(c: int, tile: int, m_tiles: int) -> int:
    """Warps of the tensor-core kernel's block: one per work item of
    m_tiles m-tiles by 2 n-tiles."""
    return -(-c // 16) // m_tiles * (tile // 16)


def _mma_config(x: torch.Tensor, k: int, pad: int, tile_max: int, tier: int) -> Tuple[int, int]:
    """(tile, m-tiles per warp) of the tensor-core kernel: the most warps a
    block takes (16 where a tile allows it, each warp then owning the
    fewest m-tiles), then the fewest lanes per SM (ceil(tiles / SMs) tiles,
    blocks on one SM sharing it), the larger tile on a tie. Only tiles
    (256 ... 16, at most `tile_max`) that fit in shared memory count. On
    the H100 at x_low's two levels and both tiers this took the fastest
    (tile, m-tiles) of `tools/conv1d_probe.py --sweep`. The output depends
    on neither."""
    b, c, n = x.shape
    props = _props(x.device)
    limit = getattr(props, "shared_memory_per_block_optin", _SMEM_LIMIT)
    n16 = -(-c // 16)
    best = None
    for t in _MMA_TILES:
        ms = [m for m in (1, 2, 4) if n16 % m == 0 and _mma_warps(c, t, m) <= _THREADS // 32]
        if t > tile_max or not ms or mma_smem_bytes(c, k, t, pad, tier) > limit:
            continue
        lanes = -(-(b * -(-n // t)) // props.multi_processor_count) * t
        key = (-_mma_warps(c, t, ms[0]), lanes)
        if best is None or key < best[0]:
            best = (key, t, ms[0])
    if best is None:
        raise ValueError(f"no time tile <= {tile_max} fits C={c}, k={k}, pad={pad}: the "
                         f"weights' bf16 planes and the window exceed {limit} bytes of "
                         f"shared memory")
    return best[1], best[2]


def conv1d_same(x, weight, bias=None, *, dilation: int = 1, act_slope: float = 0.0,
                bounds=None, tile: int = 4096, precision: str = "highest") -> torch.Tensor:
    """conv1d_same(leaky_relu(x, act_slope) [zero outside bounds], weight,
    bias, dilation=dilation).

    x (B, C, N) float32; weight (C, C, k), k odd; bias (C,) or None; bounds
    (B,) or (B, 2) or None. `tile` caps the kernel's time tile (the result
    does not depend on it)."""
    tier = tier_code(precision)
    _check_args(x, weight, bias)
    if x.device.type == "cpu":
        return conv1d_same_plain(x, weight, bias, dilation=dilation, act_slope=act_slope,
                                 bounds=bounds, tile=tile, precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_same runs on cpu or cuda, not {x.device}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is not None and (t.device != x.device or t.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 on {x.device}, got {t.dtype} on {t.device}")
    if not x.is_contiguous() or x.shape[1] % 8:
        raise ValueError(f"x must be contiguous with C a multiple of 8, got C={x.shape[1]} "
                         f"contiguous={x.is_contiguous()}")
    k = weight.shape[-1]
    pad = (k - 1) // 2 * dilation
    if tier == 0:
        # (C_out, C_in, K) -> (C_in, K, C_out): 8 output channels of one
        # (input channel, tap) are two float4 loads.
        w = weight.permute(1, 2, 0).contiguous()
        if w.data_ptr() % 16:
            raise ValueError("transposed conv weights must be 16-byte aligned")
        t, m_tiles = _pick_tile(x, k, pad, tile), 0
    else:  # the kernel splits the caller's weights into bf16 planes itself
        w = weight.contiguous()
        t, m_tiles = _mma_config(x, k, pad, tile, tier)
    out = _launch(x, w, k, bias, bounds, dilation, act_slope, tier, t, m_tiles)
    conv1d_same.launches += 1
    return out


def _launch(x, w, k: int, bias, bounds, dilation: int, act_slope: float, tier: int,
            tile: int, m_tiles: int) -> torch.Tensor:
    """One launch of the kernel on checked arguments, with `w` in the
    tier's layout and the (tile, m_tiles) given."""
    from piper_tpu_torch.ops.kernels import build

    lib = build.load()
    b, c, n = x.shape
    bnd, cols = _kernel_bounds(bounds, b, x.device)
    bc = None if bias is None else bias.contiguous()
    out = torch.empty_like(x)
    # slope 1 is the identity: act_slope 0 means no activation, as on the TPU.
    code = lib.piper_conv1d_same(
        x.data_ptr(), w.data_ptr(), None if bc is None else bc.data_ptr(),
        None if bnd is None else bnd.data_ptr(), cols, out.data_ptr(), b, c, n, k, dilation,
        tile, act_slope if act_slope else 1.0, tier, m_tiles, x.device.index or 0, _stream(x))
    build.check(lib, code, "piper_conv1d_same")
    return out


conv1d_same.launches = 0
