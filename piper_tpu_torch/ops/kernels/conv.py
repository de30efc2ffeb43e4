"""Same-padded dilated conv1d with a fused leaky-ReLU input (K1).

Counterpart of piper_tpu.ops.pallas.conv.pallas_conv1d_same: the ResBlock2
convs and the unfused narrow ResBlock1 convs. The kernel is CUDA C++ for
Hopper (`csrc/conv1d.cu`, whose header says what bounds it on the H100 and
how the design answers it): mma.sync on the tensor cores at every tier,
3xTF32 at "highest" and bf16 at "high" and "default", from the caller's
fp32 weights as they are (the kernel stages and splits them itself, so no
launch lays them out). It sits beside its plain PyTorch version.

Contract, as on the TPU: out = conv1d_same(leaky_relu(x, act_slope), w, b,
dilation=d), zero padding on both sides, odd k, square weights (C, C, k);
act_slope 0 is the identity. `bounds`, where given, is (B,) meaning
[0, hi) or (B, 2) meaning [lo, hi), clamped to [0, N], as the ResBlock1
kernels take it: the activated input is also zero outside it, which is the
TPU kernel on x * mask for the 0/1 mask of those bounds. The output is not
masked. `precision` is the tier of the conv's products (`precision.py`), as
mxu_dot gives it on the TPU. At "high" and "default" the kernel differs
from its plain version only in the order of its fp32 sums; at "highest" it
forms each product as 3xTF32 (`precision.split_tf32`), about 2^-21 from
the plain version's fp32 product.

bf16 activations (the runtime's "bfloat16" mode): x, weight and bias may
all be bfloat16 at "default", the tier that mode maps to, and nowhere else
(`resblock.check_io_dtype`). The kernel reads them straight into the bf16
planes it stages at "default" (no fp32 -> bf16 split), sums in fp32 and
stores the output rounded to bf16; the plain version is the fp32 plain
version at "default" on their fp32 values, rounded to bf16.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. `conv1d_same.launches` counts the kernel launches.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from piper_tpu_torch.ops.kernels.precision import tier_code, tiered_conv1d
from piper_tpu_torch.ops.kernels.resblock import (_MMA_PAD, _SMEM_LIMIT, _TF32_PAD,
                                                  _THREADS, _bounds_array, _mask, _stream,
                                                  check_io_dtype)
from piper_tpu_torch.ops.nn import leaky_relu

_MMA_TILES = (256, 128, 64, 32, 16)  # multiples of a warp's n-tiles of 8 lanes
# A warp's 8-lane n-tiles by tier code: "highest" takes 4 (each A fragment
# split on read then feeds 12 mma) or 2; the bf16 tiers 2 (one ldmatrix.x4
# of B).
_N_TILES = ((4, 2), (2,), (2,))
# A warp's 16-channel m-tiles by tier code: "highest" takes at most 2 (4 by
# its n-tiles would spill registers).
_M_TILES = ((1, 2), (1, 2, 4), (1, 2, 4))
_MMA_STAGE_PAD = 8  # the output stage's row is tile + 8 floats (conv1d.cu)
_props = functools.lru_cache(maxsize=None)(torch.cuda.get_device_properties)


def conv1d_same_plain(x, weight, bias=None, *, dilation: int = 1, act_slope: float = 0.0,
                      bounds=None, tile: int = 4096,
                      precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch K1 (bf16 activations: on their fp32 values at
    "default", rounded after). `tile` is accepted for signature parity and
    has no effect."""
    if check_io_dtype("conv1d_same", x, tier_code(precision), (weight, bias)):
        return conv1d_same_plain(
            x.float(), weight.float(), None if bias is None else bias.float(),
            dilation=dilation, act_slope=act_slope, bounds=bounds,
            precision=precision).to(torch.bfloat16)
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


def mma_smem_bytes(c: int, k: int, tile: int, pad: int, tier: int) -> int:
    """The kernel's shared memory at tier code `tier`: the weights as planes
    [tap][C_out][C_in + row pad] (C padded to a multiple of 16), then the
    window's planes [lane][C_in + row pad] or the fp32 output stage
    (C, tile + 8) over them, whichever is larger. "highest" keeps the
    weights in one fp32 plane and the window in two, its tf32 big and small
    parts (row pad 4 words); "high" two bf16 planes of each (row pad 8),
    "default" one."""
    cp = -(-c // 16) * 16
    if tier == 0:
        row = 4 * (cp + _TF32_PAD)
        return k * cp * row + max(2 * (tile + 2 * pad) * row, 4 * c * (tile + _MMA_STAGE_PAD))
    row = (2 if tier == 1 else 1) * 2 * (cp + _MMA_PAD)
    return k * cp * row + max((tile + 2 * pad) * row, 4 * c * (tile + _MMA_STAGE_PAD))


def _mma_warps(c: int, tile: int, m_tiles: int, n_tiles: int) -> int:
    """Warps of the kernel's block: one per work item of m_tiles m-tiles by
    n_tiles n-tiles of 8 lanes."""
    return -(-c // 16) // m_tiles * (tile // (8 * n_tiles))


def _mma_config(x: torch.Tensor, k: int, pad: int, tile_max: int,
                tier: int) -> Tuple[int, int, int]:
    """(tile, m-tiles, n-tiles per warp) of the kernel, each warp owning the
    fewest m-tiles a block of at most 16 warps allows. At "high"/"default"
    (2 n-tiles): the most warps a block takes, then the fewest lanes per SM
    (ceil(tiles / SMs) tiles, blocks on one SM sharing it). At "highest"
    (2 or 4 n-tiles): the fewest window lanes per SM (the same count of
    tiles, each tile + 2*pad lanes, staged and split once), then the most
    warps, then 4 n-tiles. The larger tile on a tie. Only tiles (256 ... 16,
    at most `tile_max`, a multiple of a warp's lanes) that fit in shared
    memory count. On the H100 at x_low's two levels at B=1 this took the
    fastest (tile, m-tiles, n-tiles) of `tools/conv1d_probe.py --sweep` at
    every tier. The output depends on none of them."""
    b, c, n = x.shape
    props = _props(x.device)
    limit = getattr(props, "shared_memory_per_block_optin", _SMEM_LIMIT)
    n16 = -(-c // 16)
    best = None
    for t in _MMA_TILES:
        if t > tile_max or mma_smem_bytes(c, k, t, pad, tier) > limit:
            continue
        per_sm = -(-(b * -(-n // t)) // props.multi_processor_count)
        for nt in _N_TILES[tier]:
            ms = [m for m in _M_TILES[tier]
                  if n16 % m == 0 and 0 < _mma_warps(c, t, m, nt) <= _THREADS // 32]
            if t % (8 * nt) or not ms:
                continue
            warps = _mma_warps(c, t, ms[0], nt)
            key = ((per_sm * (t + 2 * pad), -warps, -nt) if tier == 0
                   else (-warps, per_sm * t))
            if best is None or key < best[0]:
                best = (key, t, ms[0], nt)
    if best is None:
        raise ValueError(f"no time tile <= {tile_max} fits C={c}, k={k}, pad={pad}: the "
                         f"weights' planes and the window exceed {limit} bytes of "
                         f"shared memory")
    return best[1:]


def conv1d_same(x, weight, bias=None, *, dilation: int = 1, act_slope: float = 0.0,
                bounds=None, tile: int = 4096, precision: str = "highest") -> torch.Tensor:
    """conv1d_same(leaky_relu(x, act_slope) [zero outside bounds], weight,
    bias, dilation=dilation).

    x (B, C, N) float32, or bfloat16 at "default"; weight (C, C, k), k odd,
    and bias (C,) or None, of x's dtype; bounds (B,) or (B, 2) or None.
    `tile` caps the kernel's time tile (the result does not depend on it)."""
    tier = tier_code(precision)
    _check_args(x, weight, bias)
    bf16 = check_io_dtype("conv1d_same", x, tier, (weight, bias))
    if x.device.type == "cpu":
        return conv1d_same_plain(x, weight, bias, dilation=dilation, act_slope=act_slope,
                                 bounds=bounds, tile=tile, precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_same runs on cpu or cuda, not {x.device}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    if not x.is_contiguous() or x.shape[1] % 8:
        raise ValueError(f"x must be contiguous with C a multiple of 8, got C={x.shape[1]} "
                         f"contiguous={x.is_contiguous()}")
    k = weight.shape[-1]
    t, m_tiles, n_tiles = _mma_config(x, k, (k - 1) // 2 * dilation, tile, tier)
    out = _launch(x, weight.contiguous(), k, bias, bounds, dilation, act_slope, tier, t,
                  m_tiles, n_tiles, bf16)
    conv1d_same.launches += 1
    return out


def _launch(x, w, k: int, bias, bounds, dilation: int, act_slope: float, tier: int,
            tile: int, m_tiles: int, n_tiles: int, bf16: bool = False) -> torch.Tensor:
    """One launch of the kernel on checked arguments, contiguous (C, C, k)
    weights `w` and the (tile, m_tiles, n_tiles) given; `bf16` for bf16
    x, w, bias and output."""
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
        tile, act_slope if act_slope else 1.0, tier, m_tiles, n_tiles, int(bf16),
        x.device.index or 0, _stream(x))
    build.check(lib, code, "piper_conv1d_same")
    return out


conv1d_same.launches = 0
