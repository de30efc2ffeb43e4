"""Same-padded dilated conv1d with a fused leaky-ReLU input (K1).

Counterpart of piper_tpu.ops.pallas.conv.pallas_conv1d_same: the ResBlock2
convs, the unfused narrow ResBlock1 convs, and the ResBlock1 levels whose
width or halo the ResBlock1 kernels do not take. The kernel is CUDA C++ for
Hopper (`csrc/conv1d.cu`, whose header says what bounds it on the H100 and
how the design answers it): warpgroup products (wgmma) at every tier,
3xTF32 at "highest" and bf16 at "high" and "default", on K2-K4's stage
(`csrc/resblock1.cuh`) for one conv. Its weights are the stage's
bulk-copied, swizzled image (`resblock.wgmma_tier_image` of the weights
zero-padded to C rounded up to 16), laid out once per weight tensor and
tier (`weight_image`), so a call is one launch. Any square C from 1 to 128
runs. It sits beside its plain PyTorch version.

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
plane it stages at "default" (no fp32 -> bf16 split), sums in fp32 and
stores the output rounded to bf16; the plain version is the fp32 plain
version at "default" on their fp32 values, rounded to bf16.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. `conv1d_same.launches` counts the kernel launches.
"""

from __future__ import annotations

import functools
import weakref
from typing import Optional, Tuple

import torch

from piper_tpu_torch.ops.kernels.precision import tier_code, tiered_conv1d
from piper_tpu_torch.ops.kernels.resblock import (_SMEM_LIMIT, _SMS, _bounds_array, _mask,
                                                  _stream, _tap_units, check_io_dtype,
                                                  wgmma_tier_image)
from piper_tpu_torch.ops.nn import leaky_relu

_MAX_C = 128
_TILES = (256, 192, 128, 64, 32, 16)  # output samples a block: 64 a warpgroup
_RINGS = (1, 2, 3)  # the weight slots (at most the conv's chunks)
_CHUNKS = (1, 2, 3, 4, 5, 6, 7, 11)  # units a slot may hold (and a whole conv's)
_SMEM_SM = 233472  # shared memory of an H100 SM, where the device does not say
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


def _padded(c: int) -> int:
    """C rounded up to a multiple of 16: wgmma's N and K steps."""
    return -(-c // 16) * 16


def _stage_stride(tile: int) -> int:
    """The output stage's row in floats (csrc/conv1d.cuh::stage_stride): at
    least the tile, 4 past a multiple of 16."""
    return (tile + 11) // 16 * 16 + 4


def smem_bytes(c: int, k: int, pad: int, tile: int, tier: int, ring: int, chunk: int) -> int:
    """The kernel's shared memory (csrc/conv1d.cuh::smem_bytes) at tier code
    `tier`: up to 1024 bytes to align the ring; min(ring, chunks) slots of
    `chunk` units of the weight image (a tap, or where a tap's image passes
    32 KB one swizzle atom of it, `_tap_units`; rounded up to 1024 bytes)
    and their mbarriers (16 bytes a slot, rounded up to 128); then the
    window's act(x) planes, Cp channels (C rounded up to 16) by tile + 2*pad
    + 1 lanes (the last takes the stores past the window), with a guard of
    16 bytes for each of the last warpgroup's rows past the tile, or the
    fp32 output stage over them (C rows of `_stage_stride(tile)`), whichever
    is larger. The planes are tf32 big and small (fp32 words) at "highest",
    bf16 hi and lo at "high", bf16 at "default"; the image has as many."""
    cp = _padded(c)
    elem = 4 if tier == 0 else 2
    planes = 1 if tier == 2 else 2
    units = _tap_units(cp, tier)
    depth = min(ring, -(-k * units // chunk))
    slot = -(-chunk * (planes * elem * cp * cp // units) // 1024) * 1024
    rows = -(-tile // 64) * 64
    act = planes * elem * cp * (tile + 2 * pad + 1) + 16 * (rows - tile)
    return (1024 + depth * slot + -(-16 * depth // 128) * 128
            + max(act, 4 * c * _stage_stride(tile)))


def configs(x: torch.Tensor, k: int, pad: int, tile_max: int, tier: int) -> list:
    """Every (tile, warpgroups, ring, chunk) the kernel can launch for x (B,
    C, N) and a conv of k taps reaching `pad` samples a side: a tile of at
    most `tile_max` output samples from _TILES (and `tile_max` itself below
    256); a block of the tile's ceil(tile / 64) warpgroups or of four (the
    rest only load and store); `ring` weight slots of `chunk` units (of the
    conv's k * `_tap_units` units) each, one slot for a conv of one chunk,
    else 2 or 3 but at most the conv's chunks (a chunk's slot is refilled
    once the products on the chunk before it are done, so one slot for two
    chunks would wait on itself); those that fit in shared memory. Largest
    tile first."""
    limit = getattr(_props(x.device), "shared_memory_per_block_optin", _SMEM_LIMIT)
    return list(_configs(x.shape[1], k, pad, tile_max, tier, limit))


@functools.lru_cache(maxsize=None)
def _configs(c: int, k: int, pad: int, tile_max: int, tier: int, limit: int) -> tuple:
    units = k * _tap_units(_padded(c), tier)
    tiles = sorted({t for t in _TILES if t <= tile_max} | {min(tile_max, 256)}, reverse=True)
    chunks = sorted({min(ch, units) for ch in _CHUNKS} | {units}, reverse=True)
    return tuple((t, g, r, ch) for t in tiles for g in sorted({-(-t // 64), 4})
                 for ch in chunks for r in _RINGS
                 if (r == 1) == (ch == units) and r <= -(-units // ch)
                 and smem_bytes(c, k, pad, t, tier, r, ch) <= limit)


def _resident(c: int, smem: int, warpgroups: int, smem_sm: int) -> int:
    """Blocks of the kernel an SM holds at once: by shared memory (1 KB of
    it reserved a block), by threads (2048 an SM) and by registers (65,536
    an SM; ptxas gives the kernel 36-59 a thread at C <= 32, 66-128 past
    it: counted as 64 and 128)."""
    threads = 128 * warpgroups
    regs = 64 if _padded(c) <= 32 else 128
    return max(1, min(smem_sm // (smem + 1024), 2048 // threads, 65536 // (threads * regs)))


def pick_config(x: torch.Tensor, k: int, pad: int, tile_max: int,
                tier: int) -> Tuple[int, int, int, int]:
    """(tile, warpgroups, weight slots, units a slot holds) of the kernel;
    the output depends on none of them. Measured on the H100 at x_low's
    levels (`tools/conv1d_probe.py --sweep`, B=1 and B=32, every tier):
    - where the level's samples fill at most two 128-sample tiles an SM (a
      batch of 1), blocks of four warpgroups (their loads in flight at
      once; only the tile's own run products), tiles of 128 where that
      still gives every SM a block, else 64; then the fewest chunks;
    - at a serving batch, blocks of the tile's own warpgroups: tiles of 128
      holding the most blocks an SM (`_resident`: a block's window loads
      and epilogue run under another's products), then the fewest chunks;
      where no 128-sample block shares its SM ("highest" at C=64), the
      fewest window lanes an SM instead (ceil(blocks / SMs) blocks of
      their product rows and 2*pad lanes of halo), so the halo is staged
      the fewest times;
    - then, where a chunk is one unit, 3 slots (each copy further ahead of
      its products), else 2; the larger tile last. A tile cap below a
      preferred tile takes the nearest tile under it."""
    props = _props(x.device)
    return _pick(*x.shape, k, pad, tile_max, tier,
                 getattr(props, "shared_memory_per_block_optin", _SMEM_LIMIT),
                 getattr(props, "multi_processor_count", _SMS),
                 getattr(props, "shared_memory_per_multiprocessor", _SMEM_SM))


@functools.lru_cache(maxsize=4096)
def _pick(b: int, c: int, n: int, k: int, pad: int, tile_max: int, tier: int, limit: int,
          sms: int, smem_sm: int) -> Tuple[int, int, int, int]:
    """pick_config's choice, once per shape and card (the wrapper's host
    time stays a lookup)."""
    found = _configs(c, k, pad, tile_max, tier, limit)
    if not found:
        raise ValueError(f"no time tile <= {tile_max} fits C={c}, k={k}, pad={pad}: the "
                         f"window's planes and a weight slot exceed the shared memory")
    units = k * _tap_units(_padded(c), tier)
    few = b * n <= 2 * 128 * sms
    tile = 128 if not few or b * -(-n // 128) >= sms else 64
    if not few:
        found = tuple(f for f in found if f[1] == -(-f[0] // 64))

    def resident(config):
        t, g, ring, chunk = config
        return _resident(c, smem_bytes(c, k, pad, t, tier, ring, chunk), g, smem_sm)

    at_tile = [resident(f) for f in found if f[0] == tile]
    shared = few or not at_tile or max(at_tile) > 1

    def cost(config):
        t, g, ring, chunk = config
        chunks = -(-units // chunk)
        if few:
            first = (abs(t - tile), g != 4, 0)
        elif shared:
            first = (abs(t - tile), 0, -resident(config))
        else:
            first = (-(-(b * -(-n // t)) // sms) * (-(-t // 64) * 64 + 2 * pad), 0, 0)
        return (*first, chunks, abs(ring - (3 if chunk == 1 else 2)) if chunks > 1 else 0, -t)

    return min(found, key=cost)


_IMAGES: dict = {}  # (id(weight), tier) -> (weakref to weight, version, image, made)


def weight_image(w: torch.Tensor, tier: int) -> torch.Tensor:
    """The kernel's weights at tier code `tier`: `resblock.wgmma_tier_image`
    of w (C, C, k) zero-padded to C rounded up to 16, laid out once per
    weight tensor and tier and cached against the tensor's identity and its
    version counter (so an in-place update lays it out again; an inference
    tensor keeps no counter, and is cached against its identity alone),
    dropped when the tensor is freed. On the card the layout runs on the
    caller's stream; a caller on another stream (a mesh's virtual slots
    share their device's weights) waits for it first, with no host sync."""
    version = None if w.is_inference() else w._version
    key = (id(w), tier)
    hit = _IMAGES.get(key)
    if hit is not None and hit[0]() is w and hit[1] == version:
        _, _, img, made = hit
        if made is not None:
            stream = torch.cuda.current_stream(img.device)
            if stream != made[0]:
                stream.wait_event(made[1])
                img.record_stream(stream)
        return img
    c = w.shape[0]
    p = _padded(c) - c
    img = wgmma_tier_image(torch.nn.functional.pad(w, (0, 0, 0, p, 0, p))[None], tier)
    made = None
    if img.is_cuda:
        stream = torch.cuda.current_stream(img.device)
        made = (stream, stream.record_event())
    _IMAGES[key] = (weakref.ref(w, lambda _, key=key: _IMAGES.pop(key, None)), version, img, made)
    return img


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
    if not x.is_contiguous() or x.shape[1] > _MAX_C:
        raise ValueError(f"x must be contiguous with C <= {_MAX_C}, got C={x.shape[1]} "
                         f"contiguous={x.is_contiguous()}")
    k = weight.shape[-1]
    config = pick_config(x, k, (k - 1) // 2 * dilation, tile, tier)
    out = _launch(x, weight, k, bias, bounds, dilation, act_slope, tier, config, bf16)
    conv1d_same.launches += 1
    return out


def _launch(x, w, k: int, bias, bounds, dilation: int, act_slope: float, tier: int,
            config: Tuple[int, int, int, int], bf16: bool = False) -> torch.Tensor:
    """One launch of the kernel on checked arguments, (C, C, k) weights `w`
    (laid out by `weight_image`) and `config` = (tile, warpgroups, weight
    slots, units a slot holds) as `pick_config` gives it; `bf16` for bf16
    x, w, bias and output."""
    from piper_tpu_torch.ops.kernels import build

    lib = build.load()
    b, c, n = x.shape
    img = weight_image(w, tier)
    if img.data_ptr() % 16:
        raise ValueError("the kernel's weight image must be 16-byte aligned")
    bnd, cols = _kernel_bounds(bounds, b, x.device)
    bc = None if bias is None else bias.contiguous()
    out = torch.empty_like(x)
    # slope 1 is the identity: act_slope 0 means no activation, as on the TPU.
    code = lib.piper_conv1d_same(
        x.data_ptr(), img.data_ptr(), None if bc is None else bc.data_ptr(),
        None if bnd is None else bnd.data_ptr(), cols, out.data_ptr(), b, c, n, k, dilation,
        config[0], act_slope if act_slope else 1.0, tier, *config[1:], int(bf16),
        x.device.index or 0, _stream(x))
    build.check(lib, code, "piper_conv1d_same")
    return out


conv1d_same.launches = 0
