"""Same-padded dilated conv1d with a fused leaky-ReLU input (K1).

Counterpart of piper_tpu.ops.pallas.conv.pallas_conv1d_same: the ResBlock2
convs, the unfused ResBlock1 convs, and the ResBlock1 levels whose width or
halo the ResBlock1 kernels do not take. The kernel is CUDA C++ for Hopper,
on warpgroup products (wgmma), in two designs, each source's header saying
what bounds it on the H100 and how the design answers it:

- below 128 channels (`csrc/conv1d.cu`), every tier, 3xTF32 at "highest"
  and bf16 at "high" and "default", on K2-K4's stage (`csrc/resblock1.cuh`)
  for one conv, the whole window staged at once. Its weights are the
  stage's bulk-copied, swizzled image (`resblock.wgmma_tier_image` of the
  weights zero-padded to C rounded up to 16);
- from 128 to 256 channels, the wide design (`csrc/conv1d_wide.cu`), at
  "highest" and "high" on fp32 activations: blocks of 128 output channels,
  the input channels in chunks whose window is staged while the products
  run on the chunk before, the weights streamed through a ring of 16 KB
  (chunk, tap) units (`wide_image`, C zero-padded to a multiple of 128).

Each design's image is laid out once per weight tensor and tier
(`weight_image`, `wide_weight_image`), so a call is one launch. It sits
beside its plain PyTorch version.

Contract, as on the TPU: out = conv1d_same(leaky_relu(x, act_slope), w, b,
dilation=d), zero padding on both sides, odd k, square weights (C, C, k),
C at most 256; act_slope 0 is the identity. `bounds`, where given, is (B,)
meaning [0, hi) or (B, 2) meaning [lo, hi), clamped to [0, N], as the
ResBlock1 kernels take it: the activated input is also zero outside it,
which is the TPU kernel on x * mask for the 0/1 mask of those bounds. The
output is not masked. `residual`, where given (x's shape and dtype), is
added last: out = residual + (conv + bias), bit-equal to `residual +
conv1d_same(...)` of the same kernel, as the ResBlocks add each conv's
output to their running sum. `precision` is the tier of the conv's products
(`precision.py`), as mxu_dot gives it on the TPU. At "high" and "default"
the kernel differs from its plain version only in the order of its fp32
sums; at "highest" it forms each product as 3xTF32
(`precision.split_tf32`), about 2^-21 from the plain version's fp32 product.

bf16 activations (the runtime's "bfloat16" mode): x, weight and bias may
all be bfloat16 at "default", the tier that mode maps to, and nowhere else
(`resblock.check_io_dtype`). The kernel reads them straight into the bf16
plane it stages at "default" (no fp32 -> bf16 split), sums in fp32 and
stores the output rounded to bf16; the plain version is the fp32 plain
version at "default" on their fp32 values, rounded to bf16.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises (past 128 channels at "default" or on bf16 activations,
which the wide design does not run). `conv1d_same.launches` counts the
kernel launches of both designs, `conv1d_same.wide_launches` the wide
design's alone.
"""

from __future__ import annotations

import functools
import weakref
from typing import Optional, Tuple

import torch

from piper_tpu_torch.ops.kernels.precision import split_tf32, tier_code, tiered_conv1d
from piper_tpu_torch.ops.kernels.resblock import (_SMEM_LIMIT, _SMS, _bounds_array, _mask,
                                                  _stream, _swizzle_on, _tap_units,
                                                  check_io_dtype, wgmma_tier_image)
from piper_tpu_torch.ops.nn import leaky_relu

MAX_C = 256  # the widest square conv K1 takes
WIDE_FROM = 128  # C from which the wide design runs ("highest" and "high")
NARROW_MAX = 128  # the widest conv the narrow design takes (every tier)
_TILES = (256, 192, 128, 64, 32, 16)  # output samples a block: 64 a warpgroup
_RINGS = (1, 2, 3)  # the weight slots (at most the conv's chunks)
_CHUNKS = (1, 2, 3, 4, 5, 6, 7, 11)  # units a slot may hold (and a whole conv's)
_SMEM_SM = 233472  # shared memory of an H100 SM, where the device does not say
_props = functools.lru_cache(maxsize=None)(torch.cuda.get_device_properties)


def conv1d_same_plain(x, weight, bias=None, *, dilation: int = 1, act_slope: float = 0.0,
                      bounds=None, residual=None, tile: int = 4096,
                      precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch K1 (bf16 activations: on their fp32 values at
    "default", rounded after), `residual` added to the conv's output.
    `tile` is accepted for signature parity and has no effect."""
    if check_io_dtype("conv1d_same", x, tier_code(precision), (weight, bias, residual)):
        out = conv1d_same_plain(
            x.float(), weight.float(), None if bias is None else bias.float(),
            dilation=dilation, act_slope=act_slope, bounds=bounds,
            precision=precision).to(torch.bfloat16)
    else:
        k = weight.shape[-1]
        xin = leaky_relu(x, act_slope) if act_slope else x
        if bounds is not None:
            b, _, n = x.shape
            xin = xin * _mask(_bounds_array(bounds, b, n, x.device), n)
        out = tiered_conv1d(xin, weight, bias, padding=(k - 1) // 2 * dilation,
                            dilation=dilation, precision=precision)
    return out if residual is None else residual + out


def _check_args(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                residual: Optional[torch.Tensor] = None) -> None:
    """The contract's shapes, checked on every device."""
    if x.ndim != 3 or weight.ndim != 3:
        raise ValueError(f"x must be (B, C, N) and weight (C, C, k), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    c_out, c_in, k = weight.shape
    c = x.shape[1]
    if c_out != c_in or c_in != c:
        raise ValueError(f"square-channel convs only: weight {tuple(weight.shape)}, C={c}")
    if c > MAX_C:
        raise ValueError(f"C={c}: K1 takes square convs of at most {MAX_C} channels")
    if k % 2 == 0:
        raise ValueError(f"kernel size {k} must be odd")
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"bias must be ({c},), got {tuple(bias.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual must be x's shape {tuple(x.shape)}, got "
                         f"{tuple(residual.shape)}")


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


_IMAGES: dict = {}  # (id(weight), layout) -> (weakref to weight, version, image, made)


def weight_image(w: torch.Tensor, tier: int) -> torch.Tensor:
    """The kernel's weights at tier code `tier`: `resblock.wgmma_tier_image`
    of w (C, C, k) zero-padded to C rounded up to 16, laid out once per
    weight tensor and tier and cached against the tensor's identity and its
    version counter (so an in-place update lays it out again; an inference
    tensor keeps no counter, and is cached against its identity alone),
    dropped when the tensor is freed. On the card the layout runs on the
    caller's stream; a caller on another stream (a mesh's virtual slots
    share their device's weights) waits for it first, with no host sync."""
    p = _padded(w.shape[0]) - w.shape[0]
    return _cached_image(w, tier, lambda: wgmma_tier_image(
        torch.nn.functional.pad(w, (0, 0, 0, p, 0, p))[None], tier))


def _cached_image(w: torch.Tensor, layout, make) -> torch.Tensor:
    """make()'s image of w, cached under (id(w), layout) as `weight_image`
    says."""
    version = None if w.is_inference() else w._version
    key = (id(w), layout)
    hit = _IMAGES.get(key)
    if hit is not None and hit[0]() is w and hit[1] == version:
        _, _, img, made = hit
        if made is not None:
            stream = torch.cuda.current_stream(img.device)
            if stream != made[0]:
                stream.wait_event(made[1])
                img.record_stream(stream)
        return img
    img = make()
    made = None
    if img.is_cuda:
        stream = torch.cuda.current_stream(img.device)
        made = (stream, stream.record_event())
    _IMAGES[key] = (weakref.ref(w, lambda _, key=key: _IMAGES.pop(key, None)), version, img, made)
    return img


# -- the wide design (csrc/conv1d_wide.cu): C from WIDE_FROM to MAX_C ------

_WIDE_NT = 128  # output channels a block
_WIDE_UNIT = 16384  # one (chunk, tap) unit of the image: 2 planes x 128 rows x 64 bytes
_WIDE_TILES = (256, 192, 128, 64)  # output samples a block: 64 a warpgroup
_WIDE_RINGS = (4, 3, 2)  # the weight slots


def _wide_cp(c: int) -> int:
    """C rounded up to a multiple of the wide design's 128 output channels."""
    return -(-c // _WIDE_NT) * _WIDE_NT


def _wide_chunk(tier: int) -> int:
    """The input channels of one 64-byte chunk a plane: 16 tf32 values at
    "highest", 32 bf16 values at "high"."""
    return 16 if tier == 0 else 32


def wide_image(w: torch.Tensor, tier: int) -> torch.Tensor:
    """The wide design's weights at tier code `tier` (0 or 1): (C, C, k)
    zero-padded to Cp = C rounded up to 128 -> (Cp / 128, Cp / kc, k, 2,
    128, kc), per block of 128 output channels, per chunk of kc input
    channels (64 bytes: 16 at "highest", 32 at "high") and per tap, one 16
    KB unit: both planes (split_tf32's big and small in fp32, split_bf16's
    hi and lo in bf16) of the block's 128 rows of the chunk, each row's
    16-byte groups stored with wgmma's 64-byte swizzle (group q of row r at
    q ^ (r / 2 % 4), `resblock._swizzle_columns` of a 64-byte row)."""
    c, _, k = w.shape
    cp, kc = _wide_cp(c), _wide_chunk(tier)
    w = torch.nn.functional.pad(w, (0, 0, 0, cp - c, 0, cp - c))
    if tier == 0:
        parts, elem = torch.stack(split_tf32(w)), 4
    else:
        hi = w.to(torch.bfloat16)
        parts, elem = torch.stack((hi, (w - hi.float()).to(torch.bfloat16))), 2
    units = parts.reshape(2, cp // _WIDE_NT, _WIDE_NT, cp // kc, kc, k).permute(1, 3, 5, 0, 2, 4)
    # The swizzle's rows repeat every 8: kc rows of it serve all 128.
    cols = _swizzle_on(kc, elem, w.device).repeat(_WIDE_NT // kc, 1)
    return torch.gather(units, 5, cols.expand(units.shape)).contiguous()


def wide_smem_bytes(tile: int, pad: int, ring: int, tier: int) -> int:
    """The wide kernel's shared memory (csrc/conv1d_wide.cuh::smem_bytes)
    at tier code `tier`: up to 1024 bytes to align the ring; `ring` 16 KB
    slots, two window buffers (both planes of a 64-byte chunk, tile + 2*pad
    + 1 lanes) and two raw buffers (a chunk's fp32 rows, `_wide_chunk`
    channels of `_stage_stride(tile + 2*pad)` floats), or the fp32 output
    stage over them (128 rows of `_stage_stride(tile)`), whichever is
    larger, rounded up to 128; then the slots' mbarriers."""
    w = tile + 2 * pad
    body = (ring * _WIDE_UNIT + 2 * 2 * 64 * (w + 1)
            + 2 * 4 * _wide_chunk(tier) * _stage_stride(w))
    stage = 4 * _WIDE_NT * _stage_stride(tile)
    return 1024 + -(-max(body, stage) // 128) * 128 + -(-16 * ring // 128) * 128


@functools.lru_cache(maxsize=None)
def _wide_configs(c: int, k: int, pad: int, tile_max: int, tier: int, limit: int) -> tuple:
    units = _wide_cp(c) // _wide_chunk(tier) * k
    return tuple((t, r) for t in _WIDE_TILES if t <= max(tile_max, 64) for r in _WIDE_RINGS
                 if r <= units and wide_smem_bytes(t, pad, r, tier) <= limit)


def wide_configs(x: torch.Tensor, k: int, pad: int, tile_max: int, tier: int) -> list:
    """Every (tile, ring) the wide kernel can launch for x (B, C, N) and a
    conv of k taps reaching `pad` samples a side: a tile of 64-256 samples
    (tile / 64 warpgroups, each running products), at most `tile_max` (or
    64), and 2-4 weight slots, at most the conv's units, that fit in shared
    memory. Largest tile first, then the most slots."""
    limit = getattr(_props(x.device), "shared_memory_per_block_optin", _SMEM_LIMIT)
    return list(_wide_configs(x.shape[1], k, pad, tile_max, tier, limit))


def pick_wide(x: torch.Tensor, k: int, pad: int, tile_max: int, tier: int) -> Tuple[int, int]:
    """(tile, weight slots) of the wide kernel; the output depends on
    neither. Each block streams all of its 128 output channels' weights
    whatever its tile, so the largest tile whose blocks still fill every SM
    once (a weight byte then serves the most samples), else the smallest
    (the most blocks where a level has few: serving groups of a few rows);
    then 4 slots where they fit beside it, else the most that do. Measured
    on the H100 at a 128-row batch of a high voice's wide levels
    (`tools/conv1d_probe.py --wide --sweep`): at "high" tiles of 256 with 4
    slots within 5% of the fastest config at every conv ("highest": 15%),
    two blocks of 128 an SM up to 4% faster where they fit and up to 48%
    slower elsewhere, 2 slots up to 16% slower than 3 or 4."""
    props = _props(x.device)
    return _pick_wide(*x.shape, k, pad, tile_max, tier,
                      getattr(props, "shared_memory_per_block_optin", _SMEM_LIMIT),
                      getattr(props, "multi_processor_count", _SMS))


@functools.lru_cache(maxsize=4096)
def _pick_wide(b: int, c: int, n: int, k: int, pad: int, tile_max: int, tier: int, limit: int,
               sms: int) -> Tuple[int, int]:
    found = _wide_configs(c, k, pad, tile_max, tier, limit)
    if not found:
        raise ValueError(f"no time tile <= {max(tile_max, 64)} fits C={c}, k={k}, pad={pad}: "
                         f"the window's buffers and two weight slots exceed the shared memory")
    tiles = sorted({t for t, _ in found}, reverse=True)
    full = [t for t in tiles if _wide_cp(c) // _WIDE_NT * -(-n // t) * b >= sms]
    tile = full[0] if full else tiles[-1]
    rings = [r for t, r in found if t == tile]
    return tile, 4 if 4 in rings else rings[0]


def wide_design(c: int, tier: int) -> bool:
    """Whether a C-channel conv at tier code `tier` launches the wide
    design: from WIDE_FROM channels at "highest" and "high"; past
    NARROW_MAX at every tier (the wrapper then refuses "default"). C=128
    at "default" (bf16 activations too) keeps the narrow design."""
    return c > NARROW_MAX or (c >= WIDE_FROM and tier != 2)


def wide_weight_image(w: torch.Tensor, tier: int) -> torch.Tensor:
    """`wide_image(w, tier)`, laid out once per weight tensor and tier and
    cached as `weight_image` caches its own."""
    return _cached_image(w, ("wide", tier), lambda: wide_image(w, tier))


def conv1d_same(x, weight, bias=None, *, dilation: int = 1, act_slope: float = 0.0,
                bounds=None, residual=None, tile: int = 4096,
                precision: str = "highest") -> torch.Tensor:
    """residual + conv1d_same(leaky_relu(x, act_slope) [zero outside
    bounds], weight, bias, dilation=dilation).

    x (B, C, N) float32, or bfloat16 at "default"; weight (C, C, k), k odd,
    C <= 256, and bias (C,) or None, of x's dtype; bounds (B,) or (B, 2) or
    None; residual of x's shape and dtype, or None. `tile` caps the
    kernel's time tile (the result does not depend on it)."""
    tier = tier_code(precision)
    _check_args(x, weight, bias, residual)
    bf16 = check_io_dtype("conv1d_same", x, tier, (weight, bias, residual))
    if x.device.type == "cpu":
        return conv1d_same_plain(x, weight, bias, dilation=dilation, act_slope=act_slope,
                                 bounds=bounds, residual=residual, tile=tile,
                                 precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_same runs on cpu or cuda, not {x.device}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias), ("residual", residual)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    if not x.is_contiguous() or (residual is not None and not residual.is_contiguous()):
        raise ValueError("x and the residual must be contiguous")
    k = weight.shape[-1]
    pad = (k - 1) // 2 * dilation
    if wide_design(x.shape[1], tier):
        if tier == 2:
            raise ValueError(f"C={x.shape[1]}: K1's wide design runs 'highest' and 'high' "
                             f"on float32 activations, not 'default'")
        out = _launch_wide(x, weight, k, bias, bounds, residual, dilation, act_slope, tier,
                           pick_wide(x, k, pad, tile, tier))
        conv1d_same.wide_launches += 1
    else:
        config = pick_config(x, k, pad, tile, tier)
        out = _launch(x, weight, k, bias, bounds, dilation, act_slope, tier, config, bf16,
                      residual)
    conv1d_same.launches += 1
    return out


def _launch(x, w, k: int, bias, bounds, dilation: int, act_slope: float, tier: int,
            config: Tuple[int, int, int, int], bf16: bool = False,
            residual=None) -> torch.Tensor:
    """One launch of the kernel on checked arguments, (C, C, k) weights `w`
    (laid out by `weight_image`) and `config` = (tile, warpgroups, weight
    slots, units a slot holds) as `pick_config` gives it; `bf16` for bf16
    x, w, bias, residual and output."""
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
        None if bnd is None else bnd.data_ptr(), cols,
        None if residual is None else residual.data_ptr(), out.data_ptr(), b, c, n, k,
        dilation, config[0], act_slope if act_slope else 1.0, tier, *config[1:], int(bf16),
        x.device.index or 0, _stream(x))
    build.check(lib, code, "piper_conv1d_same")
    return out


def _launch_wide(x, w, k: int, bias, bounds, residual, dilation: int, act_slope: float,
                 tier: int, config: Tuple[int, int]) -> torch.Tensor:
    """One launch of the wide kernel on checked fp32 arguments, (C, C, k)
    weights `w` (laid out by `wide_weight_image`) and `config` = (tile,
    weight slots) as `pick_wide` gives it."""
    from piper_tpu_torch.ops.kernels import build

    lib = build.load()
    b, c, n = x.shape
    img = wide_weight_image(w, tier)
    if img.data_ptr() % 16:
        raise ValueError("the kernel's weight image must be 16-byte aligned")
    bnd, cols = _kernel_bounds(bounds, b, x.device)
    bc = None if bias is None else bias.contiguous()
    out = torch.empty_like(x)
    code = lib.piper_conv1d_same_wide(
        x.data_ptr(), img.data_ptr(), None if bc is None else bc.data_ptr(),
        None if bnd is None else bnd.data_ptr(), cols,
        None if residual is None else residual.data_ptr(), out.data_ptr(), b, c, n, k,
        dilation, config[0], act_slope if act_slope else 1.0, tier, config[1],
        x.device.index or 0, _stream(x))
    build.check(lib, code, "piper_conv1d_same_wide")
    return out


conv1d_same.launches = 0
conv1d_same.wide_launches = 0
