"""HiFi-GAN ResBlock1 kernels: one branch (K2) and the whole MRF stage (K3).

Counterparts of piper_tpu.ops.pallas.resblock.pallas_resblock1_branch and
pallas_resblock1_mrf. The kernels are CUDA C++ for Hopper
(`csrc/resblock1.cu`, whose header says what bounds them on the H100 and
how the design answers it), on warpgroup products (wgmma) at every tier:
bf16 operands at "high" and "default", whose weights this module lays out
as the shared-memory image the kernel bulk-copies (`wgmma_weights`), and
3xTF32 at "highest" (three TF32 passes, 495/3 TFLOP/s of fp32-class
products), whose weights' big and small tf32 planes it lays out the same
way in fp32 (`wgmma_tf32_weights`); the kernel splits the activations
where it writes them, so its products read both operands from shared
memory. C is 16, 32 or 64 at every tier, and at "highest" any multiple of
16 below 128, as the Pallas kernels take it (48, 80, 96 and 112, which no
preset voice has, in place and, past 64, with the weights streamed an
atom of a tap at a time). Each sits beside its plain PyTorch version.

Contract, as on the TPU: a branch is y = x; for d in dilations:
y += conv2(act(conv1_d(act(y)))), with conv1 dilated, conv2 dense, both
same-padded with bias, and act = leaky ReLU then the row's [lo, hi) mask.
The result is exactly zero outside [lo, hi). `bounds` is (B,) meaning
[0, hi) or (B, 2) meaning [lo, hi), at this level's sample rate; it is
clamped to [0, N]. `precision` is the tier of the convs' products
(`precision.py`); the activation, mask, bias and fp32 sums do not change.
At "high" and "default" a kernel differs from its plain version only in
the order of its fp32 sums. At "highest" the plain version multiplies in
fp32 and the kernel in three TF32 passes (`precision.split_tf32`), which
drop about 2^-21 of each product: well inside the 1e-4 bar over the six
chained convs of a branch.

bf16 activations (the runtime's "bfloat16" mode): x, the weights and the
biases may all be bfloat16 at "default", the tier that mode maps to, and
nowhere else (`check_io_dtype`). The kernel reads them as they are, keeps
the residual in fp32 and act(y), act(conv1) in the same bf16 planes as on
fp32 input, and stores its output rounded to bf16; so it equals the
fp32-input kernel on the same bf16 values with the output rounded to bf16.
The plain version computes the same: the fp32 plain version at "default" on
x.float(), its output rounded to bf16.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. Each wrapper's `launches` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from piper_tpu_torch.ops.kernels.precision import TIERS, split_tf32, tier_code, tiered_conv1d
from piper_tpu_torch.ops.nn import leaky_relu

_SMEM_LIMIT = 232448  # dynamic shared memory one block may opt into on the H100
_SMS = 132            # the H100's SMs, where the device does not say
_THREADS = 512
_MAX_BRANCHES = 4
_MAX_DILS = 4
_WGMMA_WIDTHS = (16, 32, 64)  # the wgmma stage's C at the bf16 tiers (one wgmma's N)
_HIGHEST_WIDTHS = (16, 32, 48, 64, 80, 96, 112)  # and at "highest"
_WINDOW = 256  # the wgmma stage's window: 64 lanes per warpgroup
_RINGS = (2, 3)  # the wgmma stage's weight slots
_CHUNKS = (1, 2, 3, 4, 6, 11)  # taps a slot may hold (at most a conv's)


def check_io_dtype(what: str, x: torch.Tensor, tier: int, others=()) -> bool:
    """True for bf16 activations, False for fp32; raises on any other dtype,
    on bf16 at a tier other than "default" (tier code 2: the products of
    bf16 activations are one bf16 pass, so a tier asking for more would
    silently get less) and on weights or biases (`others`, None skipped)
    of another dtype than x."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} takes float32 or bfloat16 activations, got {x.dtype}")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and tier != 2:
        raise ValueError(f"{what}: bfloat16 activations run at the 'default' tier only (the "
                         f"tier the 'bfloat16' mode maps to); tier {TIERS[tier]!r} would need "
                         f"more than one bf16 product of each pair")
    for t in others:
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"{what}: weights and biases must have the activations' dtype "
                             f"{x.dtype}, got {t.dtype}")
    return bf16


def branch_halo(kernel: int, dilations: Sequence[int]) -> int:
    """One-sided receptive field of a branch: sum((k-1)//2*d + (k-1)//2)."""
    h2 = (kernel - 1) // 2
    return sum(h2 * d + h2 for d in dilations)


def _bounds_array(bounds: Optional[torch.Tensor], b: int, n: int,
                  device: torch.device) -> torch.Tensor:
    """(B, 2) int32 [lo, hi) on `device`, clamped to [0, n]."""
    if bounds is None:
        out = torch.tensor([[0, n]], dtype=torch.int32, device=device).expand(b, 2)
    else:
        bounds = torch.as_tensor(bounds, device=device).to(torch.int32)
        if bounds.ndim == 1:
            out = torch.stack([torch.zeros_like(bounds), bounds], dim=1)
        else:
            out = bounds
    if tuple(out.shape) != (b, 2):
        raise ValueError(f"bounds must be (B,) or (B, 2) with B={b}, got {tuple(out.shape)}")
    return out.clamp(0, n).contiguous()


def _mask(bounds: torch.Tensor, n: int) -> torch.Tensor:
    pos = torch.arange(n, device=bounds.device, dtype=torch.int32)
    inside = (pos[None, :] >= bounds[:, :1]) & (pos[None, :] < bounds[:, 1:])
    return inside[:, None, :].to(torch.float32)


def resblock1_chain_plain(x, w1s, b1s, w2s, b2s, kernel: int, dilations: Sequence[int],
                          mask: Optional[torch.Tensor] = None, slope: float = 0.1,
                          precision: str = "highest") -> torch.Tensor:
    """Unfused ResBlock1 branch with F.conv1d at `precision`, output left
    unmasked. act = leaky ReLU, then `mask` ((B, 1, N) float; None masks
    nothing). w1s[m] etc. index the dilations: stacked tensors or lists."""
    def act(v):
        v = leaky_relu(v, slope)
        return v if mask is None else v * mask

    h = (kernel - 1) // 2
    y = x
    for m, d in enumerate(dilations):
        t = tiered_conv1d(act(y), w1s[m], b1s[m], padding=h * d, dilation=d,
                          precision=precision)
        y = y + tiered_conv1d(act(t), w2s[m], b2s[m], padding=h, precision=precision)
    return y


def resblock1_branch_plain(x, w1s, b1s, w2s, b2s, *, kernel: int,
                           dilations: Sequence[int], bounds=None,
                           slope: float = 0.1, tile: int = 256,
                           precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch K2: unfused F.conv1d with the kernel's mask semantics
    (bf16 activations: on their fp32 values, rounded after). `tile` is
    accepted for signature parity and has no effect."""
    tensors = (w1s, b1s, w2s, b2s)
    if check_io_dtype("resblock1_branch", x, tier_code(precision), tensors):
        return resblock1_branch_plain(x.float(), *[t.float() for t in tensors], kernel=kernel,
                                      dilations=dilations, bounds=bounds, slope=slope,
                                      precision=precision).to(torch.bfloat16)
    b, _, n = x.shape
    mask = _mask(_bounds_array(bounds, b, n, x.device), n)
    return resblock1_chain_plain(x, w1s, b1s, w2s, b2s, kernel, dilations, mask, slope,
                                 precision) * mask


def resblock1_mrf_plain(x, branches: Sequence[tuple], *, bounds=None,
                        slope: float = 0.1, tile: int = 256,
                        precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch K3: the mean of the branches, masked (bf16 activations:
    on their fp32 values, rounded after). `branches` holds (w1s, b1s, w2s,
    b2s, kernel, dilations) per branch."""
    if check_io_dtype("resblock1_mrf", x, tier_code(precision),
                      [t for br in branches for t in br[:4]]):
        fp32 = [(*[t.float() for t in br[:4]], *br[4:]) for br in branches]
        return resblock1_mrf_plain(x.float(), fp32, bounds=bounds, slope=slope,
                                   precision=precision).to(torch.bfloat16)
    b, _, n = x.shape
    mask = _mask(_bounds_array(bounds, b, n, x.device), n)
    acc = None
    for (w1s, b1s, w2s, b2s, k, dils) in branches:
        y = resblock1_chain_plain(x, w1s, b1s, w2s, b2s, k, dils, mask, slope, precision)
        acc = y if acc is None else acc + y
    return acc / len(branches) * mask


def _widths(tier: int) -> tuple:
    """The C the wgmma stage takes at tier code `tier`."""
    return _HIGHEST_WIDTHS if tier == 0 else _WGMMA_WIDTHS


def _atom_row(c: int, elem: int) -> int:
    """Bytes of a weight row in one swizzle atom: the widest of 128, 64 and
    32 that divides the row of C values of `elem` bytes
    (csrc/resblock1.cuh::atom_row_bytes)."""
    row = c * elem
    return 128 if row % 128 == 0 else 64 if row % 64 == 0 else 32


def _tap_units(c: int, tier: int) -> int:
    """The ring's units a tap (csrc/resblock1.cuh::tap_units): one, or where
    a tap's image passes 32 KB (at "highest" past C = 64) each swizzle atom
    of the tap with both its planes."""
    elem = 4 if tier == 0 else 2
    tap = (1 if tier == 2 else 2) * elem * c * c
    return c * elem // _atom_row(c, elem) if tap > 32768 else 1


def _smem_bytes(c: int, tile: int, halo: int, mean: bool, tier: int, ring: int = 2,
                chunk: int = 1) -> int:
    """The kernel's shared memory (csrc/resblock1.cu::launch; the residual
    and the MRF's branch sum stay in registers, so `mean` changes nothing):
    up to 1024 bytes to align the ring, `ring` slots of `chunk` units of
    weight images (a tap, or past C = 64 at "highest" an atom of one:
    `_tap_units`; rounded up to 1024 bytes), their mbarriers (16 bytes a
    slot, rounded up to 128), act(y) and act(conv1) as planes of 16-byte
    chunks of W + 1 lanes (lane W takes the stores of lanes outside a
    stage), and a guard of 16 bytes a lane for the 256 - W + halo lanes a
    warpgroup may read past the window. A tap's image and a buffer are two
    planes, bf16 hi and lo at "high" and fp32 tf32 big and small at
    "highest", one bf16 plane at "default"; at "highest" from C = 48 act(y)
    and act(conv1) share one buffer, overwritten in place (two do not fit
    beside the ring)."""
    w = tile + 2 * halo
    elem = 4 if tier == 0 else 2
    planes = 1 if tier == 2 else 2
    buffers = 1 if tier == 0 and c >= 48 else 2
    slot = -(-chunk * planes * elem * c * c // _tap_units(c, tier) // 1024) * 1024
    return (1024 + ring * slot + -(-16 * ring // 128) * 128
            + buffers * planes * elem * (w + 1) * c + 16 * (_WINDOW - w + halo))


def _smem_limit(device: torch.device) -> int:
    """The shared memory a block may opt into on `device`; on the CPU, which
    routes a level as the card would, the H100's."""
    if torch.device(device).type == "cpu":
        return _SMEM_LIMIT
    props = torch.cuda.get_device_properties(device)
    return getattr(props, "shared_memory_per_block_optin", _SMEM_LIMIT)


def wgmma_configs(x: torch.Tensor, halo: int, tile_max: int, tier: int, taps: int = 11):
    """Every (tile, ring, chunk) the wgmma stage can launch for x (B, C, N)
    at this halo, with convs of at most `taps` taps: a window of at most
    256 lanes, a tile of at most `tile_max`, `ring` weight slots (_RINGS) of
    `chunk` units each (_CHUNKS, at most a conv's: taps, or past C = 64 at
    "highest" atoms of taps, `_tap_units`) that fit in shared memory with
    it. Tiles: those whose window fills 1-4 warpgroups' 64 lanes exactly
    (64*g - 2*halo), and `tile_max` itself. Largest tile first."""
    return _configs(x.shape[1], _smem_limit(x.device), halo, tile_max, tier, taps)


def _configs(c: int, limit: int, halo: int, tile_max: int, tier: int, taps: int):
    tiles = sorted({64 * g - 2 * halo for g in (1, 2, 3, 4)} | {tile_max}, reverse=True)
    units = taps * _tap_units(c, tier)
    chunks = sorted({min(ch, units) for ch in _CHUNKS}, reverse=True)
    return [(t, r, ch) for t in tiles if 0 < t <= tile_max and t + 2 * halo <= _WINDOW
            for r in _RINGS for ch in chunks
            if _smem_bytes(c, t, halo, False, tier, r, ch) <= limit]


def stage_takes(c: int, halo: int, tier: int, mean: bool = False, taps: int = 11,
                device="cpu") -> bool:
    """Whether the K2/K3 stage takes a ResBlock1 level of C channels whose
    widest branch reaches `halo` samples a side (convs of at most `taps`
    taps) at tier code `tier`: C one of the tier's widths (`_widths`, each
    a multiple of 16) and some (tile, ring, chunk) of its window and shared
    memory (`wgmma_configs` at the wrappers' default tile cap of 256) on
    `device`. These are the checks the wrappers make before they launch,
    and raise on (`_check_cuda_args`, `_pick_tile`); the model layer sends
    a level they refuse through K1 instead
    (models/vits/hifigan.py::_level). `mean` (the MRF kernel) changes
    nothing: its branch sum stays in registers."""
    del mean
    return (c % 16 == 0 and c in _widths(tier)
            and bool(_configs(c, _smem_limit(device), halo, 256, tier, taps)))


def _pick_tile(x: torch.Tensor, halo: int, mean: bool, tile_max: int, tier: int,
               taps: int = 11):
    """(time tile, weight slots, taps a slot holds) for the kernel; the
    output depends on none of them. Of `wgmma_configs`, the tile with the
    fewest waves of blocks (one block per SM) times warpgroups with lanes in
    the window (the four share the SM's tensor cores), the larger tile on a
    tie; then the fewest chunks a conv of `taps` taps takes (each chunk is a
    wait of every warp, which costs more than the products at these widths:
    `tools/resblock_probe.py --sweep`), with 2 slots and the smallest chunk
    that does it; where a chunk is one tap (the most that fits at "highest"
    and C=64, whose 32 KB tap images share the SM with 128 KB of tf32
    planes), as many slots as fit, 3, so each copy lands further ahead of
    its products (the sweep on the H100: K2 "highest" k=11 at B=1, 0.173
    against 0.187 ms with 2). At K2's and K3's widest branch (halo 60) that
    is tile 136, a window of 256 lanes, at every tier, at B=1 (128 frames)
    and at the serving batch (B=32, T=192)."""
    b, c, n = x.shape
    configs = wgmma_configs(x, halo, tile_max, tier, taps)
    if not configs:
        raise ValueError(f"the wgmma stage takes a window of at most {_WINDOW} lanes and its "
                         f"planes and weight slots in shared memory: no time tile <= "
                         f"{tile_max} fits C={c}, halo={halo}")
    sms = getattr(torch.cuda.get_device_properties(x.device), "multi_processor_count", _SMS)
    units = taps * _tap_units(c, tier)

    def cost(config):
        t, ring, chunk = config
        return (-(-(b * -(-n // t)) // sms) * -(-(t + 2 * halo) // 64), -t, -(-units // chunk),
                -ring if chunk == 1 else ring, chunk)

    return min(configs, key=cost)


def _check_cuda_args(x: torch.Tensor, tensors: Sequence[torch.Tensor],
                     k: int, dilations: Sequence[int], tier: int) -> None:
    if not x.is_contiguous() or x.ndim != 3:
        raise ValueError("x must be a contiguous (B, C, N) tensor, got "
                         f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    c = x.shape[1]
    if c < 16 or c % 16:
        raise ValueError(f"C={c}: the kernels run every tier on the tensor cores and take "
                         f"C a multiple of 16")
    if c not in _widths(tier):
        raise ValueError(f"C={c}: the wgmma stage of the {TIERS[tier]!r} tier takes C of "
                         + ("16, 32 or 64" if tier else "a multiple of 16 below 128"))
    if k % 2 == 0 or not 1 <= len(dilations) <= _MAX_DILS:
        raise ValueError(f"kernel {k} must be odd with 1..{_MAX_DILS} dilations")
    m = len(dilations)
    w1s, b1s, w2s, b2s = tensors
    for name, t, shape in (("w1s", w1s, (m, c, c, k)), ("b1s", b1s, (m, c)),
                           ("w2s", w2s, (m, c, c, k)), ("b2s", b2s, (m, c))):
        if t.device != x.device or t.dtype != x.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {x.dtype} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


_SWIZZLE_CACHE: dict = {}


def _swizzle_on(c: int, elem: int, device: torch.device) -> torch.Tensor:
    """`_swizzle_columns(c, elem)` on `device`, made once per (c, elem, device)."""
    key = (c, elem, str(device))
    if key not in _SWIZZLE_CACHE:
        _SWIZZLE_CACHE[key] = _swizzle_columns(c, elem).to(device)
    return _SWIZZLE_CACHE[key]


def _swizzle_columns(c: int, elem: int) -> torch.Tensor:
    """(C, R / elem) int64 for B images of `elem`-byte values (2 bf16, 4
    fp32) whose rows of C values are cut into atoms of R = `_atom_row(C,
    elem)` bytes along C_in (one for bf16; for fp32 two at C=64, three at 48
    and 96, five at 80, seven at 112), each atom all C rows: at (row co,
    position pos) of an atom, the column of that atom stored there. The
    row's 16-byte chunk q sits at chunk q ^ ((co * R / 128) % (R / 16)):
    wgmma's 128-, 64- or 32-byte swizzle for rows of R bytes, an
    involution."""
    per = _atom_row(c, elem) // elem  # values a row of one atom
    chunk = 16 // elem                # values a 16-byte chunk
    co = torch.arange(c)[:, None]
    pos = torch.arange(per)[None, :]
    return ((pos // chunk) ^ ((co * per * elem // 128) % (per * elem // 16))) * chunk + pos % chunk


def _check_square(w: torch.Tensor, tier: int) -> None:
    m, co, ci, k = w.shape
    if co != ci or co % 16:
        raise ValueError(f"the wgmma stage takes square weights with C a multiple of 16, got "
                         f"C_out={co}, C_in={ci}")
    if co not in _widths(tier):
        raise ValueError(f"the wgmma stage takes C of "
                         + ("16, 32 or 64" if tier else "a multiple of 16 below 128")
                         + f" at {TIERS[tier]!r}, got {co}")


def wgmma_weights(w: torch.Tensor, tier: int) -> torch.Tensor:
    """The wgmma stage's weights at the bf16 tiers: (M, C_out, C_in, K) ->
    (M, K, P, C, C) bf16 (`wgmma_tier_image`): precision.split_bf16's hi and
    lo parts (P = 2, tier 1 "high") or bf16(w) (P = 1, tier 2 "default"),
    from fp32 or, at "default", bf16 weights. Square C of 16, 32 or 64,
    whose rows are one swizzle wide."""
    _check_square(w, tier)
    return wgmma_tier_image(w, tier)


def wgmma_tf32_weights(w: torch.Tensor) -> torch.Tensor:
    """The "highest" tier's weights: (M, C_out, C_in, K) fp32 -> (M, K, 2,
    C, C) fp32 (`wgmma_tier_image`): precision.split_tf32's big and small
    parts (tf32 values: the low 13 bits zero), 4C-byte rows cut into swizzle
    atoms (two along C_in at C = 64). Square C, a multiple of 16 below 128;
    past C = 64 (M, K, A, 2, C, R / 4), atom by atom."""
    _check_square(w, 0)
    return wgmma_tier_image(w, 0)


def wgmma_tier_image(w: torch.Tensor, tier: int) -> torch.Tensor:
    """The shared-memory image of wgmma's B operand at tier code `tier`, the
    one layout K1-K4 bulk-copy: (M, C_out, C_in, K) -> (M, K, P, C, C), per
    (conv, tap) K-major (row co holds its C_in weights) with the swizzle of
    `_swizzle_columns`, each (conv, tap) one bulk copy of P planes:
    precision.split_tf32's big and small parts in fp32 at "highest" (P = 2),
    split_bf16's hi and lo at "high" (P = 2), bf16(w) at "default" (P = 1,
    from fp32 or bf16 weights). Where the ring's unit is one swizzle atom of
    a tap (`_tap_units`: a tap's image past 32 KB) the image is (M, K, A, P,
    C, R / elem), atom by atom, each its P planes. Square C, any multiple
    of 16 up to 128 (the widths checks are the callers')."""
    if tier == 0:
        parts, elem = torch.stack(split_tf32(w)), 4
    else:
        hi = w.to(torch.bfloat16)  # split_bf16's hi; lo is what it leaves, rounded
        parts = torch.stack((hi, (w - hi.float()).to(torch.bfloat16))) if tier == 1 else hi[None]
        elem = 2
    img = wgmma_image(parts, elem=elem)
    m, k, p, c, _ = img.shape
    if _tap_units(c, tier) == 1:
        return img
    per = _atom_row(c, elem) // elem
    return img.reshape(m, k, p, c // per, c, per).transpose(2, 3).contiguous()


def wgmma_image(parts: torch.Tensor, elem: int = 2) -> torch.Tensor:
    """(P, M, C, C, K) -> (M, K, P, C, C), any dtype: each (conv, tap,
    plane) tile's rows cut into atoms and permuted by `_swizzle_columns(C,
    elem)`, for values of `elem` bytes on the card. A permutation of the
    values, one gather."""
    p, m, co, ci, k = parts.shape
    per = _atom_row(co, elem) // elem
    atoms = parts.reshape(p, m, co, ci // per, per, k).permute(1, 5, 0, 3, 2, 4)
    cols = _swizzle_on(co, elem, parts.device).expand(m, k, p, ci // per, co, per)
    return torch.gather(atoms, 5, cols).reshape(m, k, p, co, ci)


def _kernel_weights(w1s, b1s, w2s, b2s, tier: int):
    """The weights in the kernel's layout for the tier: the conv weights as
    the wgmma stage's bulk-copied image (wgmma_tf32_weights at "highest";
    wgmma_weights at "high" and "default", from fp32 or, at "default", bf16
    weights), both convs' in one pass; the biases as they are."""
    both = torch.cat((w1s, w2s))
    both = wgmma_tf32_weights(both) if tier == 0 else wgmma_weights(both, tier)
    w1t, w2t = both[:len(w1s)], both[len(w1s):]
    out = (w1t, b1s.contiguous(), w2t, b2s.contiguous())
    if out[0].data_ptr() % 16 or out[2].data_ptr() % 16:
        raise ValueError("the kernel's conv weights must be 16-byte aligned")
    return out


def _stream(x: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def resblock1_branch(x, w1s, b1s, w2s, b2s, *, kernel: int,
                     dilations: Sequence[int], bounds=None, slope: float = 0.1,
                     tile: int = 256, precision: str = "highest") -> torch.Tensor:
    """One ResBlock1 branch: returns y after all (conv1, conv2, +) stages.

    x (B, C, N); w1s/w2s (M, C, C, K); b1s/b2s (M, C), all float32, or all
    bfloat16 at "default". `tile` caps the kernel's time tile (the result
    does not depend on it)."""
    tier = tier_code(precision)
    bf16 = check_io_dtype("resblock1_branch", x, tier, (w1s, b1s, w2s, b2s))
    if x.device.type == "cpu":
        return resblock1_branch_plain(x, w1s, b1s, w2s, b2s, kernel=kernel,
                                      dilations=dilations, bounds=bounds,
                                      slope=slope, tile=tile, precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"resblock1_branch runs on cpu or cuda, not {x.device}")
    _check_cuda_args(x, (w1s, b1s, w2s, b2s), kernel, dilations, tier)
    config = _pick_tile(x, branch_halo(kernel, dilations), False, tile, tier, kernel)
    out = _launch_branch(x, (w1s, b1s, w2s, b2s), kernel, dilations, bounds, slope, tier,
                         bf16, config)
    resblock1_branch.launches += 1
    return out


def _launch_branch(x, weights, kernel: int, dilations: Sequence[int], bounds, slope: float,
                   tier: int, bf16: bool, config) -> torch.Tensor:
    """One launch of the branch kernel on checked arguments, with `config`
    = (time tile, weight slots, taps a slot holds) as `_pick_tile` gives it."""
    from piper_tpu_torch.ops.kernels import build

    lib = build.load()
    b, c, n = x.shape
    bnd = _bounds_array(bounds, b, n, x.device)
    w1t, b1c, w2t, b2c = _kernel_weights(*weights, tier)
    out = torch.empty_like(x)
    dils = (ctypes.c_int * len(dilations))(*dilations)
    code = lib.piper_resblock1_branch(
        x.data_ptr(), w1t.data_ptr(), b1c.data_ptr(), w2t.data_ptr(), b2c.data_ptr(),
        kernel, len(dilations), ctypes.cast(dils, ctypes.c_void_p), bnd.data_ptr(),
        out.data_ptr(), b, c, n, *config, slope, tier, int(bf16), x.device.index or 0,
        _stream(x))
    build.check(lib, code, "piper_resblock1_branch")
    return out


resblock1_branch.launches = 0


def mrf_launch_args(x, branches: Sequence[tuple], tile: int, tier: int,
                    config=None) -> tuple:
    """Check the MRF `branches` against x (B, C, N) and build the per-branch
    arguments of the MRF C entries at tier code `tier`: returns ((time
    tile, weight slots, taps a slot holds), the arguments from n_branches to
    dils, what must stay alive until the call returns). `config` replaces
    `_pick_tile`'s."""
    nb = len(branches)
    if not 1 <= nb <= _MAX_BRANCHES:
        raise ValueError(f"the MRF kernel takes 1..{_MAX_BRANCHES} branches, got {nb}")
    ks, dils_list, weights = [], [], []
    for (w1s, b1s, w2s, b2s, k, dils) in branches:
        _check_cuda_args(x, (w1s, b1s, w2s, b2s), int(k), dils, tier)
        ks.append(int(k))
        dils_list.append([int(d) for d in dils])
        weights.append(_kernel_weights(w1s, b1s, w2s, b2s, tier))
    halo = max(branch_halo(k, d) for k, d in zip(ks, dils_list))
    if config is None:
        config = _pick_tile(x, halo, True, tile, tier, max(ks))
    arrays = [(ctypes.c_void_p * nb)(*[w[i].data_ptr() for w in weights]) for i in range(4)]
    arrays += [(ctypes.c_int * nb)(*ks), (ctypes.c_int * nb)(*[len(d) for d in dils_list]),
               (ctypes.c_int * (nb * _MAX_DILS))(
                   *[d[j] if j < len(d) else 0 for d in dils_list for j in range(_MAX_DILS)])]
    args = (nb, *[ctypes.cast(a, ctypes.c_void_p) for a in arrays])
    return config, args, (arrays, weights)


def resblock1_mrf(x, branches: Sequence[tuple], *, bounds=None, slope: float = 0.1,
                  tile: int = 256, precision: str = "highest") -> torch.Tensor:
    """The whole multi-receptive-field stage: every ResBlock1 branch and
    their mean. `branches` holds (w1s, b1s, w2s, b2s, kernel, dilations),
    float32 with x, or bfloat16 with x at "default"."""
    tier = tier_code(precision)
    bf16 = check_io_dtype("resblock1_mrf", x, tier, [t for br in branches for t in br[:4]])
    if x.device.type == "cpu":
        return resblock1_mrf_plain(x, branches, bounds=bounds, slope=slope,
                                   tile=tile, precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"resblock1_mrf runs on cpu or cuda, not {x.device}")
    out = _launch_mrf(x, branches, bounds, slope, tier, bf16, tile)
    resblock1_mrf.launches += 1
    return out


def _launch_mrf(x, branches: Sequence[tuple], bounds, slope: float, tier: int, bf16: bool,
                tile: int, config=None) -> torch.Tensor:
    """One launch of the MRF kernel (`mrf_launch_args` checks the branches
    and, unless `config` gives it, picks the (tile, slots, chunk))."""
    config, args, _keep = mrf_launch_args(x, branches, tile, tier, config)
    from piper_tpu_torch.ops.kernels import build

    lib = build.load()
    b, c, n = x.shape
    bnd = _bounds_array(bounds, b, n, x.device)
    out = torch.empty_like(x)
    code = lib.piper_resblock1_mrf(x.data_ptr(), *args, bnd.data_ptr(), out.data_ptr(),
                                   b, c, n, *config, slope, tier, int(bf16),
                                   x.device.index or 0, _stream(x))
    build.check(lib, code, "piper_resblock1_mrf")
    return out


resblock1_mrf.launches = 0
