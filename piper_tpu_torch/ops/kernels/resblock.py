"""HiFi-GAN ResBlock1 kernels: one branch (K2) and the whole MRF stage (K3).

Counterparts of piper_tpu.ops.pallas.resblock.pallas_resblock1_branch and
pallas_resblock1_mrf. The kernels are CUDA C++ for Hopper
(`csrc/resblock1.cu`, whose header says what bounds them on the H100 and
how the design answers it), on the tensor cores at every tier: warpgroup
products (wgmma) on bf16 operands at "high" and "default", whose weights
this module lays out as the shared-memory image the kernel bulk-copies
(`wgmma_weights`), and 3xTF32 on mma.sync at "highest", whose weights it
lays out in mma's fragment order (`tf32_weights`). Each sits beside its
plain PyTorch version.

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
_MMA_NT = 2    # "highest": 8-lane n-tiles per warp work item
_MMA_PAD = 8   # K1's bf16 planes: a row is C + 8 channels (ops/kernels/conv.py)
_TF32_PAD = 4  # "highest": an fp32 plane's row is C + 4 channels
_WGMMA_WIDTHS = (16, 32, 64)  # the wgmma stage's C (one wgmma's N)
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


def _smem_bytes(c: int, tile: int, halo: int, mean: bool, tier: int, ring: int = 2,
                chunk: int = 1) -> int:
    """The kernel's shared memory. "highest": the fp32 residual over the
    window, act(y) and act(conv1) as one fp32 lane-major plane each, and the
    MRF's fp32 branch sum. "high"/"default" (the wgmma stage, which keeps
    the residual and the branch sum in registers): up to 1024 bytes to
    align the ring, `ring` slots of `chunk` taps' weight images (rounded up
    to 1024 bytes), their mbarriers (16 bytes a slot, rounded up to 128),
    act(y) and act(conv1) as bf16 planes of 8-channel chunks of W + 1 lanes
    (lane W takes the stores of lanes outside a stage), two each at
    "high", one at "default", and a guard of 16 bytes a lane for the
    256 - W + halo lanes a warpgroup may read past the window
    (csrc/resblock1.cu::launch)."""
    w = tile + 2 * halo
    if tier == 0:
        return 4 * c * w + 2 * 4 * w * (c + _TF32_PAD) + (4 * c * tile if mean else 0)
    planes = 2 if tier == 1 else 1
    slot = -(-chunk * planes * 2 * c * c // 1024) * 1024
    return (1024 + ring * slot + -(-16 * ring // 128) * 128 + 2 * planes * 2 * (w + 1) * c
            + 16 * (_WINDOW - w + halo))


def _mma_m_tiles(c: int) -> int:
    """m-tiles of 16 output channels per warp work item ("highest")."""
    n16 = c // 16
    return 4 if n16 % 4 == 0 else 2 if n16 % 2 == 0 else 1


def _smem_limit(x: torch.Tensor) -> int:
    props = torch.cuda.get_device_properties(x.device)
    return getattr(props, "shared_memory_per_block_optin", _SMEM_LIMIT)


def _tf32_tile(x: torch.Tensor, halo: int, mean: bool, tile_max: int) -> int:
    """"highest": the largest time tile (256/128/64/32, at most `tile_max`)
    whose buffers fit in shared memory and whose window (tile + 2*halo
    samples) fits in one pass of the block's warps (2 n-tiles of 8 lanes by
    up to 64 output channels per warp); else the smallest that fits.
    Measured on the H100 at the medium voice's shapes on CUDA cores: a
    smaller tile to fill more SMs loses to the halo it recomputes."""
    c = x.shape[1]
    limit = _smem_limit(x)
    fits = [t for t in (256, 128, 64, 32)
            if t <= tile_max and _smem_bytes(c, t, halo, mean, 0) <= limit]
    if not fits:
        raise ValueError(f"no time tile <= {tile_max} fits C={c}, halo={halo} "
                         f"in {limit} bytes of shared memory")
    one_pass = _THREADS // 32 * _MMA_NT * 8 * _mma_m_tiles(c) // (c // 16)
    return next((t for t in fits if t + 2 * halo <= one_pass), fits[-1])


def wgmma_configs(x: torch.Tensor, halo: int, tile_max: int, tier: int, taps: int = 11):
    """Every (tile, ring, chunk) the wgmma stage can launch for x (B, C, N)
    at this halo, with convs of at most `taps` taps: a window of at most
    256 lanes, a tile of at most `tile_max`, `ring` weight slots (_RINGS) of
    `chunk` taps each (_CHUNKS, at most `taps`) that fit in shared memory
    with it. Tiles: those whose window fills 1-4 warpgroups' 64 lanes
    exactly (64*g - 2*halo), and `tile_max` itself. Largest tile first."""
    c = x.shape[1]
    limit = _smem_limit(x)
    tiles = sorted({64 * g - 2 * halo for g in (1, 2, 3, 4)} | {tile_max}, reverse=True)
    chunks = sorted({min(ch, taps) for ch in _CHUNKS}, reverse=True)
    return [(t, r, ch) for t in tiles if 0 < t <= tile_max and t + 2 * halo <= _WINDOW
            for r in _RINGS for ch in chunks
            if _smem_bytes(c, t, halo, False, tier, r, ch) <= limit]


def _pick_tile(x: torch.Tensor, halo: int, mean: bool, tile_max: int, tier: int,
               taps: int = 11):
    """(time tile, weight slots, taps a slot holds) for the kernel; the
    output depends on none of them. "highest": `_tf32_tile`, and no ring
    (0, 0). "high"/"default" (the wgmma stage): of `wgmma_configs`, the
    tile with the fewest waves of blocks (one block per SM) times
    warpgroups with lanes in the window (the four share the SM's tensor
    cores), the larger tile on a tie; then the fewest chunks a conv of
    `taps` taps takes (each chunk is a wait of every warp, which costs
    more than the products at these widths: `tools/resblock_probe.py
    --sweep`), with 2 slots and the smallest chunk that does it. At K2's
    and K3's widest branch (halo 60) that is tile 136, a window of 256
    lanes, at B=1 (128 frames) and at the serving batch (B=32, T=192)."""
    if tier == 0:
        return _tf32_tile(x, halo, mean, tile_max), 0, 0
    b, c, n = x.shape
    configs = wgmma_configs(x, halo, tile_max, tier, taps)
    if not configs:
        raise ValueError(f"the wgmma stage takes a window of at most {_WINDOW} lanes and its "
                         f"planes and weight slots in shared memory: no time tile <= "
                         f"{tile_max} fits C={c}, halo={halo}")
    sms = getattr(torch.cuda.get_device_properties(x.device), "multi_processor_count", _SMS)

    def cost(config):
        t, ring, chunk = config
        return (-(-(b * -(-n // t)) // sms) * -(-(t + 2 * halo) // 64), -t, -(-taps // chunk),
                ring, chunk)

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
    if tier and c not in _WGMMA_WIDTHS:
        raise ValueError(f"C={c}: the wgmma stage of the {TIERS[tier]!r} tier takes C of "
                         f"16, 32 or 64")
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


def _swizzle_on(c: int, device: torch.device) -> torch.Tensor:
    """`_swizzle_columns(c)` on `device`, made once per (c, device)."""
    key = (c, str(device))
    if key not in _SWIZZLE_CACHE:
        _SWIZZLE_CACHE[key] = _swizzle_columns(c).to(device)
    return _SWIZZLE_CACHE[key]


def _swizzle_columns(c: int) -> torch.Tensor:
    """(C, C) int64: at (row co, column pos) of a tap's B image, the input
    channel stored there. The row's 16-byte chunk q (8 channels) sits at
    chunk q ^ ((co * 2C / 128) % (C / 8)): wgmma's 128-, 64- or 32-byte
    swizzle for rows of 2C bytes (C = 64, 32, 16), an involution."""
    co = torch.arange(c)[:, None]
    pos = torch.arange(c)[None, :]
    return ((pos // 8) ^ ((co * c // 64) % (c // 8))) * 8 + pos % 8


def wgmma_weights(w: torch.Tensor, tier: int) -> torch.Tensor:
    """The wgmma stage's weights: (M, C_out, C_in, K) -> (M, K, P, C, C)
    bf16, per (conv, tap) the shared-memory image of wgmma's B operand,
    K-major (row co holds its C_in weights) with the swizzle of
    `_swizzle_columns`; each (conv, tap) is one bulk copy of P planes:
    precision.split_bf16's hi and lo parts (P = 2, tier 1 "high") or
    bf16(w) (P = 1, tier 2 "default"), from fp32 or, at "default", bf16
    weights. Square C of 16, 32 or 64, whose rows are one swizzle wide."""
    m, co, ci, k = w.shape
    if co != ci or co % 16:
        raise ValueError(f"the wgmma stage takes square weights with C a multiple of 16, got "
                         f"C_out={co}, C_in={ci}")
    if co not in _WGMMA_WIDTHS:
        raise ValueError(f"the wgmma stage takes C of 16, 32 or 64, got {co}")
    hi = w.to(torch.bfloat16)  # split_bf16's hi; lo is what it leaves, rounded
    parts = torch.stack((hi, (w - hi.float()).to(torch.bfloat16))) if tier == 1 else hi[None]
    return wgmma_image(parts)


def wgmma_image(parts: torch.Tensor) -> torch.Tensor:
    """(P, M, C, C, K) -> (M, K, P, C, C), any dtype: each (conv, tap,
    plane) tile's rows permuted by `_swizzle_columns`. A permutation of the
    values."""
    p, m, co, ci, k = parts.shape
    cols = _swizzle_on(co, parts.device).expand(m, k, p, co, ci)
    return torch.gather(parts.permute(1, 4, 0, 2, 3), 4, cols)


def tf32_fragments(w: torch.Tensor) -> torch.Tensor:
    """(M, C_out, C_in, K) -> (M, K, C_in/8, C_out/16, 32, 4): per (conv,
    tap, 8 input channels, 16 output channels) the A operand of
    mma.m16n8k8.tf32 in its fragment order, lane-major, 4 values per lane.
    Lane 4*g + t holds rows (output channels) g and g + 8, columns (input
    channels) t and t + 4, as the registers a0..a3 take them: (g, t),
    (g+8, t), (g, t+4), (g+8, t+4). Any dtype; a permutation of w's values."""
    m, co, ci, k = w.shape
    if co % 16 or ci % 8:
        raise ValueError(f"tf32 A fragments take C_out a multiple of 16 and C_in of 8, "
                         f"got {co}, {ci}")
    # co = 16*mt + 8*rh + g, ci = 8*kc + 4*ch + t; register rh + 2*ch
    t = w.reshape(m, co // 16, 2, 8, ci // 8, 2, 4, k)
    return t.permute(0, 7, 4, 1, 3, 6, 5, 2).reshape(m, k, ci // 8, co // 16, 32, 4)


def tf32_weights(w: torch.Tensor) -> torch.Tensor:
    """The "highest" tier's weights: (2, M, K, C_in/8, C_out/16, 32, 4) fp32,
    the A fragments of precision.split_tf32's big and small parts."""
    frags = tf32_fragments(torch.stack(split_tf32(w)).flatten(0, 1))
    return frags.reshape(2, *w.shape[:1], *frags.shape[1:])


def _kernel_weights(w1s, b1s, w2s, b2s, tier: int):
    """The weights in the kernel's layout for the tier: the conv weights as
    tf32 A fragments at "highest" (tf32_weights), as the wgmma stage's
    bulk-copied image at "high" and "default" (wgmma_weights, from fp32
    or, at "default", bf16 weights); the biases as they are."""
    if tier == 0:
        w1t, w2t = tf32_weights(w1s), tf32_weights(w2s)
    else:  # both convs' images in one pass
        both = wgmma_weights(torch.cat((w1s, w2s)), tier)
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
