"""HiFi-GAN ResBlock1 kernels: one branch (K2) and the whole MRF stage (K3).

Counterparts of piper_tpu.ops.pallas.resblock.pallas_resblock1_branch and
pallas_resblock1_mrf. The kernels are CUDA C++ for Hopper
(`csrc/resblock1.cu`, whose header says what bounds them on the H100 and
how the design answers it); each sits beside its plain PyTorch version.

Contract, as on the TPU: a branch is y = x; for d in dilations:
y += conv2(act(conv1_d(act(y)))), with conv1 dilated, conv2 dense, both
same-padded with bias, and act = leaky ReLU then the row's [lo, hi) mask.
The result is exactly zero outside [lo, hi). `bounds` is (B,) meaning
[0, hi) or (B, 2) meaning [lo, hi), at this level's sample rate; it is
clamped to [0, N]. `precision` is the tier of the convs' products
(`precision.py`); the activation, mask, bias and fp32 sums do not change.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. Each wrapper's `launches` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from piper_tpu_torch.ops.kernels.precision import tier_code, tiered_conv1d
from piper_tpu_torch.ops.nn import leaky_relu

_SMEM_LIMIT = 232448  # dynamic shared memory one block may opt into on the H100
_THREADS = 512
_MAX_BRANCHES = 4
_MAX_DILS = 4


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
    """Plain PyTorch K2: unfused F.conv1d with the kernel's mask semantics.
    `tile` is accepted for signature parity and has no effect."""
    b, _, n = x.shape
    mask = _mask(_bounds_array(bounds, b, n, x.device), n)
    return resblock1_chain_plain(x, w1s, b1s, w2s, b2s, kernel, dilations, mask, slope,
                                 precision) * mask


def resblock1_mrf_plain(x, branches: Sequence[tuple], *, bounds=None,
                        slope: float = 0.1, tile: int = 256,
                        precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch K3: the mean of the branches, masked.
    `branches` holds (w1s, b1s, w2s, b2s, kernel, dilations) per branch."""
    b, _, n = x.shape
    mask = _mask(_bounds_array(bounds, b, n, x.device), n)
    acc = None
    for (w1s, b1s, w2s, b2s, k, dils) in branches:
        y = resblock1_chain_plain(x, w1s, b1s, w2s, b2s, k, dils, mask, slope, precision)
        acc = y if acc is None else acc + y
    return acc / len(branches) * mask


def _smem_bytes(c: int, tile: int, halo: int, mean: bool) -> int:
    return 4 * (3 * c * (tile + 2 * halo) + (c * tile if mean else 0))


def _pick_tile(x: torch.Tensor, halo: int, mean: bool, tile_max: int) -> int:
    """Largest time tile (256/128/64/32, at most `tile_max`) whose buffers fit
    in shared memory and whose window (tile + 2*halo samples) fits in one
    pass of the block's threads (each covers 4 samples of 8 channels); else
    the smallest that fits. Measured on the H100 at the medium voice's
    shapes: a smaller tile to fill more SMs loses to the halo it recomputes.
    The output does not depend on the tile."""
    c = x.shape[1]
    props = torch.cuda.get_device_properties(x.device)
    limit = getattr(props, "shared_memory_per_block_optin", _SMEM_LIMIT)
    fits = [t for t in (256, 128, 64, 32)
            if t <= tile_max and _smem_bytes(c, t, halo, mean) <= limit]
    if not fits:
        raise ValueError(f"no time tile <= {tile_max} fits C={c}, halo={halo} "
                         f"in {limit} bytes of shared memory")
    one_pass = _THREADS // (c // 8) * 4
    return next((t for t in fits if t + 2 * halo <= one_pass), fits[-1])


def _check_cuda_args(x: torch.Tensor, tensors: Sequence[torch.Tensor],
                     k: int, dilations: Sequence[int]) -> None:
    if x.dtype != torch.float32 or not x.is_contiguous() or x.ndim != 3:
        raise ValueError("x must be a contiguous float32 (B, C, N) tensor, got "
                         f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    c = x.shape[1]
    if c % 8 or _THREADS % (c // 8):
        raise ValueError(f"C={c}: the kernel takes C a multiple of 8 with C/8 dividing {_THREADS}")
    if k % 2 == 0 or not 1 <= len(dilations) <= _MAX_DILS:
        raise ValueError(f"kernel {k} must be odd with 1..{_MAX_DILS} dilations")
    m = len(dilations)
    w1s, b1s, w2s, b2s = tensors
    for name, t, shape in (("w1s", w1s, (m, c, c, k)), ("b1s", b1s, (m, c)),
                           ("w2s", w2s, (m, c, c, k)), ("b2s", b2s, (m, c))):
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _kernel_weights(w1s, b1s, w2s, b2s):
    """(M, C_out, C_in, K) -> (M, C_in, K, C_out): the kernel reads 8 output
    channels of one (input channel, tap) as two float4 loads."""
    out = (w1s.permute(0, 2, 3, 1).contiguous(), b1s.contiguous(),
           w2s.permute(0, 2, 3, 1).contiguous(), b2s.contiguous())
    if out[0].data_ptr() % 16 or out[2].data_ptr() % 16:
        raise ValueError("transposed conv weights must be 16-byte aligned")
    return out


def _stream(x: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def resblock1_branch(x, w1s, b1s, w2s, b2s, *, kernel: int,
                     dilations: Sequence[int], bounds=None, slope: float = 0.1,
                     tile: int = 256, precision: str = "highest") -> torch.Tensor:
    """One ResBlock1 branch: returns y after all (conv1, conv2, +) stages.

    x (B, C, N); w1s/w2s (M, C, C, K); b1s/b2s (M, C). `tile` caps the
    kernel's time tile (the result does not depend on it)."""
    if x.device.type == "cpu":
        return resblock1_branch_plain(x, w1s, b1s, w2s, b2s, kernel=kernel,
                                      dilations=dilations, bounds=bounds,
                                      slope=slope, tile=tile, precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"resblock1_branch runs on cpu or cuda, not {x.device}")
    tier = tier_code(precision)
    _check_cuda_args(x, (w1s, b1s, w2s, b2s), kernel, dilations)
    from piper_tpu_torch.ops.kernels import build

    lib = build.load()
    b, c, n = x.shape
    bnd = _bounds_array(bounds, b, n, x.device)
    w1t, b1c, w2t, b2c = _kernel_weights(w1s, b1s, w2s, b2s)
    t = _pick_tile(x, branch_halo(kernel, dilations), False, tile)
    out = torch.empty_like(x)
    dils = (ctypes.c_int * len(dilations))(*dilations)
    code = lib.piper_resblock1_branch(
        x.data_ptr(), w1t.data_ptr(), b1c.data_ptr(), w2t.data_ptr(), b2c.data_ptr(),
        kernel, len(dilations), ctypes.cast(dils, ctypes.c_void_p), bnd.data_ptr(),
        out.data_ptr(), b, c, n, t, slope, tier, x.device.index or 0, _stream(x))
    build.check(lib, code, "piper_resblock1_branch")
    resblock1_branch.launches += 1
    return out


resblock1_branch.launches = 0


def mrf_launch_args(x, branches: Sequence[tuple], tile: int) -> tuple:
    """Check the MRF `branches` against x (B, C, N) and build the per-branch
    arguments of the MRF C entries: returns (time tile, the arguments from
    n_branches to dils, what must stay alive until the call returns)."""
    nb = len(branches)
    if not 1 <= nb <= _MAX_BRANCHES:
        raise ValueError(f"the MRF kernel takes 1..{_MAX_BRANCHES} branches, got {nb}")
    ks, dils_list, weights = [], [], []
    for (w1s, b1s, w2s, b2s, k, dils) in branches:
        _check_cuda_args(x, (w1s, b1s, w2s, b2s), int(k), dils)
        ks.append(int(k))
        dils_list.append([int(d) for d in dils])
        weights.append(_kernel_weights(w1s, b1s, w2s, b2s))
    halo = max(branch_halo(k, d) for k, d in zip(ks, dils_list))
    t = _pick_tile(x, halo, True, tile)
    arrays = [(ctypes.c_void_p * nb)(*[w[i].data_ptr() for w in weights]) for i in range(4)]
    arrays += [(ctypes.c_int * nb)(*ks), (ctypes.c_int * nb)(*[len(d) for d in dils_list]),
               (ctypes.c_int * (nb * _MAX_DILS))(
                   *[d[j] if j < len(d) else 0 for d in dils_list for j in range(_MAX_DILS)])]
    args = (nb, *[ctypes.cast(a, ctypes.c_void_p) for a in arrays])
    return t, args, (arrays, weights)


def resblock1_mrf(x, branches: Sequence[tuple], *, bounds=None, slope: float = 0.1,
                  tile: int = 256, precision: str = "highest") -> torch.Tensor:
    """The whole multi-receptive-field stage: every ResBlock1 branch and
    their mean. `branches` holds (w1s, b1s, w2s, b2s, kernel, dilations)."""
    if x.device.type == "cpu":
        return resblock1_mrf_plain(x, branches, bounds=bounds, slope=slope,
                                   tile=tile, precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"resblock1_mrf runs on cpu or cuda, not {x.device}")
    tier = tier_code(precision)
    t, args, _keep = mrf_launch_args(x, branches, tile)
    from piper_tpu_torch.ops.kernels import build

    lib = build.load()
    b, c, n = x.shape
    bnd = _bounds_array(bounds, b, n, x.device)
    out = torch.empty_like(x)
    code = lib.piper_resblock1_mrf(x.data_ptr(), *args, bnd.data_ptr(), out.data_ptr(),
                                   b, c, n, t, slope, tier, x.device.index or 0, _stream(x))
    build.check(lib, code, "piper_resblock1_mrf")
    resblock1_mrf.launches += 1
    return out


resblock1_mrf.launches = 0
