"""JAX's threefry-2x32 generator, and the seeded noise draw on the card.

The JAX package draws every seeded noise tensor with `jax.random` (the
threefry-2x32 generator of Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC 2011, with `jax_threefry_partitionable` on, JAX's
default): keys, `fold_in`, bits, uniforms and normals. This module computes
the same numbers in PyTorch:

- `prng_key(seed)` = (0, seed mod 2^32), `jax.random.PRNGKey` of a uint32;
- `threefry2x32(key, x0, x1)`: 20 rounds of add, rotate and xor, rotations
  (13, 15, 26, 6) / (17, 29, 16, 24), a key injection every 4 rounds, the
  third key word k0 ^ k1 ^ 0x1BD11BDA;
- `fold_in(key, d)` = threefry2x32(key, 0, d mod 2^32);
- `random_bits(key, n)`: element i is x0 ^ x1 of threefry2x32(key, i >> 32,
  i mod 2^32) (the partitionable counter layout);
- `uniform(key, shape, minval, maxval)`: max(minval, f * (maxval - minval)
  + minval), f = bitcast((bits >> 9) | 0x3F800000) - 1, in fp32;
- `normal(key, shape)`: sqrt(2) * erf_inv(u), u = uniform(key, shape,
  nextafter(-1, 0), 1), with XLA's fp32 ErfInv (`erf_inv`: M. Giles'
  single-precision polynomial, as XLA evaluates it; torch.erfinv is
  another approximation, ~2e-5 apart).

Keys and bits are bit-equal to JAX's; the uniforms too (every step is one
correctly rounded fp32 operation); the normals differ from JAX's only where
log1p or a Horner step rounds differently (XLA's CPU code against
PyTorch's): one ulp of the result in about 1% of the elements, 4.8e-7 at
most over (192, 1000) draws (an ulp at |z| ~ 4). The integer arithmetic runs on
int64 tensors holding values in [0, 2^32), masked after every add and
shift (PyTorch has no full uint32 arithmetic, and `>>` of a negative int64
is arithmetic, so every operand of a right shift is non-negative here).

`threefry_normal` is the seeded draw the port's noise paths make (the
runtime's duration and prior noise, `model.per_frame_noise` and
`per_row_frame_noise`): out[r, c, w] is element i of normal(key) with

    key = fold_in(fold_in(prng_key(seed), stream), frame[r, w])   (frames)
    key = fold_in(prng_key(seed), stream)                          (no frames)

where `seed` is one seed for the whole draw (i = r * n + c: the rows of one
draw, JAX's normal(key, (rows, n)) or per_frame_noise's (b, ch) at a frame)
or one seed per row (i = c: each row its own draw, JAX's vmap over rows).

This replaces no TPU kernel: the JAX package leaves threefry to XLA. On the
card it is one kernel, `piper_threefry_normal` (`csrc/threefry.cu`, whose
header says what bounds it), because its plain version is some 150
elementwise launches a draw and the port's B=1 path is bound by launches.

Dispatch: a CPU tensor (or a host seed drawn for the CPU) runs the plain
version; on the card the wrapper launches the kernel or raises.
`threefry_normal.launches` counts its launches.
"""

from __future__ import annotations

import ctypes
import math
import numbers
from typing import Optional, Sequence, Union

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# XLA's ErfInv32 (M. Giles, "Approximating the erfinv function"): the
# coefficients for w = -log1p(-x^2) < 5 (in w - 2.5) and otherwise (in
# sqrt(w) - 3), highest power first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_NORMAL_LO = -1.0 + 2.0 ** -24  # nextafter(-1, 0) in fp32: the normal's uniform floor
OUTPUTS = ("normal", "uniform", "bits")  # what threefry_normal returns (its kernel's `kind`)

Seed = Union[int, torch.Tensor, Sequence[int]]


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & M32) | (v >> (32 - r))


def threefry2x32(key: torch.Tensor, x0, x1):
    """threefry2x32 of the counter pair (x0, x1) under key (..., 2) (int64
    tensors of uint32 values, broadcast together): the pair (y0, y1)."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed, device=None) -> torch.Tensor:
    """jax.random.PRNGKey of a uint32 seed: (0, seed mod 2^32), int64 (..., 2).
    `seed` is an int or an integer tensor (one key per element)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in(key, data): threefry2x32(key, 0, data mod 2^32).
    `data` is an int or an integer tensor broadcast against key[..., 0]."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    y0, y1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _bits(key: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """The 32 random bits of each counter (int64, < 2^64) under key (..., 2),
    broadcast: x0 ^ x1 of threefry2x32(key, hi, lo)."""
    y0, y1 = threefry2x32(key, counters >> 32, counters & M32)
    return y0 ^ y1


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.bits(key, (n,)) for key (..., 2): (..., n) int64 in [0, 2^32)."""
    counters = torch.arange(n, dtype=torch.int64, device=key.device)
    return _bits(key[..., None, :], counters)


def _uniform_from_bits(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """jax.random.uniform's fp32 steps from 32-bit draws: the top 23 bits as
    a mantissa in [1, 2), minus 1, scaled and shifted, floored at minval."""
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=bits.device) - lo
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.maximum(lo, f * span + lo)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 ErfInv: w = -log1p(-x^2); p is the degree-8 polynomial of
    w - 2.5 (w < 5) or of sqrt(w) - 3 (otherwise), by Horner's rule; p * x,
    and +-inf at |x| = 1. Each Horner step is one fused multiply-add, as
    XLA's CPU code contracts it (and the kernel's fmaf): the exact product
    and sum in float64, rounded once to fp32 (against two roundings, 4.7%
    of JAX's normals differ by an ulp instead of 0.9%)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    table = torch.tensor((_ERFINV_LT5, _ERFINV_GE5), dtype=torch.float32, device=x.device)
    which = (~lt).to(torch.int64)
    p = table[:, 0][which]
    for i in range(1, len(_ERFINV_LT5)):
        p = (p.double() * w + table[:, i][which].double()).float()
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _normal_from_uniform(u: torch.Tensor) -> torch.Tensor:
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32, device=u.device)
    return sqrt2 * erf_inv(u)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval) for key (..., 2):
    (..., *shape)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    bits = random_bits(key, math.prod(shape))
    return _uniform_from_bits(bits, minval, maxval).reshape(*key.shape[:-1], *shape)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.normal(key, shape, float32) for key (..., 2): (..., *shape)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    bits = random_bits(key, math.prod(shape))
    u = _uniform_from_bits(bits, _NORMAL_LO, 1.0)
    return _normal_from_uniform(u).reshape(*key.shape[:-1], *shape)


# -- the seeded draw -------------------------------------------------------------


def _per_row(seed: Seed) -> bool:
    """One seed per row (a sequence or a 1-d tensor), or one for the draw."""
    if isinstance(seed, torch.Tensor):
        return seed.ndim == 1
    return not isinstance(seed, numbers.Integral)


def _draw_device(seed: Seed, frames: Optional[torch.Tensor], device) -> torch.device:
    if frames is not None:
        return frames.device
    if isinstance(seed, torch.Tensor) and device is None:
        return seed.device
    return torch.device("cpu" if device is None else device)


def threefry_normal_plain(seed: Seed, stream: int, rows: int, n: int,
                          frames: Optional[torch.Tensor] = None, *, device=None,
                          output: str = "normal") -> torch.Tensor:
    """Plain PyTorch version of threefry_normal (same arguments and result),
    on any device."""
    dev = _draw_device(seed, frames, device)
    per_row = _per_row(seed)
    s = torch.as_tensor(seed, dtype=torch.int64).to(dev).reshape(-1)
    key = fold_in(prng_key(s), stream)  # (S, 2): S = rows, or 1
    if frames is None:
        key = key[:, None, :]  # (S, 1, 2)
    else:
        f = frames.to(device=dev, dtype=torch.int64).reshape(rows if per_row else 1, -1)
        key = fold_in(key[:, None, :], f)  # (S, W, 2)
    counters = torch.arange(n if per_row else rows * n, dtype=torch.int64, device=dev)
    counters = counters.view(1 if per_row else rows, n, 1)
    bits = _bits(key[:, None, :, :], counters).expand(rows, n, key.shape[1])
    if output == "bits":
        out = bits
    else:
        u = _uniform_from_bits(bits, _NORMAL_LO, 1.0)
        out = u if output == "uniform" else _normal_from_uniform(u)
    return out.contiguous() if frames is not None else out[..., 0].contiguous()


def _check(seed: Seed, rows: int, n: int, frames: Optional[torch.Tensor], output: str) -> None:
    if output not in OUTPUTS:
        raise ValueError(f"output must be one of {OUTPUTS}, got {output!r}")
    if rows < 1 or n < 1:
        raise ValueError(f"a draw needs rows >= 1 and n >= 1, got ({rows}, {n})")
    per_row = _per_row(seed)
    if per_row and len(seed) != rows:
        raise ValueError(f"{len(seed)} seeds for {rows} rows")
    if isinstance(seed, torch.Tensor) and (seed.ndim > 1 or seed.is_floating_point()):
        raise ValueError(f"seed must be an integer scalar or (rows,) tensor, got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    if frames is not None:
        want = 2 if per_row else 1
        if frames.ndim != want or (per_row and frames.shape[0] != rows):
            raise ValueError(f"frames must be ({'rows, ' if per_row else ''}W) for "
                             f"{'per-row seeds' if per_row else 'one seed'}, got "
                             f"{tuple(frames.shape)}")
        if frames.is_floating_point():
            raise ValueError(f"frames must be integers, got {frames.dtype}")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def threefry_normal(seed: Seed, stream: int, rows: int, n: int,
                    frames: Optional[torch.Tensor] = None, *, device=None,
                    output: str = "normal") -> torch.Tensor:
    """The seeded draw: (rows, n) standard normals, or (rows, n, W) with
    `frames`, as the module docstring defines them (JAX's numbers).

    seed: an int or a 0-d integer tensor (one seed: element (r, c) is
    counter r * n + c of one key), or a (rows,) integer tensor or sequence
    (one seed per row: counter c of row r's key); every seed is taken mod
    2^32. stream: folded into PRNGKey(seed) first (the runtime's 0 for the
    duration noise, 1 for the prior). frames: (W,) for one seed or (rows,
    W) for per-row seeds, integer absolute frame indices (any sign, folded
    mod 2^32). The draw lands on frames' device, else seed's (a tensor),
    else `device` (default cpu). `output` "uniform" returns the normal's
    fp32 uniforms in [nextafter(-1, 0), 1), "bits" its 32-bit draws (int64);
    both are bit-equal between the kernel and the plain version."""
    _check(seed, rows, n, frames, output)
    dev = _draw_device(seed, frames, device)
    if dev.type == "cpu":
        return threefry_normal_plain(seed, stream, rows, n, frames, device=dev, output=output)
    if dev.type != "cuda":
        raise ValueError(f"threefry_normal runs on cpu or cuda, not {dev}")
    from piper_tpu_torch.ops.kernels import build

    width = 1 if frames is None else int(frames.shape[-1])
    if rows * n * width >= 2 ** 31:
        raise ValueError(f"a draw of {rows} x {n} x {width} elements: the kernel takes < 2^31")
    host_seed, seeds = 0, None
    if isinstance(seed, numbers.Integral):
        host_seed = int(seed) & M32
    else:
        seeds = torch.as_tensor(seed, dtype=torch.int64).to(dev).contiguous()
    fr = None if frames is None else frames.to(dtype=torch.int64).contiguous()
    if fr is not None and fr.device != dev:
        raise ValueError(f"frames on {fr.device}, the draw on {dev}")
    kind = OUTPUTS.index(output)
    out = torch.empty((rows, n, width), device=dev,
                      dtype=torch.int32 if output == "bits" else torch.float32)
    lib = build.load()
    code = lib.piper_threefry_normal(
        out.data_ptr(), rows, n, width, None if seeds is None else seeds.data_ptr(),
        host_seed, int(_per_row(seed)), int(stream) & M32,
        None if fr is None else fr.data_ptr(), kind, dev.index or 0, _stream(out))
    build.check(lib, code, "piper_threefry_normal")
    threefry_normal.launches += 1
    if output == "bits":
        out = out.to(torch.int64) & M32
    return out if frames is not None else out[..., 0]


threefry_normal.launches = 0
