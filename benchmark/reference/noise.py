"""JAX's threefry-2x32 normals in plain PyTorch: the seeded noise the
reference draws for itself.

Frozen copy of the plain draw in `piper_tpu_torch/ops/kernels/prng.py`
(`threefry2x32`, `prng_key`, `fold_in`, the partitionable bit layout,
`_uniform_from_bits`, `erf_inv`, `normal`) at commit 1fc906d, cut to what
the reference needs: one seed for a whole draw. Integer arithmetic runs on
int64 tensors holding values in [0, 2^32), masked after every add and
shift. Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# XLA's ErfInv32 (M. Giles): coefficients for w < 5 (in w - 2.5) and
# otherwise (in sqrt(w) - 3), highest power first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_NORMAL_LO = -1.0 + 2.0 ** -24  # nextafter(-1, 0) in fp32


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & M32) | (v >> (32 - r))


def threefry2x32(key: torch.Tensor, x0, x1):
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


def prng_key(seed: int, device) -> torch.Tensor:
    s = torch.tensor(int(seed) & M32, dtype=torch.int64, device=device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    y0, y1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _bits(key: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    y0, y1 = threefry2x32(key, counters >> 32, counters & M32)
    return y0 ^ y1


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    table = torch.tensor((_ERFINV_LT5, _ERFINV_GE5), dtype=torch.float32, device=x.device)
    which = (~lt).to(torch.int64)
    p = table[:, 0][which]
    for i in range(1, len(_ERFINV_LT5)):
        p = (p.double() * w + table[:, i][which].double()).float()
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    lo = torch.tensor(_NORMAL_LO, dtype=torch.float32, device=bits.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=bits.device) - lo
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.maximum(lo, f * span + lo)
    return torch.tensor(math.sqrt(2.0), dtype=torch.float32, device=bits.device) * _erf_inv(u)


def normal(seed: int, stream: int, shape, device) -> torch.Tensor:
    """jax.random.normal(fold_in(PRNGKey(seed), stream), shape) in fp32."""
    key = fold_in(prng_key(seed, device), stream)
    n = math.prod(shape)
    counters = torch.arange(n, dtype=torch.int64, device=device)
    return _normal_from_bits(_bits(key, counters)).reshape(tuple(shape))

