"""Precision tiers of the vocoder kernels and of the ops around them.

Counterpart of piper_tpu.ops.pallas.conv.mxu_dot and
piper_tpu.models.vits.hifigan._pallas_precision. A kernel's tier changes
only the products of its convs; activations, masks, bias and the fp32
accumulation stay as they are:

  "highest" (or None)      fp32 products;
  "high"                   bf16x3: x = x_hi + x_lo and w = w_hi + w_lo, each
                           part a bf16 value, and the sum of x_hi*w_hi,
                           x_lo*w_hi and x_hi*w_lo (lo*lo dropped);
  "default" (or "bfloat16") one product of the bf16-rounded x and w.

Every product of two bf16 values is exact in fp32, so at "high" and
"default" a kernel and its plain version differ only in the order of their
fp32 sums. At "highest" the plain version's products are fp32; K1-K4 form
them on the tensor cores as 3xTF32 (`split_tf32`: big*big + big*small +
small*big), which drops about 2^-21 of each product besides the order of
the sums.

Outside the kernels a tier scopes what PyTorch may do with fp32 convs and
matmuls on the card, as JAX's default_matmul_precision names its tiers by
their GPU meaning ("high" is tensorfloat32, "default" bfloat16): "highest"
is full fp32, "high" fp32 convs and TF32 matmuls, "default" TF32 for cuDNN
(which has no bf16 mode for fp32 convs) and the "medium" matmul precision.
"high" keeps cuDNN's convs in fp32 because the reference's "high" is the
3-pass bf16 split, about 16 mantissa bits, where TF32 keeps 10: on the
H100 each decode stage's convs alone in TF32 land 2.5e-4 to 4.2e-4 from
fp32, about 7.6e-4 together, against the mixed tiers' 1e-3 gate
(`tools/calibrate_precision.py`, PERF.md). cuDNN has no bf16x3 mode, so
the vocoder's square ResBlock convs of 128 to 256 channels (a high voice's
levels 0 and 1) do not go to it on the card: at "highest" and "high" they
run K1's wide design (`conv.py`, `csrc/conv1d_wide.cu`), at the tier's own
products like every other ResBlock conv; what stays with cuDNN in fp32 at
"high" is the flows, conv_pre, the conv-transposes and conv_post. On the
CPU a scope changes nothing, as JAX's does not there.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
import torch.nn.functional as F

TIERS = ("highest", "high", "default")  # index = the tier code the C entries take
_KERNEL_TIER = {None: "highest", "highest": "highest", "high": "high",
                "default": "default", "bfloat16": "default"}
_MATMUL = {"highest": "highest", "high": "high", "default": "medium"}


def kernel_tier(precision: Optional[str], what: str = "precision") -> str:
    """The kernel tier of a level's precision, as _pallas_precision maps it:
    None means "highest"; "bfloat16" is "default". Raises on anything else,
    naming the option as `what`."""
    try:
        return _KERNEL_TIER[precision]
    except (KeyError, TypeError):
        raise ValueError(f"{what} {precision!r}: the tiers are 'highest' (or None), "
                         f"'high' and 'default' (or 'bfloat16')") from None


def tier_code(precision: Optional[str]) -> int:
    """The integer the C entries take: 0 highest, 1 high, 2 default."""
    return TIERS.index(kernel_tier(precision))


def split_bf16(x: torch.Tensor):
    """(hi, lo) as fp32 tensors holding bf16 values, x ~ hi + lo."""
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    return hi, lo


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (fp32): 2^(floor(log2|x|) - 7) for
    normal values, the smallest normal's spacing at and below it."""
    m = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| over the bf16 ulp at max(|a|, |b|): 0 for equal
    tensors, at most 1 where each element is equal or one bf16 step apart."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() / bf16_ulp(torch.maximum(a.abs(), b.abs()))).max())


def split_tf32(x: torch.Tensor):
    """(big, small) as fp32 tensors holding tf32 values (the low 13 mantissa
    bits zero), x ~ big + small within 2^-22 of |x| (2^-137 where a part is
    subnormal): big = rna(x), small =
    rna(x - big), where rna rounds to tf32 to nearest with ties away from
    zero on the int32 bit pattern, as the card's cvt.rna.tf32.f32 does."""
    big = _rna_tf32(x)
    return big, _rna_tf32(x - big)


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    # Half an ulp of tf32 added to the magnitude bits, then the 13 low bits
    # cut: ties round away from zero, and the carry may bump the exponent.
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tiered_conv1d(x, w, b=None, *, padding: int = 0, dilation: int = 1,
                  precision: Optional[str] = "highest") -> torch.Tensor:
    """F.conv1d with mxu_dot's products at `precision`, fp32 sums, the bias
    added after. The plain version of every kernel's conv."""
    tier = kernel_tier(precision)
    conv = functools.partial(F.conv1d, padding=padding, dilation=dilation)
    if tier == "highest":
        return conv(x, w, b)
    if tier == "high":
        (x_hi, x_lo), (w_hi, w_lo) = split_bf16(x), split_bf16(w)
        out = conv(x_hi, w_hi) + conv(x_lo, w_hi) + conv(x_hi, w_lo)
    else:
        out = conv(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float())
    return out if b is None else out + b[:, None]


@contextlib.contextmanager
def _torch_flags(tf32_conv: bool, matmul: str):
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, torch.get_float32_matmul_precision())
    cudnn.allow_tf32 = tf32_conv
    torch.set_float32_matmul_precision(matmul)
    try:
        yield
    finally:
        cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def fp32_exact():
    """TF32 off for matmuls and cuDNN convs within the block, restored after."""
    return _torch_flags(False, "highest")


def tier_scope(precision: Optional[str], device):
    """PyTorch's fp32 conv and matmul precision at `precision` within the
    block, on a CUDA device: TF32 convs only at "default", TF32 matmuls
    at "high" and "default"; None (inherit the outer tier) and the CPU
    leave everything as it is."""
    if precision is None:
        return contextlib.nullcontext()
    tier = kernel_tier(precision)
    if torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return _torch_flags(tier == "default", _MATMUL[tier])
