"""Inverse piecewise rational-quadratic spline with linear tails.

Counterpart of piper_tpu.ops.spline.rational_quadratic_spline(inverse=True),
the only direction inference runs (the stochastic duration predictor's
reverse ConvFlow). Vectorized and finite even on masked garbage lanes:
out-of-interval inputs take the identity tail.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _knots(unnormalized: torch.Tensor, lo: float, hi: float, min_bin: float):
    """Softmax bin sizes -> (knot positions incl. both edges, bin sizes)."""
    num_bins = unnormalized.shape[-1]
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_bin + (1.0 - min_bin * num_bins) * sizes
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (hi - lo) * cum + lo
    cum = torch.cat([torch.full_like(cum[..., :1], lo), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], hi)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline_inverse(
    x: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    *,
    tail_bound: float = 5.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> torch.Tensor:
    """Invert the spline elementwise.

    x: (...,); unnormalized_{widths,heights}: (..., num_bins);
    unnormalized_derivatives: (..., num_bins - 1). Identity outside
    [-tail_bound, tail_bound], where the edge derivatives are fixed to 1.
    """
    num_bins = unnormalized_widths.shape[-1]
    inside = (x >= -tail_bound) & (x <= tail_bound)

    constant = math.log(math.expm1(1.0 - min_derivative))
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    cumwidths, widths = _knots(unnormalized_widths, -tail_bound, tail_bound, min_bin_width)
    cumheights, heights = _knots(unnormalized_heights, -tail_bound, tail_bound, min_bin_height)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    # Clamp so masked/tail lanes stay finite; select at the end.
    x_in = x.clamp(-tail_bound, tail_bound)
    bin_idx = (x_in[..., None] >= cumheights[..., :-1]).sum(dim=-1) - 1
    bin_idx = bin_idx.clamp(0, num_bins - 1)[..., None]

    def g(arr):
        return arr.gather(-1, bin_idx)[..., 0]

    in_cw, in_w = g(cumwidths), g(widths)
    in_ch, in_h = g(cumheights), g(heights)
    in_d = g(derivatives[..., :-1])
    in_d1 = derivatives.gather(-1, bin_idx + 1)[..., 0]
    delta = in_h / in_w  # bin slope

    term = (x_in - in_ch) * (in_d + in_d1 - 2.0 * delta)
    a = term + in_h * (delta - in_d)
    b = in_h * in_d - term
    c = -delta * (x_in - in_ch)
    disc = (b * b - 4.0 * a * c).clamp_min(0.0)
    root = (2.0 * c) / (-b - torch.sqrt(disc))
    return torch.where(inside, root * in_w + in_cw, x)
