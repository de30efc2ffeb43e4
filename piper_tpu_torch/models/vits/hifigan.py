"""HiFi-GAN generator (the `dec.*` weights): latent frames -> waveform.

Counterpart of piper_tpu.models.vits.hifigan with its routing, the port
taking JAX's use_pallas=True throughout:

- a ResBlock1 level narrower than 128 channels, given per-row bounds (or no
  mask at all), goes through the fused resblock kernels: the whole-MRF
  kernel when it has at most 32 channels (PIPER_TPU_FUSE_MRF=1 at every
  such level, =0 at none), one branch kernel per branch otherwise;
- a branch (or the whole MRF) whose width or halo those kernels do not take
  (`resblock.stage_takes`: C not one of their tier's widths, or no time
  tile whose window fits) goes conv by conv through the conv1d_same
  kernel, which takes any square C below 128, each conv's input masked by
  the level's bounds and the branch's output by them, as the fused
  kernels mask it: where JAX runs its Pallas kernels, the port runs a
  kernel of its own, never cuDNN;
- every other resblock conv that is square and narrower than 128 channels
  (all convs of a ResBlock2 voice's narrow levels, and the unfused narrow
  ResBlock1 convs of a masked run without bounds) goes through the
  conv1d_same kernel: given the level's per-row bounds it masks its own
  input; without them it gets the mask applied to its input;
- the square resblock convs of the wide levels, 128 to 256 channels (levels
  0 and 1 of the `medium` preset, Piper's high class; level 0 of `x_low`,
  Piper's medium class), go through the
  conv1d_same kernel's wide design on a CUDA tensor of float32 at a level
  tier of "highest" (or None) or "high", masked as the narrow convs are
  (`k1_takes`). At "default" and on bf16 activations they stay PyTorch
  convs (cuDNN on TF32 or bf16 tensor cores, which are that tier's
  products or finer), and on a CPU tensor too, as the JAX reference leaves
  them to XLA, which ignores the tier on the CPU;
- every conv through conv1d_same adds its block's running sum in its
  epilogue (`residual`), bit-equal to adding it after;
- the upsampling and the pre/post convs are PyTorch convs.

On a CPU tensor the kernel wrappers run their plain versions, so the CPU
path is the unfused reference with the kernels' semantics.

`level_precisions` sets each upsample level's tier, as in JAX: the level's
kernels run at that tier (None meaning "highest", as _pallas_precision maps
it) and its PyTorch convs under tier_scope (None inheriting the caller's).
On bf16 activations (the runtime's "bfloat16" mode) a None level runs at
"bfloat16", which the kernels take as "default", the one tier they run on
bf16 activations.

While a per-layer trace collects (`utils/debug_trace.py`), every level
keeps its per-branch kernels in place of the fused MRF kernel, so that each
branch's output is recorded, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from piper_tpu_torch.models.vits.hparams import VitsHParams
from piper_tpu_torch.models.vits.params import Params, Prefix
from piper_tpu_torch.ops.conv import conv1d, conv1d_same, conv_transpose1d
from piper_tpu_torch.ops.kernels import conv as K1
from piper_tpu_torch.ops.kernels.precision import kernel_tier, tier_code, tier_scope
from piper_tpu_torch.ops.kernels.resblock import (_bounds_array, _mask, branch_halo,
                                                  resblock1_branch, resblock1_mrf, stage_takes)
from piper_tpu_torch.ops.nn import leaky_relu
from piper_tpu_torch.utils.debug_trace import trace_put, tracing
from piper_tpu_torch.utils.env import flag

LRELU_SLOPE = 0.1


def k1_takes(c_out: int, c_in: int, precision: Optional[str], dtype: torch.dtype,
             device) -> bool:
    """Whether `_lrelu_conv` runs a resblock conv of (c_out, c_in) channels
    through the conv1d_same kernel (K1) at the level tier `precision`: a
    square conv narrower than 128 channels on any device and dtype (the CPU
    runs K1's plain version, bf16 its "default" tier); a square conv of 128
    to 256 channels (K1's wide design) only on a CUDA tensor of float32 at
    "highest" (or None) or "high"."""
    if c_out != c_in:
        return False
    if c_out < 128:
        return True
    return (c_out <= K1.MAX_C and torch.device(device).type == "cuda"
            and dtype == torch.float32 and kernel_tier(precision) != "default")


def _lrelu_conv(x, w, b, *, dilation=1, t_mask=None, bounds=None, residual=None,
                precision=None, kernels=True):
    """(residual +) leaky_relu -> (mask ->) same-conv; through the K1 kernel
    at `precision` where `k1_takes`, the residual added in its epilogue. For
    a 0/1 mask lrelu(x * m) equals lrelu(x) * m, so the kernel masks its
    input: by `bounds` (B, 2), the rows' [lo, hi) of the same mask, inside
    the kernel, or else by a multiply by `t_mask` before it. kernels=False
    keeps every conv a PyTorch conv (JAX's use_pallas=False: its pipeline
    stages)."""
    if kernels and k1_takes(w.shape[0], w.shape[1], precision, x.dtype, x.device):
        xin = x if t_mask is None or bounds is not None else x * t_mask
        return K1.conv1d_same(xin, w, b, dilation=dilation, act_slope=LRELU_SLOPE,
                              bounds=bounds, residual=residual, precision=precision)
    xt = leaky_relu(x, LRELU_SLOPE)
    if t_mask is not None:
        xt = xt * t_mask
    xt = conv1d_same(xt, w, b, dilation=dilation)
    return xt if residual is None else residual + xt


def _add_conv(acc, name: str, record: bool, **conv):
    """acc + _lrelu_conv(**conv), the sum in the conv's epilogue; while a
    per-layer trace collects (and `record`), the conv's own output is
    recorded under `name` and added after."""
    if record and tracing():
        xt = _lrelu_conv(**conv)
        trace_put(name, xt)
        return acc + xt
    return _lrelu_conv(residual=acc, **conv)


def _resblock1(x, p: Prefix, dilations, t_mask=None, precision=None, kernels=True,
               bounds=None, record=True):
    """Multi-receptive-field residual block (HiFi-GAN ResBlock1), unfused;
    with `bounds` the K1 convs mask their inputs by them. `record` False
    keeps its convs out of a per-layer trace, as a fused branch's are."""
    same = dict(t_mask=t_mask, bounds=bounds, precision=precision, kernels=kernels)
    for m, d in enumerate(dilations):
        xt = _lrelu_conv(x, p[f"convs1.{m}.weight"], p[f"convs1.{m}.bias"], dilation=d, **same)
        if record:
            trace_put(f"{p.prefix}.convs1.{m}", xt)
        x = _add_conv(x, f"{p.prefix}.convs2.{m}", record, x=xt, w=p[f"convs2.{m}.weight"],
                      b=p[f"convs2.{m}.bias"], **same)
    return x


def _resblock2(x, p: Prefix, dilations, t_mask=None, bounds=None, precision=None,
               kernels=True):
    """Single-conv residual block (HiFi-GAN ResBlock2, Piper's x_low voices)."""
    for m, d in enumerate(dilations):
        x = _add_conv(x, f"{p.prefix}.convs.{m}", True, x=x, w=p[f"convs.{m}.weight"],
                      b=p[f"convs.{m}.bias"], dilation=d, t_mask=t_mask, bounds=bounds,
                      precision=precision, kernels=kernels)
    return x


def _stacked(rb: Prefix, n_d: int):
    """(w1s, b1s, w2s, b2s) of one ResBlock1 branch, each stacked over the
    dilations into one (M, ...) tensor, as the fused kernels take them."""
    return tuple(torch.stack([rb[f"{conv}.{m}.{kind}"] for m in range(n_d)])
                 for conv, kind in (("convs1", "weight"), ("convs1", "bias"),
                                    ("convs2", "weight"), ("convs2", "bias")))


def hifigan_generator(
    z: torch.Tensor,
    params: Params,
    hp: VitsHParams,
    g: Optional[torch.Tensor] = None,
    prefix: str = "dec",
    level_precisions: Optional[Union[str, Sequence[Optional[str]]]] = None,
    t_mask: Optional[torch.Tensor] = None,
    t_bounds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, C, T_frames) latent -> (B, 1, T_frames * hop_length) waveform.

    `level_precisions` is one tier for every upsample level or one entry
    per level; conv_pre runs at the first level's, conv_post at the last's.

    `t_mask` (B, 1, T_frames) zeroes activations outside the sequence before
    every conv, so the bucket padding behaves like the array's end.
    `t_bounds` gives each row's valid FRAME interval, (B,) [0, hi) or (B, 2)
    [lo, hi); with it the narrow ResBlock1 levels run the fused kernels,
    which apply the same masking per row. A ResBlock2 voice's narrow convs
    run the conv1d_same kernel, which masks its input by the same bounds
    where `t_mask` is given too (without `t_mask` nothing is masked, as in
    JAX).
    """
    if level_precisions is None or isinstance(level_precisions, str):
        lp = [level_precisions] * hp.num_upsamples
    else:
        lp = list(level_precisions)
    if len(lp) != hp.num_upsamples:
        raise ValueError(f"level_precisions has {len(lp)} entries for "
                         f"{hp.num_upsamples} upsample levels")
    if z.dtype == torch.bfloat16:
        lp = ["bfloat16" if t is None else t for t in lp]

    def masked(x, m):
        return x if m is None else x * m

    dev = z.device
    m = t_mask
    p = Prefix(params, prefix)
    with tier_scope(lp[0], dev):
        x = conv1d(masked(z, m), p["conv_pre.weight"], p["conv_pre.bias"], padding=3)
        if g is not None:
            x = x + conv1d(g, p["cond.weight"], p["cond.bias"])
        trace_put(f"{prefix}.conv_pre", x)

    num_kernels = hp.num_resblock_kernels
    use_resblock2 = f"{prefix}.resblocks.0.convs.0.weight" in params
    bounds = None
    if t_bounds is not None:
        bounds = t_bounds.to(torch.int32)
        if bounds.ndim == 1:
            bounds = torch.stack([torch.zeros_like(bounds), bounds], dim=1)
    for i in range(hp.num_upsamples):
        with tier_scope(lp[i], dev):
            x, m, bounds = _level(x, m, bounds, i, p, hp, use_resblock2, lp[i])

    with tier_scope(lp[-1], dev):
        x = leaky_relu(masked(x, m))  # final activation: torch default slope 0.01
        x = conv1d(masked(x, m), p["conv_post.weight"], p["conv_post.bias"], padding=3)
        trace_put(f"{prefix}.conv_post", x)
    out = torch.tanh(x)
    return out if m is None else out * m


def _level(x, m, bounds, i: int, p: Prefix, hp: VitsHParams, use_resblock2: bool,
           precision: Optional[str]):
    """Upsample level i: leaky ReLU, conv-transpose, then the level's
    resblocks and their mean, the kernels at `precision`. Returns (x, the
    level's mask, its bounds)."""
    x = leaky_relu(x if m is None else x * m, LRELU_SLOPE)
    k, u = hp.upsample_kernel_sizes[i], hp.upsample_rates[i]
    x = conv_transpose1d(x if m is None else x * m, p[f"ups.{i}.weight"], p[f"ups.{i}.bias"],
                         stride=u, padding=(k - u) // 2)
    trace_put(f"{p.prefix}.ups.{i}", x)
    if m is not None:
        m = torch.repeat_interleave(m, u, dim=2)
        x = x * m
    if bounds is not None:
        bounds = bounds * u
    ch_here = x.shape[1]
    num_kernels = hp.num_resblock_kernels
    ks, dilations = hp.resblock_kernel_sizes, hp.resblock_dilation_sizes
    fused = not use_resblock2 and ch_here < 128 and (m is None or bounds is not None)
    tier = tier_code(precision)
    rbs = [p.sub(f"resblocks.{i * num_kernels + j}") for j in range(num_kernels)]
    mrf_flag = flag("PIPER_TPU_FUSE_MRF")
    fuse_mrf = ch_here <= 32 if mrf_flag == "" else mrf_flag == "1"
    if fused and fuse_mrf and not tracing() and stage_takes(
            ch_here, max(branch_halo(k, d) for k, d in zip(ks, dilations)), tier, mean=True,
            taps=max(ks), device=x.device):
        branches = [(*_stacked(rb, len(dilations[j])), ks[j], dilations[j])
                    for j, rb in enumerate(rbs)]
        return resblock1_mrf(x, branches, bounds=bounds, slope=LRELU_SLOPE,
                             precision=precision), m, bounds
    acc = None
    for j, rb in enumerate(rbs):
        kernel, dils = ks[j], dilations[j]
        if fused and stage_takes(ch_here, branch_halo(kernel, dils), tier, taps=kernel,
                                 device=x.device):
            y = resblock1_branch(x, *_stacked(rb, len(dils)), kernel=kernel, dilations=dils,
                                 bounds=bounds, slope=LRELU_SLOPE, precision=precision)
        elif use_resblock2:
            y = _resblock2(x, rb, dils, t_mask=m, bounds=None if m is None else bounds,
                           precision=precision)
        elif fused:
            # A width or halo the ResBlock1 kernels refuse: conv by conv
            # through K1, masked by the bounds as the branch kernel masks,
            # traced as the branch kernel is (JAX's Pallas branch).
            y = _resblock1(x, rb, dils, t_mask=m, precision=precision, bounds=bounds,
                           record=False)
            if bounds is not None:
                b, _, n = x.shape
                y = y * _mask(_bounds_array(bounds, b, n, x.device), n).to(y.dtype)
        else:
            y = _resblock1(x, rb, dils, t_mask=m, precision=precision,
                           bounds=None if m is None else bounds)
        trace_put(rb.prefix, y)
        acc = y if acc is None else acc + y
    return acc / num_kernels, m, bounds
