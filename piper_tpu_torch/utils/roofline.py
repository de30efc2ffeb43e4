"""Roofline accounting for the VITS synthesis pipeline on the port.

The cost model (StageCost through total_cost) is piper_tpu.utils.roofline's,
copied unchanged and held equal by a test: analytic FLOPs (2 x the MACs of
the convs and matmuls) and the minimum bytes per stage (encoder, duration
predictor, flow decoder, each vocoder level), the bytes a perfectly fused
stage would move at fp32 activations. It charges the whole frame bucket T
on every row: the kernels that skip dead tiles do less work than it counts
where rows end early, and cuDNN's convs do all of it.

The measuring part is the port's: `measure_ceilings` times large products
and a streaming op on the device (each GEMM tier's TFLOP/s, HBM GB/s), and
`measure_stages` times each stage alone through the production code
(`PiperRuntime._encode`, `flow_reverse`, `hifigan_generator` and each
upsample level through `hifigan._level`, so each level runs the kernel
production routes it to: K3 at C <= 32, K2 at C = 64, K1 on a ResBlock2
voice, K1's wide design at C = 128 to 256 on fp32 activations at "highest"
and "high"). On a CUDA card a stage's time is its device time (torch.profiler,
`tools/timing.py::device_ms`) with its kernels per call required and
reported; on the CPU it is the wall clock. `mfu` and `hbm_frac` are taken
against the H100's published peaks of `tools/timing.py` (the stage tier's
TIER_FLOPS, PEAK_BYTES_PER_S), not against the measured ceilings, which
the report carries beside them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from piper_tpu_torch.models.vits.hparams import VitsHParams


@dataclass
class StageCost:
    stage: str
    flops: float = 0.0   # 2 * MACs
    bytes: float = 0.0   # minimum HBM traffic at fp32 activations
    ms: Optional[float] = None          # measured per call: device time on a card
    achieved_tf_s: Optional[float] = None
    achieved_gb_s: Optional[float] = None
    mfu: Optional[float] = None         # vs the matching GEMM ceiling
    hbm_frac: Optional[float] = None    # achieved GB/s vs HBM ceiling
    bound: Optional[str] = None         # "compute" | "memory"
    kernels: Optional[int] = None       # device kernels per call (None on the CPU)
    tier: Optional[str] = None          # the tier whose peak is the mfu denominator

    @property
    def intensity(self) -> float:
        """Arithmetic intensity (FLOPs per byte moved)."""
        return self.flops / self.bytes if self.bytes else 0.0


def _conv(B, T_in, C_in, C_out, k, T_out=None, groups: int = 1):
    """(flops, bytes) of one batched 1-D conv. For conv_transpose pass
    T_out=T_in*stride — MACs are T_in*k*C_in*C_out either way (each input
    sample touches k taps)."""
    T_out = T_in if T_out is None else T_out
    macs = B * T_in * k * (C_in // groups) * C_out
    bytes_ = 4.0 * (B * (T_in * C_in + T_out * C_out) + C_in * C_out * k / groups)
    return 2.0 * macs, bytes_


def encoder_cost(hp: VitsHParams, B: int, P: int) -> StageCost:
    """Text encoder: n_layers x (rel-attention + FFN) + prior projection."""
    H, F, k, w = (hp.hidden_channels, hp.filter_channels, hp.kernel_size,
                  hp.window_size)
    fl = by = 0.0
    for _ in range(hp.n_layers):
        for _ in range(4):  # q, k, v, out projections (k=1)
            f, b = _conv(B, P, H, H, 1)
            fl, by = fl + f, by + b
        # scores + apply: 2 * P*P*H MACs; rel-k/rel-v: 2 * P*(2w+1)*H.
        fl += 2.0 * B * (2 * P * P * H + 2 * P * (2 * w + 1) * H)
        by += 4.0 * B * (2 * hp.n_heads * P * P)  # score mat write+read
        for cin, cout in ((H, F), (F, H)):  # FFN convs, kernel k
            f, b = _conv(B, P, cin, cout, k)
            fl, by = fl + f, by + b
    f, b = _conv(B, P, H, 2 * hp.inter_channels, 1)  # prior proj
    return StageCost("encoder", fl + f, by + b)


def duration_predictor_cost(hp: VitsHParams, B: int, P: int) -> StageCost:
    """Stochastic duration predictor, reverse pass (DDSConv stacks are
    depthwise-separable: depthwise k + pointwise 1x1, 3 layers each)."""
    H, D, k = hp.hidden_channels, hp.dp_filter_channels, hp.dp_kernel_size
    n_dds = 3

    def dds():
        f = b = 0.0
        for _ in range(n_dds):
            f1, b1 = _conv(B, P, D, D, k, groups=D)  # depthwise
            f2, b2 = _conv(B, P, D, D, 1)            # pointwise
            f, b = f + f1 + f2, b + b1 + b2
        return f, b

    fl, by = _conv(B, P, H, D, 1)  # dp.pre
    f, b = dds()                   # dp.convs
    fl, by = fl + f, by + b
    # The SDP reverse pass executes dp_n_flows - 1 ConvFlows: it drops the
    # first one (flows[:-2] + [flows[-1]] — the trained-but-unused flow),
    # matching models/vits/duration.py and the torch oracle.
    for _ in range(max(0, hp.dp_n_flows - 1)):  # ConvFlow each: pre + DDS + proj
        f, b = _conv(B, P, 1, D, 1)
        fl, by = fl + f, by + b
        f, b = dds()
        fl, by = fl + f, by + b
        f, b = _conv(B, P, D, 3 * hp.dp_num_bins - 1, 1)
        fl, by = fl + f, by + b
    return StageCost("duration_predictor", fl, by)


def flow_cost(hp: VitsHParams, B: int, T: int) -> StageCost:
    """Reverse residual-coupling flows on the frame axis."""
    C, H = hp.inter_channels, hp.flow_hidden_channels
    k, L = hp.flow_kernel_size, hp.flow_n_layers
    fl = by = 0.0
    for _ in range(hp.flow_n_flows):
        f, b = _conv(B, T, C // 2, H, 1)  # pre
        fl, by = fl + f, by + b
        for i in range(L):
            f, b = _conv(B, T, H, 2 * H, k)  # in_layer (dilated: same MACs)
            fl, by = fl + f, by + b
            cout = 2 * H if i < L - 1 else H
            f, b = _conv(B, T, H, cout, 1)   # res_skip
            fl, by = fl + f, by + b
        f, b = _conv(B, T, H, C // 2, 1)  # post (mean only)
        fl, by = fl + f, by + b
    return StageCost("flow", fl, by)


def vocoder_level_costs(hp: VitsHParams, B: int, T: int) -> List[StageCost]:
    """conv_pre, then per upsample level (conv_transpose + resblock set),
    then conv_post — each its own row so the roofline can pinpoint a level."""
    U0 = hp.upsample_initial_channel
    out: List[StageCost] = []
    f, b = _conv(B, T, hp.inter_channels, U0, 7)
    out.append(StageCost("vocoder.pre", f, b))
    t = T
    for i in range(hp.num_upsamples):
        c_in, c_out = U0 // (2 ** i), U0 // (2 ** (i + 1))
        k, u = hp.upsample_kernel_sizes[i], hp.upsample_rates[i]
        fl, by = _conv(B, t, c_in, c_out, k, T_out=t * u)  # conv_transpose
        t *= u
        # Minimum HBM traffic of the resblock stage depends on kernel
        # selection: at ch<=32 ResBlock1 levels the whole-MRF Pallas kernel
        # (hifigan.py fuse_mrf default) reads the level activation once and
        # writes the mean once — per-conv intermediates never leave VMEM —
        # so only weights are charged per conv. Other levels stream each
        # conv's input/output through HBM.
        mrf_fused = hp.resblock != "2" and c_out <= 32
        if mrf_fused:
            by += 4.0 * 2 * B * t * c_out  # one stage read + one write
        for j, kj in enumerate(hp.resblock_kernel_sizes):
            n_convs = len(hp.resblock_dilation_sizes[j]) * (
                1 if hp.resblock == "2" else 2)
            for _ in range(n_convs):
                f, b = _conv(B, t, c_out, c_out, kj)
                if mrf_fused:
                    b = 4.0 * c_out * c_out * kj  # weights only
                fl, by = fl + f, by + b
        out.append(StageCost(f"vocoder.up{i}", fl, by))
    f, b = _conv(B, t, U0 // (2 ** hp.num_upsamples), 1, 7)
    out.append(StageCost("vocoder.post", f, b))
    return out


def pipeline_costs(hp: VitsHParams, B: int, P: int, T: int) -> List[StageCost]:
    """All stages of one synthesis at batch B, phoneme bucket P, frame
    bucket T."""
    return [
        encoder_cost(hp, B, P),
        duration_predictor_cost(hp, B, P),
        flow_cost(hp, B, T),
        *vocoder_level_costs(hp, B, T),
    ]


def total_cost(hp: VitsHParams, B: int, P: int, T: int) -> StageCost:
    stages = pipeline_costs(hp, B, P, T)
    return StageCost("total", sum(s.flops for s in stages),
                     sum(s.bytes for s in stages))


# -- the denominators: the H100's published peaks ------------------------------


def published_peaks() -> Dict[str, float]:
    """The card's published peaks under the ceilings' keys: TFLOP/s of each
    tier's products (tools/timing.py's TIER_FLOPS; "bfloat16" is one bf16
    pass) and HBM GB/s."""
    from piper_tpu_torch.tools.timing import PEAK_BYTES_PER_S, PEAK_FLOPS, TIER_FLOPS

    return {"gemm_tf_s_highest": TIER_FLOPS["highest"] / 1e12,
            "gemm_tf_s_high": TIER_FLOPS["high"] / 1e12,
            "gemm_tf_s_default": TIER_FLOPS["default"] / 1e12,
            "gemm_tf_s_bf16": PEAK_FLOPS["bf16"] / 1e12,
            "hbm_gb_s": PEAK_BYTES_PER_S / 1e9}


def _sig(x: Optional[float], digits: int = 6) -> Optional[float]:
    """x to `digits` significant digits (a small stage's rate must not round
    to 0)."""
    return None if x is None else float(f"{x:.{digits}g}")


# -- timing ----------------------------------------------------------------------


def wall_s(fn, iters: int) -> float:
    """Median of 3 wall-clock timings of `iters` back-to-back calls after one
    warm-up call; seconds per call. For the CPU, where a call returns when
    its work is done."""
    fn()
    best = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best.append((time.perf_counter() - t0) / iters)
    return float(np.median(best))


def time_call(fn, iters: int, device):
    """(ms per call, kernels per call) of fn() on `device`: on a CUDA card
    its device time, every profiled window required to hold its kernels per
    call (tools/timing.py's call_kernels, then device_ms); on the CPU its
    wall time and None."""
    import torch

    if torch.device(device).type != "cuda":
        return wall_s(fn, iters) * 1e3, None
    from piper_tpu_torch.tools.timing import call_kernels, device_ms

    kernels, _ = call_kernels(fn, reps=2)
    return device_ms(fn, reps=iters, expected=kernels), kernels


# -- measured ceilings -----------------------------------------------------------


def measure_ceilings(iters: int = 8, n: int = 4096, device="cuda",
                     stream_mb: int = 256) -> Dict[str, float]:
    """What this device reaches on plain large work: square-GEMM TFLOP/s per
    tier and streaming HBM GB/s (a read and a write of a `stream_mb` MB fp32
    array in one elementwise kernel). "highest" is an fp32 product with TF32
    off; "high" three bf16 products (hi*hi + hi*lo + lo*hi), its rate counted
    on 2n^3 FLOPs; "default" and "bfloat16" one product of bf16 operands.
    These are measurements beside the published peaks, not the report's
    denominators."""
    import torch

    from piper_tpu_torch.ops.kernels.precision import fp32_exact

    dev = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(n, n, generator=gen).to(dev)
    bm = torch.randn(n, n, generator=gen).to(dev)
    a_hi, b_hi = a.to(torch.bfloat16), bm.to(torch.bfloat16)
    a_lo = (a - a_hi.float()).to(torch.bfloat16)
    b_lo = (bm - b_hi.float()).to(torch.bfloat16)
    flops = 2.0 * n ** 3
    out: Dict[str, float] = {}
    with torch.inference_mode(), fp32_exact():
        def rate(fn) -> float:
            return flops / (time_call(fn, iters, dev)[0] / 1e3) / 1e12

        out["gemm_tf_s_highest"] = rate(lambda: a @ bm)
        out["gemm_tf_s_high"] = rate(
            lambda: (a_hi @ b_hi).float() + (a_hi @ b_lo).float() + (a_lo @ b_hi).float())
        out["gemm_tf_s_default"] = rate(lambda: a_hi @ b_hi)
        out["gemm_tf_s_bf16"] = rate(lambda: a_hi @ b_hi)
        del a, bm, a_hi, b_hi, a_lo, b_lo
        elems = stream_mb * (1 << 20) // 4
        big = torch.randn(elems, generator=gen).to(dev)
        scale = torch.tensor(1.000001, device=dev)
        shift = torch.tensor(0.5, device=dev)
        # addcmul: shift + big * scale in one kernel (one read, one write).
        ms, _ = time_call(lambda: torch.addcmul(shift, big, scale), iters, dev)
        out["hbm_gb_s"] = 2.0 * elems * 4 / (ms / 1e3) / 1e9
    return out


_TIER_CEILING_KEY = {
    None: "gemm_tf_s_highest",
    "highest": "gemm_tf_s_highest",
    "high": "gemm_tf_s_high",
    "default": "gemm_tf_s_default",
    "bfloat16": "gemm_tf_s_bf16",
}


def annotate(stage: StageCost, ms: float, ceilings: Dict[str, float],
             tier: Optional[str]) -> StageCost:
    """Fill in achieved rates and the roofline verdict for a measured time,
    against `ceilings` (measure_stages passes published_peaks())."""
    sec = ms / 1e3
    stage.ms = ms
    stage.achieved_tf_s = stage.flops / sec / 1e12
    stage.achieved_gb_s = stage.bytes / sec / 1e9
    peak = ceilings.get(_TIER_CEILING_KEY.get(tier, "gemm_tf_s_highest"))
    hbm = ceilings.get("hbm_gb_s")
    stage.mfu = stage.achieved_tf_s / peak if peak else None
    stage.hbm_frac = stage.achieved_gb_s / hbm if hbm else None
    if stage.mfu is not None and stage.hbm_frac is not None:
        stage.bound = "compute" if stage.mfu >= stage.hbm_frac else "memory"
    return stage


# -- per-stage measurements ------------------------------------------------------


def measure_stages(rt, B: int, P: int, T: int, iters: int = 10,
                   per_level: bool = True) -> List[StageCost]:
    """Time each pipeline stage alone on the runtime's device and annotate
    the analytic costs with achieved TFLOP/s, GB/s, mfu and hbm_frac against
    the published peaks. Each row also gets `kernels` (its device kernels
    per call on the card, None on the CPU) and `tier`.

    The stages run the production code under the runtime's tiers: encode is
    `PiperRuntime._encode` on (B, P) ids of full length; flow is
    `flow_reverse` on a (B, inter, T) latent in its tier's scope; vocoder is
    the whole `hifigan_generator` with the runtime's level precisions; each
    level is `hifigan._level` on a (B, C_in, t) input in its tier's scope.
    The decode stages get the mask and row bounds a decode of T live frames
    gives them, as `model.decode` passes them."""
    import torch

    from piper_tpu_torch.models.vits.flows import flow_reverse
    from piper_tpu_torch.models.vits.hifigan import hifigan_generator
    from piper_tpu_torch.ops.kernels.precision import tier_scope

    if not hasattr(rt, "_roofline_ceilings"):
        rt._roofline_ceilings = measure_ceilings(device=rt.device)
    peaks = published_peaks()
    hp, dev, o = rt.hparams, rt.device, rt.options
    prec = o.precision
    voc_prec, flow_prec = o.vocoder_precision, o.flow_precision
    if isinstance(voc_prec, str):
        voc_tiers = [voc_prec] * hp.num_upsamples
    elif voc_prec is None:
        voc_tiers = [None] * hp.num_upsamples
    else:
        voc_tiers = list(voc_prec)

    gen = torch.Generator().manual_seed(0)
    ids = np.zeros((B, P), np.int64)
    lengths = np.full((B,), P, np.int64)
    sid = rt._sid_array(None, B)
    z_like = torch.randn(B, hp.inter_channels, T, generator=gen).to(dev)
    mask = torch.ones(B, 1, T, device=dev)
    bounds = torch.full((B,), T, dtype=torch.int32, device=dev)

    stages: List[StageCost] = []

    def measured(cost: StageCost, fn, tier) -> StageCost:
        ms, kernels = time_call(fn, iters, dev)
        row = annotate(cost, ms, peaks, tier)
        row.kernels, row.tier = kernels, tier or "highest"
        return row

    with rt._device_work():
        # encoder + duration predictor (the production encode).
        enc_cost = encoder_cost(hp, B, P)
        dp_cost = duration_predictor_cost(hp, B, P)
        both = StageCost("encode(enc+dp)", enc_cost.flops + dp_cost.flops,
                         enc_cost.bytes + dp_cost.bytes)
        stages.append(measured(both, lambda: rt._encode(ids, lengths, 1.0, 0.8, 0, sid=sid),
                               prec))

        # flow decoder.
        def flow_fn():
            with tier_scope(flow_prec or prec, dev):
                return flow_reverse(z_like, mask, rt.params, hp, g=None)

        stages.append(measured(flow_cost(hp, B, T), flow_fn, flow_prec or prec))

        # whole vocoder (production kernel selection).
        def voc_fn():
            return hifigan_generator(z_like, rt.params, hp, g=None, level_precisions=voc_prec,
                                     t_mask=mask, t_bounds=bounds)

        vc_rows = vocoder_level_costs(hp, B, T)
        vc_total = StageCost("vocoder", sum(s.flops for s in vc_rows),
                             sum(s.bytes for s in vc_rows))
        voc_tier = voc_tiers[0] if voc_tiers[0] is not None else prec
        stages.append(measured(vc_total, voc_fn, voc_tier))

        if per_level:
            stages.extend(_measure_vocoder_levels(rt, B, T, vc_rows, voc_tiers, prec,
                                                  measured))
    return stages


def _measure_vocoder_levels(rt, B, T, vc_rows, voc_tiers, prec, measured):
    """One row per upsample level through production's `_level`: the level's
    leaky ReLU, conv-transpose and resblocks, with the kernels it routes to
    (K3 at C <= 32, K2 below 128 channels, K1 on a ResBlock2 voice, cuDNN
    above), its mask and row bounds at all t frames live."""
    import torch

    from piper_tpu_torch.models.vits.hifigan import _level
    from piper_tpu_torch.models.vits.params import Prefix
    from piper_tpu_torch.ops.kernels.precision import tier_scope

    hp, dev = rt.hparams, rt.device
    p = Prefix(rt.params, "dec")
    use_rb2 = "dec.resblocks.0.convs.0.weight" in rt.params
    out = []
    t = T
    for i in range(hp.num_upsamples):
        c_in = hp.upsample_initial_channel // (2 ** i)
        gen = torch.Generator().manual_seed(1000 + i)
        x_in = torch.randn(B, c_in, t, generator=gen).to(dev)
        m = torch.ones(B, 1, t, device=dev)
        bnd = torch.tensor([[0, t]] * B, dtype=torch.int32, device=dev)

        def level_fn(_i=i, _x=x_in, _m=m, _b=bnd):
            with tier_scope(voc_tiers[_i], dev):
                return _level(_x, _m, _b, _i, p, hp, use_rb2, voc_tiers[_i])[0]

        row = vc_rows[i + 1]  # vc_rows[0] is vocoder.pre
        tier = voc_tiers[i] if voc_tiers[i] is not None else prec
        out.append(measured(StageCost(row.stage, row.flops, row.bytes), level_fn, tier))
        del x_in, m
        t *= hp.upsample_rates[i]
    return out


def roofline_report(rt, B: int, P: int, T: int, iters: int = 10,
                    per_level: bool = True,
                    ceilings: Optional[Dict[str, float]] = None) -> dict:
    """Full report, JSON-ready: the measured ceilings beside the published
    peaks, the card (name and power limit; None on the CPU), and the
    per-stage rows. `timing` says what `ms` is: "device" (torch.profiler on
    the card) or "wall" (the CPU)."""
    import torch

    from piper_tpu_torch.tools.timing import card

    rt._roofline_ceilings = ceilings or measure_ceilings(iters=max(4, iters // 2),
                                                         device=rt.device)
    stages = measure_stages(rt, B, P, T, iters=iters, per_level=per_level)
    tot = total_cost(rt.hparams, B, P, T)
    return {
        "batch": B, "phoneme_bucket": P, "frame_bucket": T,
        "ceilings": {k: _sig(v) for k, v in rt._roofline_ceilings.items()},
        "peaks": published_peaks(),
        "device": card(rt.device),
        "timing": "device" if torch.device(rt.device).type == "cuda" else "wall",
        "total_gflops_per_synthesis": round(tot.flops / 1e9, 2),
        "total_gb_min_traffic": round(tot.bytes / 1e9, 3),
        "stages": [
            {
                "stage": s.stage,
                "gflops": round(s.flops / 1e9, 3),
                "gb": round(s.bytes / 1e9, 4),
                "intensity_flop_per_byte": round(s.intensity, 1),
                "ms": _sig(s.ms),
                "tf_s": _sig(s.achieved_tf_s),
                "gb_s": _sig(s.achieved_gb_s),
                "mfu": _sig(s.mfu),
                "hbm_frac": _sig(s.hbm_frac),
                "bound": s.bound,
                "kernels": s.kernels,
                "tier": s.tier,
            }
            for s in stages
        ],
    }
