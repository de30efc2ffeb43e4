"""Arithmetic the per-layer readers share (not a metric: no metric is
named with a leading underscore)."""

from __future__ import annotations

from benchmark.core import costs


def idle_share(ctx):
    """% of the traced window's wall time in which no device operation ran."""
    t = ctx.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_seconds(ctx, symbol: str):
    t = ctx.trace
    if not t:
        return 0.0
    return sum(v for k, v in t["kernel_s"].items() if symbol in k)


def roofline(ctx, work, symbol: str):
    """% of a kernel's roofline: the least time the card could take for the
    work the kernel serves in the batches completed in the traced slice (the larger of its operations at
    the vocoder tier's peak and its bytes at the HBM peak), over the
    kernel's device time in the traced window. Nothing when the kernel did
    not run there."""
    spent = kernel_seconds(ctx, symbol)
    if spent <= 0:
        return None
    flops, nbytes = work(ctx.config["hparams"], ctx.window.traced_frames)
    if flops <= 0:
        return None
    tier = ctx.config["runtime"]["vocoder_precision"]
    return 100.0 * costs.bound_s(flops, nbytes, tier) / spent


def mfu(ctx):
    """% of the card's peak: the frozen cost model's FLOPs of every row the
    window completed, at its live phonemes and frames, over the window's
    wall time, against the published peak of the vocoder's tier."""
    w = ctx.window
    span = w.t_close - w.t_open
    if span <= 0 or not w.frames:
        return None
    rows = [(p, f) for ps, fs in zip(w.phonemes, w.frames) for p, f in zip(ps, fs)]
    flops = costs.step_flops(ctx.config["hparams"], rows)
    return 100.0 * flops / span / costs.TIER_FLOPS[ctx.config["runtime"]["vocoder_precision"]]
