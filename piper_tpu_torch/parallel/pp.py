"""Pipeline parallelism: the VITS decode split into stages over a `pp` mesh
axis, GPipe-style (counterpart of piper_tpu.parallel.pp).

The decode graph is cut into UNITS: [front (alignment expand + reverse
flows + conv_pre), up0..upN (one vocoder upsample level each), post
(conv_post + tanh)], and the stage partition minimizes the largest analytic
FLOP count of a stage over the contiguous cuts (the roofline cost model,
utils/roofline.py, is the load balancer). Each stage's units run on its
slot; microbatches of rows flow from stage to stage, and at steady state
every stage works on a different microbatch.

The schedule has M + S - 1 ticks (M microbatches, S stages): at tick t
stage s works microbatch t - s on its slot's stream. The activation goes to
the next stage's slot with `.to(device, non_blocking=True)`, and the next
stage's stream waits for an event recorded after it. Each row's frame count
rides along, so every stage rebuilds its exact-length masks from it
(prefix-of-ones, equal to the repeat-upsampled mask of the one-device
decode). JAX flattens every boundary into one common buffer because an
SPMD ppermute needs one shape; here each boundary keeps its own shape.

The stages run the plain resblocks (no kernels), as JAX's pipeline runs
them with use_pallas=False, from the blocks of models/vits/hifigan.py in the
same op order, so the pipelined decode matches `model.decode` to float
associativity.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import List, Optional, Sequence, Tuple

import torch

from piper_tpu_torch.models.vits.flows import flow_reverse
from piper_tpu_torch.models.vits.hifigan import LRELU_SLOPE, _resblock1, _resblock2
from piper_tpu_torch.models.vits.hparams import VitsHParams
from piper_tpu_torch.models.vits.model import EncodeResult
from piper_tpu_torch.models.vits.params import Params, Prefix
from piper_tpu_torch.ops.conv import conv1d, conv_transpose1d
from piper_tpu_torch.ops.kernels.precision import tier_scope
from piper_tpu_torch.ops.masking import generate_path, sequence_mask
from piper_tpu_torch.ops.nn import leaky_relu
from piper_tpu_torch.parallel.mesh import (DATA_AXIS, PIPE_AXIS, Mesh, _launch_counts,
                                           count_launches, replicated)


# --------------------------------------------------------------------------
# Stage partitioning (roofline-balanced)
# --------------------------------------------------------------------------


def unit_names(hp: VitsHParams) -> List[str]:
    return ["front"] + [f"up{i}" for i in range(hp.num_upsamples)] + ["post"]


def unit_flops(hp: VitsHParams, max_frames: int) -> List[float]:
    """Analytic FLOPs per pipeline unit at B=1 (relative weights only), from
    the same cost model the roofline report uses."""
    from piper_tpu_torch.utils.roofline import flow_cost, vocoder_level_costs

    voc = vocoder_level_costs(hp, 1, max_frames)  # [pre, up0.., post]
    front = flow_cost(hp, 1, max_frames).flops + voc[0].flops
    return [front] + [c.flops for c in voc[1:-1]] + [voc[-1].flops]


def balanced_cuts(costs: Sequence[float], n_stages: int) -> List[int]:
    """Contiguous partition of `costs` into `n_stages` runs minimizing the
    max per-stage sum. Returns cut indices, len n_stages+1, cuts[0]=0,
    cuts[-1]=len(costs). Unit counts are tiny (<=7), so brute force."""
    n = len(costs)
    if n_stages > n:
        raise ValueError(
            f"pipeline has only {n} units ({n_stages} stages requested); "
            f"this voice supports at most pp={n}"
        )
    best, best_cuts = math.inf, None
    for mid in itertools.combinations(range(1, n), n_stages - 1):
        cuts = (0,) + mid + (n,)
        worst = max(
            sum(costs[cuts[s]: cuts[s + 1]]) for s in range(n_stages)
        )
        if worst < best:
            best, best_cuts = worst, cuts
    return list(best_cuts)


def _boundary_shapes(hp: VitsHParams, max_frames: int) -> List[Tuple[int, int]]:
    """(C, T) after each unit except post (post emits audio, not a boundary)."""
    u0 = hp.upsample_initial_channel
    shapes = [(u0, max_frames)]
    t = max_frames
    for i in range(hp.num_upsamples):
        t *= hp.upsample_rates[i]
        shapes.append((u0 // (2 ** (i + 1)), t))
    return shapes


# --------------------------------------------------------------------------
# Per-unit compute (mirrors hifigan_generator's unfused path exactly)
# --------------------------------------------------------------------------


def _level_precisions(hp: VitsHParams, vocoder_precision):
    if isinstance(vocoder_precision, str):
        return [vocoder_precision] * hp.num_upsamples
    if vocoder_precision is None:
        return [None] * hp.num_upsamples
    return list(vocoder_precision)


def _make_unit_fns(hp: VitsHParams, max_frames: int, *, noise_scale,
                   vocoder_precision, flow_precision, use_resblock2: bool):
    """Unit index -> fn(params, x, y_len, mb_in) -> next activation.

    y_len is (mb,) float frame counts; masks at any resolution are
    rebuilt from it."""
    lp = _level_precisions(hp, vocoder_precision)
    nk = hp.num_resblock_kernels

    def front(params, _x, y_len, mb_in):
        m_p, logs_p, x_mask, w_ceil, noise = mb_in[:5]
        g = mb_in[5] if len(mb_in) > 5 else None
        dev = m_p.device
        y_mask = sequence_mask(y_len.to(torch.int32), max_frames).to(m_p.dtype)
        path = generate_path(w_ceil, x_mask, y_mask)
        m_e = torch.einsum("btp,bcp->bct", path, m_p)
        logs_e = torch.einsum("btp,bcp->bct", path, logs_p)
        z_p = m_e + noise.to(m_e.dtype) * torch.exp(logs_e) * noise_scale
        with tier_scope(flow_precision, dev):
            z = flow_reverse(z_p, y_mask, params, hp, g=g)
        p = Prefix(params, "dec")
        with tier_scope(lp[0], dev):
            x = conv1d(z * y_mask, p["conv_pre.weight"], p["conv_pre.bias"], padding=3)
            if g is not None:
                x = x + conv1d(g, p["cond.weight"], p["cond.bias"])
        return x

    def make_level(i: int):
        r_in = 1
        for u in hp.upsample_rates[:i]:
            r_in *= u
        k, u = hp.upsample_kernel_sizes[i], hp.upsample_rates[i]

        def level(params, x, y_len, _mb_in):
            p = Prefix(params, "dec")
            m = sequence_mask(y_len * r_in, max_frames * r_in).to(x.dtype)
            with tier_scope(lp[i], x.device):
                x = leaky_relu(x * m, LRELU_SLOPE)
                x = conv_transpose1d(x * m, p[f"ups.{i}.weight"], p[f"ups.{i}.bias"],
                                     stride=u, padding=(k - u) // 2)
                m = sequence_mask(y_len * (r_in * u), max_frames * r_in * u).to(x.dtype)
                x = x * m
                acc = None
                for j in range(nk):
                    rb = p.sub(f"resblocks.{i * nk + j}")
                    dils = hp.resblock_dilation_sizes[j]
                    block = _resblock2 if use_resblock2 else _resblock1
                    y = block(x, rb, dils, t_mask=m, precision=lp[i], kernels=False)
                    acc = y if acc is None else acc + y
                x = acc / nk
            return x

        return level

    def post(params, x, y_len, _mb_in):
        p = Prefix(params, "dec")
        r = 1
        for u in hp.upsample_rates:
            r *= u
        m = sequence_mask(y_len * r, max_frames * r).to(x.dtype)
        with tier_scope(lp[-1], x.device):
            x = leaky_relu(x * m)  # final activation: torch default slope
            x = conv1d(x * m, p["conv_post.weight"], p["conv_post.bias"], padding=3)
        return (torch.tanh(x) * m)[:, 0, :]

    return [front] + [make_level(i) for i in range(hp.num_upsamples)] + [post]


# --------------------------------------------------------------------------
# The pipelined decode
# --------------------------------------------------------------------------


def default_microbatches(rows: int, n_stages: int) -> int:
    """Largest divisor of `rows` that is <= 2 * n_stages: enough microbatches
    to keep the bubble fraction (S-1)/(M+S-1) low without shrinking each
    microbatch to nothing."""
    for m in range(min(rows, 2 * n_stages), 0, -1):
        if rows % m == 0:
            return m
    return 1


def build_pp_decode(
    mesh: Mesh,
    hp: VitsHParams,
    *,
    max_frames: int,
    rows_per_dp: int,
    microbatches: Optional[int] = None,
    with_g: bool,
    noise_scale: float = 0.667,
    vocoder_precision=None,
    flow_precision: Optional[str] = None,
    precision: str = "highest",
):
    """Build the pipelined decode.

    Returns fn(params, m_p, logs_p, x_mask, w_ceil, noise[, g]) ->
    (audio (B, max_frames*hop), y_lengths (B,)), B = dp * rows_per_dp:
    dp group d decodes rows [d * rows_per_dp, (d + 1) * rows_per_dp)
    through its own pipeline. `params` is one weight dict (copied to the
    stage slots' devices) or one per slot (mesh.replicated's list)."""
    S = int(mesh.shape.get(PIPE_AXIS, 1))
    if S < 2:
        raise ValueError("build_pp_decode needs a mesh with pp >= 2")
    for ax in ("sp", "tp"):
        if int(mesh.shape.get(ax, 1)) != 1:
            raise NotImplementedError(
                f"pipeline parallelism composes with dp only; mesh has {ax}="
                f"{mesh.shape[ax]}"
            )
    M = microbatches or default_microbatches(rows_per_dp, S)
    if rows_per_dp % M != 0:
        raise ValueError(f"rows_per_dp {rows_per_dp} not divisible by "
                         f"microbatches {M}")
    mb = rows_per_dp // M
    cuts = balanced_cuts(unit_flops(hp, max_frames), S)
    unit_fns = _make_unit_fns(
        hp, max_frames, noise_scale=noise_scale,
        vocoder_precision=vocoder_precision, flow_precision=flow_precision,
        use_resblock2=hp.resblock == "2")
    dp = int(mesh.shape[DATA_AXIS])

    def stage(params, s, x, y_len, mb_in):
        if s == 0:
            y_len = torch.clamp(mb_in[3].sum(dim=-1), 1, max_frames)
        for u in range(cuts[s], cuts[s + 1]):
            x = unit_fns[u](params, x, y_len, mb_in)
        return x, y_len

    def pipeline(slot_params, slots, inputs):
        """One dp group's GPipe schedule over its stage slots."""
        devs = [mesh.device(i) for i in slots]
        cuda = devs[0].type == "cuda"
        streams = [mesh.stream(i) for i in slots]
        if cuda:
            cur = torch.cuda.current_stream(devs[0])
            for st in streams:
                st.wait_stream(cur)
        mbs = [tuple(a[k * mb:(k + 1) * mb].to(devs[0]) for a in inputs) for k in range(M)]
        carry = [None] * M  # (x, y_len, event) handed to the next stage
        audio, y_out = [None] * M, [None] * M
        for t in range(M + S - 1):
            for s in range(S):
                k = t - s
                if not 0 <= k < M:
                    continue
                before = _launch_counts()
                ctx = torch.cuda.stream(streams[s]) if cuda else contextlib.nullcontext()
                with ctx:
                    x, y_len = (None, None)
                    if s > 0:
                        x, y_len, ev = carry[k]
                        if ev is not None:
                            streams[s].wait_event(ev)
                    with tier_scope(precision, devs[s]):
                        x, y_len = stage(slot_params[slots[s]], s, x, y_len, mbs[k])
                    if s == S - 1:
                        audio[k], y_out[k] = x, y_len
                    else:
                        nxt = devs[s + 1]
                        x = x.to(nxt, non_blocking=True)
                        y_len = y_len.to(nxt, non_blocking=True)
                        ev = None
                        if cuda:
                            # The next stage reads these on its own stream.
                            x.record_stream(streams[s + 1])
                            y_len.record_stream(streams[s + 1])
                            ev = torch.cuda.Event()
                            ev.record(streams[s])
                        carry[k] = (x, y_len, ev)
                count_launches(mesh, slots[s], before)
        if cuda:
            for st in streams:
                cur.wait_stream(st)
        return (torch.cat([a.to(devs[0]) for a in audio]),
                torch.cat([y.to(devs[0]) for y in y_out]))

    def call(params, m_p, logs_p, x_mask, w_ceil, noise, g=None):
        b = m_p.shape[0]
        if b != dp * rows_per_dp:
            raise ValueError(f"batch {b} != dp {dp} * rows_per_dp {rows_per_dp}")
        slot_params = params if isinstance(params, list) else _replicate(mesh, params)
        outs = []
        for d in range(dp):
            rows = slice(d * rows_per_dp, (d + 1) * rows_per_dp)
            ins = [m_p[rows], logs_p[rows], x_mask[rows], w_ceil[rows], noise[rows]]
            if with_g:
                ins.append(g[rows])
            slots = [mesh.index(dp=d, pp=s) for s in range(S)]
            outs.append(pipeline(slot_params, slots, ins))
        dev0 = m_p.device
        return (torch.cat([a.to(dev0) for a, _ in outs]),
                torch.cat([y.to(dev0) for _, y in outs]))

    return call


def _replicate(mesh: Mesh, params: Params) -> List[Params]:
    """One weight dict per slot (mesh.replicated of every tensor)."""
    per_slot: List[Params] = [{} for _ in range(mesh.size)]
    for name, t in params.items():
        for slot, c in enumerate(replicated(mesh, t)):
            per_slot[slot][name] = c
    return per_slot


def pp_decode(
    params: Params,
    hp: VitsHParams,
    enc: EncodeResult,
    main_noise: torch.Tensor,
    *,
    mesh: Mesh,
    max_frames: int,
    microbatches: Optional[int] = None,
    noise_scale: float = 0.667,
    vocoder_precision=None,
    flow_precision: Optional[str] = None,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-shot pipelined decode (builds the schedule each call; use
    build_pp_decode and a cache of your own for serving)."""
    dp = int(mesh.shape.get(DATA_AXIS, 1))
    b = enc.m_p.shape[0]
    if b % dp != 0:
        raise ValueError(f"batch {b} not divisible by dp {dp}")
    call = build_pp_decode(
        mesh, hp, max_frames=max_frames, rows_per_dp=b // dp,
        microbatches=microbatches, with_g=enc.g is not None,
        noise_scale=noise_scale, vocoder_precision=vocoder_precision,
        flow_precision=flow_precision, precision=precision)
    return call(params, enc.m_p, enc.logs_p, enc.x_mask, enc.w_ceil, main_noise, enc.g)
