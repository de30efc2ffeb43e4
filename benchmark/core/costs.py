"""The yardstick's arithmetic: a synthesis's operations and bytes, and the
H100's published peaks they are held against.

`encoder_cost` through `total_cost` are a frozen copy of the cost model in
`piper_tpu_torch/utils/roofline.py` at commit 1fc906d (itself the JAX
package's): analytic FLOPs (2 x the MACs of the convs and matmuls) and the
minimum bytes a perfectly fused stage moves at fp32 activations, reading
the architecture from a config's hparams dict. The benchmark evaluates it
at each row's live phonemes and frames, not at the bucket, so padding is
not counted as work. `resblock1_work` counts the ResBlock1 kernels'
share the same way, level by level at live samples.

The peaks: a frozen copy of `piper_tpu_torch/tools/timing.py` at commit
1fc906d (NVIDIA's data sheet for one H100 SXM, dense, at its 700 W limit).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
# A tier's products at the card's fastest rate for them: fp32-class as 3
# passes of TF32 ("highest"), 3 passes ("high") or 1 pass ("default") of bf16.
TIER_FLOPS = {"highest": PEAK_FLOPS["tf32"] / 3, "high": PEAK_FLOPS["bf16"] / 3,
              "default": PEAK_FLOPS["bf16"]}


def _conv(B, T_in, C_in, C_out, k, T_out=None, groups: int = 1):
    T_out = T_in if T_out is None else T_out
    macs = B * T_in * k * (C_in // groups) * C_out
    bytes_ = 4.0 * (B * (T_in * C_in + T_out * C_out) + C_in * C_out * k / groups)
    return 2.0 * macs, bytes_


def encoder_cost(hp: dict, B: int, P: int) -> Tuple[float, float]:
    H, F, k, w = hp["hidden_channels"], hp["filter_channels"], hp["kernel_size"], hp["window_size"]
    fl = by = 0.0
    for _ in range(hp["n_layers"]):
        for _ in range(4):
            f, b = _conv(B, P, H, H, 1)
            fl, by = fl + f, by + b
        fl += 2.0 * B * (2 * P * P * H + 2 * P * (2 * w + 1) * H)
        by += 4.0 * B * (2 * hp["n_heads"] * P * P)
        for cin, cout in ((H, F), (F, H)):
            f, b = _conv(B, P, cin, cout, k)
            fl, by = fl + f, by + b
    f, b = _conv(B, P, H, 2 * hp["inter_channels"], 1)
    return fl + f, by + b


def duration_predictor_cost(hp: dict, B: int, P: int) -> Tuple[float, float]:
    H, D, k = hp["hidden_channels"], hp["dp_filter_channels"], hp["dp_kernel_size"]

    def dds():
        f = b = 0.0
        for _ in range(3):
            f1, b1 = _conv(B, P, D, D, k, groups=D)
            f2, b2 = _conv(B, P, D, D, 1)
            f, b = f + f1 + f2, b + b1 + b2
        return f, b

    fl, by = _conv(B, P, H, D, 1)
    f, b = dds()
    fl, by = fl + f, by + b
    for _ in range(max(0, hp["dp_n_flows"] - 1)):
        f, b = _conv(B, P, 1, D, 1)
        fl, by = fl + f, by + b
        f, b = dds()
        fl, by = fl + f, by + b
        f, b = _conv(B, P, D, 3 * hp["dp_num_bins"] - 1, 1)
        fl, by = fl + f, by + b
    return fl, by


def flow_cost(hp: dict, B: int, T: int) -> Tuple[float, float]:
    C, H = hp["inter_channels"], hp["flow_hidden_channels"]
    k, L = hp["flow_kernel_size"], hp["flow_n_layers"]
    fl = by = 0.0
    for _ in range(hp["flow_n_flows"]):
        f, b = _conv(B, T, C // 2, H, 1)
        fl, by = fl + f, by + b
        for i in range(L):
            f, b = _conv(B, T, H, 2 * H, k)
            fl, by = fl + f, by + b
            f, b = _conv(B, T, H, 2 * H if i < L - 1 else H, 1)
            fl, by = fl + f, by + b
        f, b = _conv(B, T, H, C // 2, 1)
        fl, by = fl + f, by + b
    return fl, by


def vocoder_level_costs(hp: dict, B: int, T: int) -> List[Tuple[str, float, float]]:
    U0 = hp["upsample_initial_channel"]
    out = []
    f, b = _conv(B, T, hp["inter_channels"], U0, 7)
    out.append(("vocoder.pre", f, b))
    t = T
    for i, (k, u) in enumerate(zip(hp["upsample_kernel_sizes"], hp["upsample_rates"])):
        c_in, c_out = U0 // (2 ** i), U0 // (2 ** (i + 1))
        fl, by = _conv(B, t, c_in, c_out, k, T_out=t * u)
        t *= u
        mrf_fused = hp["resblock"] != "2" and c_out <= 32
        if mrf_fused:
            by += 4.0 * 2 * B * t * c_out
        for j, kj in enumerate(hp["resblock_kernel_sizes"]):
            n_convs = len(hp["resblock_dilation_sizes"][j]) * (1 if hp["resblock"] == "2" else 2)
            for _ in range(n_convs):
                f, b = _conv(B, t, c_out, c_out, kj)
                if mrf_fused:
                    b = 4.0 * c_out * c_out * kj
                fl, by = fl + f, by + b
        out.append((f"vocoder.up{i}", fl, by))
    f, b = _conv(B, t, U0 // (2 ** len(hp["upsample_rates"])), 1, 7)
    out.append(("vocoder.post", f, b))
    return out


def pipeline_costs(hp: dict, B: int, P: int, T: int) -> List[Tuple[str, float, float]]:
    return [("encoder", *encoder_cost(hp, B, P)),
            ("duration_predictor", *duration_predictor_cost(hp, B, P)),
            ("flow", *flow_cost(hp, B, T)),
            *vocoder_level_costs(hp, B, T)]


def total_cost(hp: dict, B: int, P: int, T: int) -> Tuple[float, float]:
    stages = pipeline_costs(hp, B, P, T)
    return sum(s[1] for s in stages), sum(s[2] for s in stages)


# -- live work ------------------------------------------------------------------


def step_flops(hp: dict, rows: Iterable[Tuple[int, int]]) -> float:
    """The FLOPs of synthesizing rows of (phonemes, frames), each at its
    own live length."""
    return sum(total_cost(hp, 1, p, t)[0] for p, t in rows)


def _level_samples(hp: dict, level: int, frames: int) -> int:
    return frames * math.prod(hp["upsample_rates"][: level + 1])


def _level_width(hp: dict, level: int) -> int:
    return hp["upsample_initial_channel"] // (2 ** (level + 1))


def resblock1_work(hp: dict, groups: Iterable[List[int]], max_width: int = 64):
    """(FLOPs, bytes) of the ResBlock1 levels at most `max_width` channels
    wide over groups of rows (each a list of live frame counts), whatever
    runs them: 2 C^2 k per conv and live sample; bytes as the fused
    kernels must move them, each branch's input read and output written
    at a branch kernel's level (C > 32), the level's input read and mean
    written once where one kernel takes the whole MRF (C <= 32), at fp32,
    and each conv's weights once a group."""
    if hp["resblock"] != "1":
        return 0.0, 0.0
    fl = by = 0.0
    ks, dil = hp["resblock_kernel_sizes"], hp["resblock_dilation_sizes"]
    for frames in groups:
        for lvl in range(len(hp["upsample_rates"])):
            c = _level_width(hp, lvl)
            if c > max_width:
                continue
            n = sum(_level_samples(hp, lvl, t) for t in frames)
            for k, d in zip(ks, dil):
                fl += 2 * len(d) * 2.0 * c * c * k * n
                by += 2 * len(d) * 4.0 * (c * c * k + c)
            by += 4.0 * 2 * n * c * (1 if c <= 32 else len(ks))
    return fl, by


def bound_s(flops: float, nbytes: float, tier: str) -> float:
    """The least time the card could take: the larger of the operations at
    the tier's peak and the bytes at the HBM peak."""
    return max(flops / TIER_FLOPS[tier], nbytes / PEAK_BYTES_PER_S)
