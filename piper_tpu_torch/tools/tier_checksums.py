"""Checksums of K1-K4's outputs at the bf16 tiers, on a card.

    python -m piper_tpu_torch.tools.tier_checksums
    PYTHONPATH=<another checkout> python3 piper_tpu_torch/tools/tier_checksums.py

Makes fixed inputs from seed 0 at the medium voice's shapes (K2's three
branches at C=64, N = 128 frames' samples; K3 at C=32; K4 at fold 2, C=64
and fold 4, C=32), then at the x_low voice's (K1's six ResBlock2 convs at
level 1, C=64, and level 2, C=32, act_slope 0.1), B=2 with two-sided
bounds, runs each kernel at "high" and "default" and prints one JSON line:
{tier: {kernel: sha256 of its outputs' fp32 bytes}}. K2-K4's inputs are
drawn first, so their checksums compare with those of a tree that had no
K1 case. The kernels are deterministic, so two checkouts
whose checksums agree on one card compute the same bits; the second form
above runs this file against another checkout's package (its kernels built
under that checkout). chip_smoke.py prints the same line in its kernel
phase.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

TIERS = ("high", "default")
DILATIONS = (1, 3, 5)


def checksums(tiers=TIERS) -> dict:
    import torch

    from piper_tpu_torch.ops.kernels import conv as K1
    from piper_tpu_torch.ops.kernels import folded as K4
    from piper_tpu_torch.ops.kernels import resblock as R
    from piper_tpu_torch.tools.conv1d_probe import X_LOW_CONVS

    if not torch.cuda.is_available():
        raise RuntimeError("tier_checksums runs the kernels on a CUDA card")
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda")

    def branches(c):
        out = []
        for k in (3, 7, 11):
            s = (c * k) ** -0.5
            out.append((rand(3, c, c, k, scale=s), rand(3, c, scale=0.02),
                        rand(3, c, c, k, scale=s), rand(3, c, scale=0.02), k, DILATIONS))
        return out

    def bounds(n):
        return torch.tensor([[37, n - 401], [0, n // 3]], dtype=torch.int32, device="cuda")

    cases = []
    for c, n in ((64, 128 * 128), (32, 128 * 256)):
        cases.append((c, n, branches(c), rand(2, c, n, scale=0.3)))
    k1_cases = []
    for c, n in ((64, 128 * 64), (32, 128 * 256)):
        convs = [(rand(c, c, k, scale=(c * k) ** -0.5), rand(c, scale=0.02), d)
                 for k, d in X_LOW_CONVS]
        k1_cases.append((n, convs, rand(2, c, n, scale=0.3)))

    def k2(tier):
        _, n, brs, x = cases[0]
        return [R.resblock1_branch(x, *b[:4], kernel=b[4], dilations=b[5], bounds=bounds(n),
                                   precision=tier) for b in brs]

    def k3(tier):
        _, n, brs, x = cases[1]
        return [R.resblock1_mrf(x, brs, bounds=bounds(n), precision=tier)]

    def k4(tier):
        return [K4.resblock1_mrf_folded(x, brs, fold=fold, bounds=bounds(n), precision=tier)
                for (_, n, brs, x), fold in zip(cases, (2, 4))]

    def k1(tier):
        return [K1.conv1d_same(x, w, b, dilation=d, act_slope=0.1, bounds=bounds(n),
                               precision=tier) for n, convs, x in k1_cases for w, b, d in convs]

    out = {}
    with torch.inference_mode():
        for tier in tiers:
            out[tier] = {}
            for name, run in (("resblock1_branch", k2), ("resblock1_mrf", k3),
                              ("resblock1_mrf_folded", k4), ("conv1d_same", k1)):
                h = hashlib.sha256()
                for t in run(tier):
                    h.update(t.float().contiguous().cpu().numpy().tobytes())
                out[tier][name] = h.hexdigest()
    return out


def main() -> dict:
    import torch

    import piper_tpu_torch
    from piper_tpu_torch.ops.kernels import build

    result = {"device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else None,
              "checksums": checksums(),
              "package": str(Path(piper_tpu_torch.__file__).resolve().parent),
              "library": str(build.library_path())}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
