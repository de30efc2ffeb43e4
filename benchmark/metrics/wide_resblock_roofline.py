"""wide_resblock_roofline: K1's wide design (ops/kernels/conv.py,
csrc/conv1d_wide.cu) against its roofline. The work of the ResBlock1
levels wider than 64 channels (piper_high's C = 256 and 128), counted from
shapes at live samples, whatever runs it, over the device time of the
kernels whose symbol holds "conv1d_" in the traced window: in piper_high's
cells only those levels launch K1 (K2/K3, "resblock1_kernel", take the
narrower ones). Nothing where no such kernel ran, as on a program that
sends those levels to a library conv."""

from benchmark.core import costs
from benchmark.metrics import _share

SOURCE, LAYER, MOVES, UNIT = "device_trace", "kernels", "audio_s_per_s", "%"


def work(hp: dict, groups):
    """(FLOPs, bytes) of the ResBlock1 levels wider than 64 channels: all
    of them less those at most 64 wide (`costs.resblock1_work`)."""
    groups = [list(g) for g in groups]
    every = costs.resblock1_work(hp, groups, max_width=hp["upsample_initial_channel"])
    narrow = costs.resblock1_work(hp, groups, max_width=64)
    return every[0] - narrow[0], every[1] - narrow[1]


def read(ctx):
    return _share.roofline(ctx, work, "conv1d_")
