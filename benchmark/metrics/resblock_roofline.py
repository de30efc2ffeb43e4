"""resblock_roofline: K2/K3 (ops/kernels/resblock.py, csrc/resblock1*.cu)
against their roofline. The work of the ResBlock1 levels at most 64
channels wide, counted from shapes at live samples, whatever runs it, over
the device time of the resblock1 kernels in the traced window."""

from benchmark.core import costs
from benchmark.metrics import _share

SOURCE, LAYER, MOVES, UNIT = "device_trace", "kernels", "audio_s_per_s", "%"


def read(ctx):
    return _share.roofline(ctx, costs.resblock1_work, "resblock1_kernel")
