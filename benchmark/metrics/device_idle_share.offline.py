"""device_idle_share.offline: the share of the traced window's wall time in
which no operation ran on the card (torch.profiler, behind the sentinels)."""

from benchmark.metrics import _share

SOURCE, LAYER, MOVES, UNIT = "device_trace", "device", "audio_s_per_s", "%"


def read(ctx):
    return _share.idle_share(ctx)
