"""mfu.offline: the whole step's share of the card's peak. The frozen cost
model's FLOPs of every row the window completed, at its live phonemes and
frames, over the window's wall time, against the published peak of the
vocoder's tier (the vocoder holds ~90% of the FLOPs)."""

from benchmark.metrics import _share

SOURCE, LAYER, MOVES, UNIT = "host_clock", "whole step", "audio_s_per_s", "%"


def read(ctx):
    return _share.mfu(ctx)
