"""Static shape buckets (the port's own copy of piper_tpu.engine.bucketing).

Importing the JAX package's module would import jax (its `engine/__init__`
loads the runtime), so the ladders live here too. They must stay equal to
the reference's: the tests compare the two.

Eager PyTorch compiles nothing per shape, but padding lengths onto the same
ladder keeps the port's tensors shaped exactly like the reference's, so the
two runtimes compare like with like (and CUDA graphs, later, need a bounded
set of shapes).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

DEFAULT_PHONEME_BUCKETS: List[int] = [16, 32, 64, 128, 256, 512, 1024, 2048, 4096]
DEFAULT_FRAME_BUCKETS: List[int] = [
    32, 64, 96, 128, 192, 256, 320, 384, 512, 640, 768, 1024, 1536, 2048,
    3072, 4096, 6144, 8192, 12288, 16384, 24576, 32768,
]


class BucketOverflowError(ValueError):
    def __init__(self, value: int, largest: int, what: str):
        super().__init__(
            f"{what} length {value} exceeds the largest bucket {largest}; "
            f"raise the bucket ladder or split the input"
        )
        self.value = value
        self.largest = largest


def bucket_for(value: int, buckets: Sequence[int], what: str = "sequence") -> int:
    """Smallest bucket >= value."""
    for b in buckets:
        if value <= b:
            return b
    raise BucketOverflowError(value, buckets[-1], what)


def pad_to(seq, bucket: int, fill=0) -> np.ndarray:
    """Pad a 1-D python list/array to `bucket` with `fill`."""
    arr = np.asarray(seq)
    if arr.shape[0] > bucket:
        raise ValueError(f"sequence of length {arr.shape[0]} does not fit bucket {bucket}")
    out = np.full((bucket,), fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out
