"""The one traffic generator: a mix file's parameters and the run's seed
in, the requests and their schedule out.

A request's phoneme ids are the 14-id fixture phrase repeated f times and
rotated by a seeded offset (the device of `tools/serving_sim.py
--phrase-pool`): valid ids, a distinct sequence per offset, so rows differ
and no response cache could serve them. Every seed gets the same set of
sizes and the same set of gaps between arrivals, in its own order, so runs
with different seeds do the same work: sizes in exact proportion to the
mix's weights (largest remainder), gaps at the quantiles of the
exponential distribution of the mix's rate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np

# The fixture phrase (piper_tpu_torch/core/test_vector.py, FIXTURE_PHONEME_IDS).
PHRASE = (1, 20, 0, 120, 0, 61, 0, 24, 0, 59, 0, 100, 0, 2)


def phrase(factor: int, offset: int) -> List[int]:
    ids = list(PHRASE) * int(factor)
    r = int(offset) % len(ids)
    return ids[r:] + ids[:r]


def apportion(weights: Sequence[Tuple[int, float]], n: int) -> List[int]:
    """n items split over the classes in proportion to their weights, by
    largest remainder: a list of n class values."""
    w = np.asarray([p for _, p in weights], np.float64)
    share = w / w.sum() * n
    counts = np.floor(share).astype(int)
    for i in np.argsort(-(share - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return [v for (v, _), c in zip(weights, counts) for _ in range(int(c))]


def interleave(weights: Sequence[Tuple[int, float]], n: int) -> List[int]:
    """The same counts as apportion, ordered so that every prefix holds the
    classes as nearly in proportion as whole items allow."""
    counts = {v: 0 for v, _ in weights}
    for v in apportion(weights, n):
        counts[v] += 1
    out, taken = [], {v: 0 for v in counts}
    for k in range(1, n + 1):
        v = max(counts, key=lambda c: (counts[c] * k / n - taken[c], -list(counts).index(c)))
        taken[v] += 1
        out.append(v)
    return out


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *stream])


@dataclass(frozen=True)
class Batch:
    index: int
    factor: int
    ids: List[List[int]]
    seed: int  # the program's noise seed for this batch


def offline_batches(mix: dict, seed: int) -> Iterator[Batch]:
    """An endless narration job of batches of `rows` rows, one length class
    a batch, classes in the order `interleave` gives a block of
    mix["block"] batches (every prefix in the mix's proportions), each
    block started at a rotation drawn from `seed`.

    A class's phrase has len(PHRASE) distinct rotations. Each batch holds
    every one of them rows // len(PHRASE) times and rows % len(PHRASE)
    more drawn from `seed` and the batch's index, in an order drawn from
    the same: which row sits in which slot differs from batch to batch and
    seed to seed. The class's noise seed comes from the mix's
    `content_seed`: the rows of a batch share its draw, which moves every
    row's length together (and the frame bucket its longest row sets), so
    a seed of the run's own would change the batch's work. So every seed
    does the same work, in its own order."""
    pattern = interleave(mix["classes"], mix["block"])
    rows = mix["rows"]
    n = len(PHRASE)
    noise = {f: int(_rng(mix["content_seed"], 2, f).integers(0, 2 ** 32))
             for f, _ in mix["classes"]}
    k = 0
    while True:
        rot = int(_rng(seed, 1, k // len(pattern)).integers(len(pattern)))
        f = pattern[(k + rot) % len(pattern)]
        r = _rng(seed, 3, k)
        offsets = np.concatenate([np.tile(np.arange(n), rows // n),
                                  r.choice(n, size=rows % n, replace=False)])
        r.shuffle(offsets)
        yield Batch(k, f, [phrase(f, int(o)) for o in offsets], noise[f])
        k += 1


@dataclass(frozen=True)
class Arrival:
    index: int
    due: float  # seconds after the schedule's start
    factor: int
    ids: List[int]


def open_loop(rate: float, seconds: float, weights: Sequence[Tuple[int, float]],
              seed: int, stream: int = 0, schedule_seed=None) -> List[Arrival]:
    """Poisson arrivals at `rate` for `seconds`: round(rate * seconds)
    requests, their gaps the exponential quantiles (i + 0.5) / n and their
    sizes apportioned to `weights`, both in an order drawn from
    `schedule_seed` (a mix's: one realization for every run) and rotated
    by an offset drawn from `seed`, or with no `schedule_seed` in an order
    drawn from `seed`. Each request's phrase rotation comes from `seed`.
    A tail latency depends on the order (a cluster of long requests is a
    surge), so a fixed realization keeps every seed's work the same."""
    n = max(1, int(round(rate * seconds)))
    r = _rng(seed, 10 + stream)
    order = r if schedule_seed is None else _rng(schedule_seed, 10 + stream)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps = gaps * (seconds / gaps.sum())  # the last one lands at the end
    order.shuffle(gaps)
    sizes = np.asarray(apportion(weights, n))
    order.shuffle(sizes)
    if schedule_seed is not None:
        k = int(_rng(seed, 20 + stream).integers(n))
        gaps, sizes = np.roll(gaps, k), np.roll(sizes, k)
    due = np.cumsum(gaps) - gaps[0]
    out = []
    for i in range(n):
        f = int(sizes[i])
        out.append(Arrival(i, float(due[i]), f,
                           phrase(f, int(r.integers(0, len(PHRASE) * f)))))
    return out


def percentile(values: Sequence[float], p: float) -> float:
    """The p-th percentile by the nearest-rank rule; inf counts as the
    largest (a failed request misses every limit)."""
    v = sorted(values)
    if not v:
        return math.nan
    k = max(0, math.ceil(p / 100.0 * len(v)) - 1)
    return float(v[k])
