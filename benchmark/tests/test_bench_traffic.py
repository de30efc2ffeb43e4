"""The generator: the same seed gives the same traffic, and every seed the
same sizes and gaps in its own order."""

from __future__ import annotations

import itertools

import pytest

from benchmark.core import spec as specs
from benchmark.core import traffic

SEEDS = [0, 7, 2 ** 31 + 11, 2 ** 33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_offline_batches_repeat_from_the_seed(seed):
    mix = specs.mix("offline")
    a = list(itertools.islice(traffic.offline_batches(mix, seed), 12))
    b = list(itertools.islice(traffic.offline_batches(mix, seed), 12))
    assert [(x.factor, x.ids, x.seed) for x in a] == [(x.factor, x.ids, x.seed) for x in b]
    assert all(len(x.ids) == mix["rows"] for x in a)
    assert all(0 <= x.seed < 2 ** 32 for x in a)


def test_offline_every_seed_sends_the_same_work_in_its_own_order():
    """Every seed: a block holds the same classes, each class one noise
    seed, every batch every rotation of its phrase rows // 14 times; the
    rows' slots and the few extra rotations differ from batch to batch
    and seed to seed."""
    mix = specs.mix("offline")
    n = len(traffic.PHRASE)
    blocks, slots = [], set()
    for seed in SEEDS:
        bs = list(itertools.islice(traffic.offline_batches(mix, seed), mix["block"]))
        blocks.append(sorted((b.factor, b.seed) for b in bs))
        for b in bs:
            rotations = [tuple(x) for x in b.ids]
            for r in range(n):
                assert rotations.count(tuple(traffic.phrase(b.factor, r))) >= mix["rows"] // n
            slots.add((b.factor, tuple(rotations)))
    assert all(b == blocks[0] for b in blocks)
    assert len(slots) == len(SEEDS) * mix["block"]
    orders = {tuple(b.factor for b in itertools.islice(traffic.offline_batches(mix, s), 20))
              for s in SEEDS}
    assert len(orders) > 1


def test_offline_every_block_keeps_the_mix():
    mix = specs.mix("offline")
    for seed in SEEDS:
        fs = [b.factor for b in itertools.islice(traffic.offline_batches(mix, seed), 40)]
        for k in (0, 20):
            block = fs[k:k + 20]
            assert sorted(block) == sorted(traffic.apportion(mix["classes"], 20))


@pytest.mark.parametrize("seed", SEEDS)
def test_open_loop_repeats_and_shares_sizes_and_gaps_across_seeds(seed):
    mix = specs.mix("served")
    a = traffic.open_loop(200.0, 5.0, mix["length_mix"], seed)
    b = traffic.open_loop(200.0, 5.0, mix["length_mix"], seed)
    assert [(x.due, x.ids) for x in a] == [(x.due, x.ids) for x in b]
    c = traffic.open_loop(200.0, 5.0, mix["length_mix"], seed + 1)
    assert sorted(x.factor for x in a) == sorted(x.factor for x in c)
    assert len(a) == 1000 and a[0].due == 0.0
    assert abs(a[-1].due - c[-1].due) < 0.2


def test_a_fixed_schedule_is_the_same_realization_rotated():
    mix = specs.mix("served")
    a = traffic.open_loop(100.0, 5.0, mix["length_mix"], 1, schedule_seed=mix["schedule_seed"])
    b = traffic.open_loop(100.0, 5.0, mix["length_mix"], 2, schedule_seed=mix["schedule_seed"])
    fa, fb = [x.factor for x in a], [x.factor for x in b]
    assert fa != fb and any(fa == fb[k:] + fb[:k] for k in range(len(fb)))


def test_phrase_rotation_keeps_the_ids():
    for f in (1, 2, 16):
        for off in (0, 5, 13, 100):
            ids = traffic.phrase(f, off)
            assert sorted(ids) == sorted(list(traffic.PHRASE) * f)


def test_percentile_counts_a_failure_as_the_latest():
    assert traffic.percentile([1.0] * 94 + [float("inf")] * 6, 95) == float("inf")
    assert traffic.percentile([1.0] * 96 + [float("inf")] * 4, 95) == 1.0
