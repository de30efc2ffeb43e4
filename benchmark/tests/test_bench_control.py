"""The control of every cell, on the card: the reference put in the
program's place one precision below the configuration's (TF32 for fp32
with TF32 off) fails one of the cell's numbers. At a small size (a few
batches, a short window's arrivals); the limits were set from the same
reading at the cell's own size (PERF.md)."""

from __future__ import annotations

import pytest

from benchmark.core import spec as specs


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", [c["name"] for c in specs.load()["workloads"]])
def test_the_control_is_not_correct(cell_name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    from benchmark.tools import readings

    cell = specs.cell(specs.load(), cell_name)
    verdict = readings.control(cell, 2 ** 31 + 77, seconds=2.0, batches=2, device="cuda")
    limits = specs.limits(cell_name)
    assert any(v > limits[k] for k, v in verdict["numbers"].items()), verdict
