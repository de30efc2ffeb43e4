"""tools/resblock_probe.py on the CPU: its shapes, its arguments and the
bytes and FLOPs behind its bounds, run through the kernels' plain versions
(the wrappers take them on a CPU tensor). Its times exist only on a card."""

import pytest
import torch

from piper_tpu_torch.tools import resblock_probe as P

TINY = ["--device", "cpu", "--frames", "2", "--batch", "2", "--bucket", "3", "--live", "2"]


def test_probe_shapes_follow_the_main_path():
    """b1: one row of 128 frames ending 100 samples early (chip_smoke's
    timed call); b32: 32 rows of the bucket's 192 frames, live to 162 (the
    layer split's); K2 at C=64, 128 samples a frame, K3 at C=32, 256."""
    args = P._parser().parse_args([])
    got = P.shapes(args)
    assert list(got) == ["b1", "b32"]
    assert got["b1"][:2] == (1, 128) and got["b1"][2](128) == 128 * 128 - 100
    assert got["b32"][:2] == (32, 192) and got["b32"][2](256) == 162 * 256
    assert P.KERNELS == (("resblock1_branch", 64, 128), ("resblock1_mrf", 32, 256))
    assert args.precision.split(",") == ["highest", "high", "default", "bfloat16"]
    with pytest.raises(SystemExit, match="unknown shape"):
        P.shapes(P._parser().parse_args(["--shapes", "b7"]))


def test_probe_work_is_one_read_and_write_and_the_live_products():
    nbytes, flops = P.work(64, 16384, 1, 16284, 3, 4)
    weights = sum(6 * (64 * 64 * k + 64) for k in (3, 7, 11))
    assert nbytes == 4 * (64 * 16384 * 4 + weights)
    assert flops == 2 * 64 * 64 * 21 * 6 * 16284
    assert P.work(32, 100, 2, 50, 1, 2) == (2 * (2 * 32 * 100 * 2 + sum(
        6 * (32 * 32 * k + 32) for k in (3, 7, 11))), 2 * 32 * 32 * 21 * 6 * 50 * 2)


def test_probe_runs_the_plain_versions_on_the_cpu(capsys):
    """Every (tier, shape, kernel) once through the wrappers on the CPU: a
    row with its bound and no time, outputs checked in the probe; then a
    summary with no sums (nothing was timed)."""
    rows = P.main(TINY)
    out = [r for r in rows if "kernel" in r]
    assert len(out) == 4 * 2 * 2
    assert {(r["precision"], r["shape"], r["kernel"]) for r in out} == {
        (t, s, k) for t in ("highest", "high", "default", "bfloat16") for s in ("b1", "b32")
        for k in ("resblock1_branch", "resblock1_mrf")}
    for r in out:
        assert r["device"] == "cpu" and r["bound_ms"] > 0 and "kernel_ms" not in r
        assert r["launches_per_call"] == (3 if r["kernel"] == "resblock1_branch" else 1)
    assert rows[-1]["k2_plus_k3"] == {} and rows[-1]["device"] == "cpu"
    assert len(capsys.readouterr().out.strip().splitlines()) == len(rows)


def test_probe_needs_a_card_for_times(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        P.main(["--shapes", "b1"])
