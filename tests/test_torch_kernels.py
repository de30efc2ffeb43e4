"""The plain versions of the port's kernels (K1 conv1d_same, the ResBlock1
K2/K3, the folded MRF K4, the interleave K5) against the Pallas kernels they
replace, run in interpret mode on the CPU (the cases of
tests/test_pallas_kernels.py), or against what the kernel computes where no
test can reach it (K5).
Tolerance 1e-5 max-abs at the "highest" and "high" tiers: the same exact
products, summed in another order. 2e-3 at "default": one bf16 rounding of
a conv's input can land on the other side of a rounding edge in the two
versions, and the flip propagates through up to six chained convs. The CUDA
kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py). At "highest" K2-K4 form their products as 3xTF32: an
emulation of that chain here is held to the Pallas kernels' fp32 within
2e-5, the module bar.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piper_tpu.ops.pallas.conv import pallas_conv1d_same
from piper_tpu.ops.pallas.folded import (
    fold_time_axis as j_fold,
    pallas_resblock1_mrf_folded,
    unfold_time_axis as j_unfold,
)
from piper_tpu.ops.pallas.resblock import pallas_resblock1_branch, pallas_resblock1_mrf
from piper_tpu_torch.ops.kernels import conv as K1
from piper_tpu_torch.ops.kernels import folded as K4
from piper_tpu_torch.ops.kernels import interleave as K5
from piper_tpu_torch.ops.kernels import resblock as R
from piper_tpu_torch.ops.kernels.precision import (split_bf16, split_tf32, tier_code,
                                                    tiered_conv1d)
from piper_tpu_torch.tools import timing

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-5
TIER_ATOL = {"highest": ATOL, "high": ATOL, "default": 2e-3}


def _branch_weights(rng, ch, k, m):
    w1 = (rng.standard_normal((m, ch, ch, k)) / np.sqrt(ch * k)).astype(np.float32)
    b1 = (rng.standard_normal((m, ch)) * 0.02).astype(np.float32)
    w2 = (rng.standard_normal((m, ch, ch, k)) / np.sqrt(ch * k)).astype(np.float32)
    b2 = (rng.standard_normal((m, ch)) * 0.02).astype(np.float32)
    return w1, b1, w2, b2


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _branch_both(x, ws, k, dils, bounds, tile, precision="highest"):
    got = R.resblock1_branch_plain(torch.from_numpy(x), *_t(ws), kernel=k, dilations=dils,
                                   bounds=None if bounds is None else torch.from_numpy(bounds),
                                   precision=precision)
    want = pallas_resblock1_branch(jnp.asarray(x), *_j(ws), kernel=k, dilations=dils,
                                   bounds=None if bounds is None else jnp.asarray(bounds),
                                   tile=tile, interpret=True, precision=precision)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize(
    "ch,k,dils,n,bnd",
    [
        (32, 11, (1, 3, 5), 700, None),
        (32, 3, (1, 3, 5), 300, 211),
        (64, 7, (1, 3, 5), 512, 400),
        (32, 11, (1, 2), 256, 100),
    ],
)
def test_branch_plain_matches_pallas(ch, k, dils, n, bnd):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, ch, n)).astype(np.float32) * 0.3
    ws = _branch_weights(rng, ch, k, len(dils))
    bounds = None if bnd is None else np.array([bnd, n], np.int32)
    got, want = _branch_both(x, ws, k, dils, bounds, tile=512)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_branch_plain_two_sided_bounds(precision):
    rng = np.random.default_rng(1)
    ch, k, dils, n = 32, 7, (1, 3), 512
    x = rng.standard_normal((2, ch, n)).astype(np.float32) * 0.3
    bounds = np.array([[37, 401], [0, 512]], np.int32)
    got, want = _branch_both(x, _branch_weights(rng, ch, k, len(dils)), k, dils, bounds, 256,
                             precision)
    np.testing.assert_allclose(got, want, atol=TIER_ATOL[precision], rtol=0)
    assert np.all(got[0, :, :37] == 0.0) and np.all(got[0, :, 401:] == 0.0)


def test_branch_plain_dead_tiles_are_zero():
    """Row 0 ends at 150: the Pallas kernel skips tiles 1..3 (tile 256) and
    writes zeros; the plain version's output there is exactly zero too."""
    rng = np.random.default_rng(4)
    ch, k, dils, n = 32, 7, (1, 3), 1024
    x = rng.standard_normal((2, ch, n)).astype(np.float32) * 0.3
    bounds = np.array([[0, 150], [0, 1024]], np.int32)
    got, want = _branch_both(x, _branch_weights(rng, ch, k, len(dils)), k, dils, bounds, 256)
    assert np.all(got[0, :, 150:] == 0.0) and np.all(want[0, :, 256:] == 0.0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _mrf_branches(rng, ch, dils=(1, 3, 5)):
    return [(*_branch_weights(rng, ch, k, len(dils)), k, dils) for k in (3, 7, 11)]


@pytest.mark.parametrize("bnd,precision", [
    (None, "highest"), ([700, 1000], "highest"), ([[37, 401], [0, 1000]], "highest"),
    ([[37, 401], [0, 1000]], "high"), ([[37, 401], [0, 1000]], "default"),
])
def test_mrf_plain_matches_pallas(bnd, precision):
    """Three branches (kernels 3/7/11, dilations 1/3/5) and their mean."""
    rng = np.random.default_rng(7)
    ch, n = 32, 1000
    x = rng.standard_normal((2, ch, n)).astype(np.float32) * 0.3
    branches = _mrf_branches(rng, ch)
    bounds = None if bnd is None else np.asarray(bnd, np.int32)
    got = R.resblock1_mrf_plain(
        torch.from_numpy(x), [(*_t(b[:4]), b[4], b[5]) for b in branches],
        bounds=None if bounds is None else torch.from_numpy(bounds), precision=precision)
    want = pallas_resblock1_mrf(
        jnp.asarray(x), [(*_j(b[:4]), b[4], b[5]) for b in branches],
        bounds=None if bounds is None else jnp.asarray(bounds), tile=256, interpret=True,
        precision=precision)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TIER_ATOL[precision], rtol=0)


def test_mrf_plain_is_mean_of_branches():
    rng = np.random.default_rng(8)
    ch, n = 16, 640
    x = torch.from_numpy(rng.standard_normal((1, ch, n)).astype(np.float32) * 0.3)
    branches = [(*_t(b[:4]), b[4], b[5]) for b in _mrf_branches(rng, ch)]
    bounds = torch.tensor([500], dtype=torch.int32)
    got = R.resblock1_mrf_plain(x, branches, bounds=bounds)
    ys = [R.resblock1_branch_plain(x, *b[:4], kernel=b[4], dilations=b[5], bounds=bounds)
          for b in branches]
    np.testing.assert_allclose(got.numpy(), (sum(ys) / len(ys)).numpy(), atol=1e-6, rtol=0)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(9)
    ch, n = 16, 200
    x = torch.from_numpy(rng.standard_normal((2, ch, n)).astype(np.float32))
    br = _t(_branch_weights(rng, ch, 5, 2))
    bounds = torch.tensor([[3, 150], [0, 200]], dtype=torch.int32)
    before = (R.resblock1_branch.launches, R.resblock1_mrf.launches)
    got = R.resblock1_branch(x, *br, kernel=5, dilations=(1, 2), bounds=bounds)
    want = R.resblock1_branch_plain(x, *br, kernel=5, dilations=(1, 2), bounds=bounds)
    assert torch.equal(got, want)
    got = R.resblock1_mrf(x, [(*br, 5, (1, 2))], bounds=bounds)
    assert torch.equal(got, R.resblock1_mrf_plain(x, [(*br, 5, (1, 2))], bounds=bounds))
    assert (R.resblock1_branch.launches, R.resblock1_mrf.launches) == before


def test_no_fallback_off_cpu_and_only_the_fp32_tier():
    """A tensor that is neither on the CPU nor on a card is refused, not
    quietly computed elsewhere; a tier that does not exist is refused."""
    x = torch.empty((1, 16, 64), device="meta")
    w = torch.empty((1, 16, 16, 3), device="meta")
    b = torch.empty((1, 16), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        R.resblock1_branch(x, w, b, w, b, kernel=3, dilations=(1,))
    with pytest.raises(ValueError, match="cpu or cuda"):
        R.resblock1_mrf(x, [(w, b, w, b, 3, (1,))])
    xc = torch.zeros((1, 16, 64))
    wc, bc = torch.zeros((1, 16, 16, 3)), torch.zeros((1, 16))
    with pytest.raises(ValueError, match="highest"):
        R.resblock1_branch(xc, wc, bc, wc, bc, kernel=3, dilations=(1,), precision="float32")
    with pytest.raises(ValueError, match="highest"):
        R.resblock1_mrf(xc, [(wc, bc, wc, bc, 3, (1,))], precision="tensorfloat32")


def test_import_needs_no_nvcc_or_triton():
    """Importing the wrappers and running them on CPU tensors builds and
    loads nothing, with no CUDA toolkit on PATH."""
    code = (
        "import pathlib, sys, torch\n"
        "d = pathlib.Path('build/piper_tpu_torch')\n"
        "before = sorted(d.glob('*'))\n"
        "from piper_tpu_torch.ops.kernels import build, resblock as R\n"
        "x = torch.zeros(1, 8, 32); w = torch.zeros(1, 8, 8, 3); b = torch.zeros(1, 8)\n"
        "R.resblock1_branch(x, w, b, w, b, kernel=3, dilations=(1,))\n"
        "assert build._lib is None and sorted(d.glob('*')) == before\n"
        "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH="/nonexistent", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_branch_halo_figures():
    """The one-sided halo is sum((k-1)//2*d + (k-1)//2): 12, 36 and 60
    samples for k = 3, 7, 11 at dilations 1/3/5."""
    assert [R.branch_halo(k, (1, 3, 5)) for k in (3, 7, 11)] == [12, 36, 60]


@pytest.mark.parametrize("ch,k,d,n,slope,with_bias", [
    (32, 11, 5, 1000, 0.0, True),   # the cases of tests/test_pallas_kernels.py
    (32, 3, 1, 300, 0.1, True),
    (64, 7, 3, 2048, 0.1, True),
    (64, 7, 12, 700, 0.1, True),    # x_low level 1, widest reach (36 per side)
    (32, 5, 6, 900, 0.1, True),     # x_low level 2
    (32, 7, 3, 333, 0.1, False),
])
def test_conv1d_same_plain_matches_pallas(ch, k, d, n, slope, with_bias):
    rng = np.random.default_rng(k * 100 + d)
    x = rng.standard_normal((2, ch, n)).astype(np.float32)
    w = (rng.standard_normal((ch, ch, k)) * 0.05).astype(np.float32)
    bias = rng.standard_normal((ch,)).astype(np.float32) if with_bias else None
    got = K1.conv1d_same_plain(torch.from_numpy(x), torch.from_numpy(w),
                               None if bias is None else torch.from_numpy(bias),
                               dilation=d, act_slope=slope)
    want = pallas_conv1d_same(jnp.asarray(x), jnp.asarray(w),
                              None if bias is None else jnp.asarray(bias),
                              dilation=d, act_slope=slope, tile=512, interpret=True)
    assert got.shape == (2, ch, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("bounds", [None, [60, 100], [[3, 70], [0, 100]]],
                         ids=["none", "one_sided", "two_sided"])
def test_conv1d_same_cpu_runs_the_plain_version_and_counts_no_launch(bounds):
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, 16, 100)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 16, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    bnd = None if bounds is None else torch.tensor(bounds, dtype=torch.int32)
    before = K1.conv1d_same.launches
    got = K1.conv1d_same(x, w, b, dilation=2, act_slope=0.1, bounds=bnd)
    assert torch.equal(got, K1.conv1d_same_plain(x, w, b, dilation=2, act_slope=0.1, bounds=bnd))
    assert K1.conv1d_same.launches == before


# Row bounds of a (2, C, 900) input: one-sided (B,), two-sided (B, 2), empty
# rows (lo >= hi) and the whole length (past N, clamped).
K1_BOUNDS = {
    "one_sided": [900, 433],
    "two_sided": [[37, 401], [0, 900]],
    "empty": [[500, 500], [0, 0]],
    "full": [[0, 900], [-5, 2000]],
}


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("case", list(K1_BOUNDS))
def test_conv1d_same_plain_bounds_match_pallas_on_the_masked_input(case, precision):
    """With bounds, K1 is the TPU kernel on x * mask (mask 1 on [lo, hi)):
    lrelu(x * m) = lrelu(x) * m for a 0/1 mask. The output is not masked."""
    rng = np.random.default_rng(31)
    ch, k, d, n = 32, 7, 3, 900
    x = rng.standard_normal((2, ch, n)).astype(np.float32)
    w = (rng.standard_normal((ch, ch, k)) * 0.05).astype(np.float32)
    bias = rng.standard_normal((ch,)).astype(np.float32)
    bnd = np.asarray(K1_BOUNDS[case], np.int32)
    b2 = np.clip(np.stack([np.zeros_like(bnd), bnd], 1) if bnd.ndim == 1 else bnd, 0, n)
    pos = np.arange(n)
    mask = ((pos >= b2[:, :1]) & (pos < b2[:, 1:]))[:, None, :].astype(np.float32)
    got = K1.conv1d_same_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                               dilation=d, act_slope=0.1, bounds=torch.from_numpy(bnd),
                               precision=precision)
    want = pallas_conv1d_same(jnp.asarray(x * mask), jnp.asarray(w), jnp.asarray(bias),
                              dilation=d, act_slope=0.1, tile=512, interpret=True,
                              precision=precision)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TIER_ATOL[precision], rtol=0)
    if case == "empty":  # a row with no valid input is the bias everywhere
        np.testing.assert_array_equal(got.numpy()[1], np.broadcast_to(bias[:, None], (ch, n)))


def test_conv1d_same_kernel_bounds_layout():
    """The bounds as the kernel reads them: (B,) one column, (B, 2) two,
    int32, with no copy when they already are; any other shape raises."""
    one = torch.tensor([5, 7], dtype=torch.int32)
    t, cols = K1._kernel_bounds(one, 2, one.device)
    assert cols == 1 and t.data_ptr() == one.data_ptr()
    t, cols = K1._kernel_bounds([[1, 5], [0, 7]], 2, one.device)
    assert cols == 2 and t.dtype == torch.int32 and t.tolist() == [[1, 5], [0, 7]]
    assert K1._kernel_bounds(None, 2, one.device) == (None, 0)
    with pytest.raises(ValueError, match="bounds must be"):
        K1._kernel_bounds(torch.zeros(3, 2), 2, one.device)


def test_k1_shared_memory_figures():
    """K1's shared memory (csrc/conv1d.cuh::smem_bytes): 1024 bytes to align
    the ring, min(ring, chunks) slots of `chunk` taps' images (rounded to
    1024) and their barriers (128), then the window's act(x) planes of C
    rounded up to 16 channels by tile + 2*pad + 1 lanes and a guard of 16
    bytes for each row of the last warpgroup past the tile, or the fp32
    output stage (C rows of the tile rounded to 16k + 4) where that is
    larger. "highest": tf32 big and small planes (fp32 words) and a 32 KB
    tap at C=64; "high" bf16 hi and lo; "default" one bf16 plane; past 32
    KB a tap the ring's unit is one swizzle atom of it."""
    # x_low level 1's widest conv (C=64, k=7, d=12: pad 36), tile 64
    assert K1.smem_bytes(64, 7, 36, 64, 0, 2, 2) == (
        1024 + 2 * 2 * 32768 + 128 + 2 * 4 * 64 * (64 + 72 + 1)) == 202368
    assert K1.smem_bytes(64, 7, 36, 64, 1, 1, 7) == (
        1024 + 7 * 16384 + 128 + 2 * 2 * 64 * 137) == 150912
    # level 2 (C=32), tile 256 at "default": the stage (32 x 260 floats) is the larger
    assert K1._stage_stride(256) == 260 and K1._stage_stride(64) == 68
    assert K1.smem_bytes(32, 7, 36, 256, 2, 3, 7) == (
        1024 + 14336 + 128 + max(2 * 32 * 329, 4 * 32 * 260)) == 48768
    # C=24 runs as 32 zero-padded channels; the stage keeps its 24 rows
    assert K1.smem_bytes(24, 3, 1, 64, 1, 2, 3) == (
        1024 + 12288 + 128 + max(2 * 2 * 32 * 67, 4 * 24 * 68)) == 22016
    # C=120 at "highest" (128 padded channels, 128 KB a tap): a unit is one
    # 32 KB atom; at tile 32 the last warpgroup's 32 rows past it read the guard
    assert [R._tap_units(128, t) for t in (0, 1, 2)] == [4, 2, 1]
    assert K1.smem_bytes(120, 11, 25, 32, 0, 2, 2) == (
        1024 + 2 * 65536 + 128 + 2 * 4 * 128 * 83 + 16 * 32) == 217728
    assert K1.smem_bytes(120, 11, 25, 64, 0, 2, 2) > 232448


class _K1Props:
    shared_memory_per_block_optin = 232448
    multi_processor_count = 132


def test_k1_configs_fit_every_square_width(monkeypatch):
    """Every square C from 1 to 128 has a (tile, warpgroups, ring, chunk) at
    every tier for x_low's widest conv (k=7, d=12) and the ResBlock1
    branch's widest (k=11, d=5), each within 232,448 bytes, a tile of at
    most 256 samples in a block of its own warpgroups or four, and a ring
    of one slot for a conv of one chunk, else 2-3 slots but at most the
    conv's chunks (one slot for two chunks would wait on itself); a window
    no tile fits raises."""
    monkeypatch.setattr(K1, "_props", lambda device: _K1Props())
    for tier in (0, 1, 2):
        for c in range(1, 129):
            for k, d in ((7, 12), (11, 5)):
                pad = (k - 1) // 2 * d
                x = torch.empty((1, c, 4096), device="meta")
                found = K1.configs(x, k, pad, 4096, tier)
                units = k * R._tap_units(K1._padded(c), tier)
                assert found and all(
                    t <= 256 and g in (-(-t // 64), 4) and (r == 1) == (ch == units)
                    and r <= -(-units // ch) and K1.smem_bytes(c, k, pad, t, tier, r, ch) <= 232448
                    for t, g, r, ch in found), (tier, c, k)
                assert K1.pick_config(x, k, pad, 4096, tier) in found
    with pytest.raises(ValueError, match="shared memory"):
        K1.pick_config(torch.empty((1, 128, 4096), device="meta"), 11, 150, 4096, 0)


def test_k1_tile_rule_at_x_low_shapes(monkeypatch):
    """The tile rule at x_low's levels, as the H100 sweep ranked them. At
    B=1 (128 frames) blocks of four warpgroups: level 1 (C=64, N=8192) in
    128 blocks of 64 samples, level 2 (C=32, N=32768) in 256 of 128, each
    conv in one chunk where it fits ("highest" at C=64: 32 KB a tap, so k=7
    takes chunks of two taps in two slots). At the serving batch (B=32,
    T=384) tiles of 128 in blocks of two warpgroups, then the most blocks
    an SM holds: the whole conv in one slot at "default", slots of one tap
    at "highest" C=32 (three blocks an SM where the whole conv allows two);
    at "highest" C=64, where no 128-sample block shares its SM, the fewest
    window lanes an SM (tiles of 192-256). A tile cap takes the nearest
    tile under it."""
    monkeypatch.setattr(K1, "_props", lambda device: _K1Props())

    def pick(b, c, n, k, d, tier, tile=4096):
        return K1.pick_config(torch.empty((b, c, n), device="meta"), k, (k - 1) // 2 * d, tile,
                              tier)

    for tier in (0, 1, 2):
        assert pick(1, 64, 8192, 3, 1, tier) == (64, 4, 1, 3)
        assert pick(1, 32, 32768, 7, 12, tier) == (128, 4, 1, 7)
    assert pick(1, 64, 8192, 7, 12, 1) == (64, 4, 1, 7)
    assert pick(1, 64, 8192, 7, 12, 0) == (64, 4, 2, 2)
    assert pick(32, 64, 384 * 64, 7, 12, 2) == (128, 2, 1, 7)
    assert pick(32, 32, 384 * 256, 7, 12, 1) == (128, 2, 1, 7)
    assert pick(32, 32, 384 * 256, 7, 12, 0) == (128, 2, 2, 1)
    assert pick(32, 64, 384 * 64, 7, 12, 0) == (192, 3, 2, 1)
    assert pick(32, 64, 384 * 64, 7, 3, 0) == (256, 4, 2, 1)
    assert K1._resident(32, 69 * 1024, 2, 233472) == 3
    assert K1._resident(64, 40 * 1024, 2, 233472) == 2  # registers: 128 a thread
    assert pick(1, 32, 32768, 7, 12, 1, tile=64) == (64, 4, 1, 7)
    assert pick(2, 16, 1000, 3, 1, 2, tile=32) == (32, 4, 1, 3)


def test_k1_weight_image_is_laid_out_once():
    """K1's weights: wgmma_tier_image of the weights zero-padded to C
    rounded up to 16, laid out once per (weight tensor, tier) and reused;
    an in-place update lays it out again; an inference tensor, which keeps
    no version counter, is cached against its identity; the cache drops an
    entry with its tensor."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.standard_normal((24, 24, 5)) * 0.1).astype(np.float32))
    img = K1.weight_image(w, 1)
    padded = torch.nn.functional.pad(w, (0, 0, 0, 8, 0, 8))
    assert img.shape == (1, 5, 2, 32, 32)
    assert torch.equal(img, R.wgmma_tier_image(padded[None], 1))
    assert K1.weight_image(w, 1) is img
    assert K1.weight_image(w, 0) is not img and K1.weight_image(w, 0).dtype == torch.float32
    w.mul_(2)
    again = K1.weight_image(w, 1)
    assert again is not img and torch.equal(again, R.wgmma_tier_image(2 * padded[None], 1))
    with torch.inference_mode():
        v = torch.ones(16, 16, 3)
    assert K1.weight_image(v, 2) is K1.weight_image(v, 2)
    n = len(K1._IMAGES)
    del w, v  # w's images at two tiers, v's at one
    assert len(K1._IMAGES) == n - 3


@pytest.mark.parametrize("tier,c", [(1, 48), (1, 96), (1, 112), (1, 128), (2, 128), (0, 128)])
def test_tier_image_at_k1_widths_is_the_split_in_the_swizzled_image(tier, c):
    """K1's widths past K2-K4's at the bf16 tiers, and C=128 at "highest":
    the image inverts to the tier's split of w by the card's own address
    rule; where a tap passes 32 KB ("high" from C=96, "highest" past 64) it
    is atom by atom, each atom's planes one contiguous unit."""
    k = 3
    rng = np.random.default_rng(c + tier)
    w = torch.from_numpy((rng.standard_normal((1, c, c, k)) / np.sqrt(c * k)).astype(np.float32))
    img = R.wgmma_tier_image(w, tier)
    elem = 4 if tier == 0 else 2
    planes = 1 if tier == 2 else 2
    units = R._tap_units(c, tier)
    per = R._atom_row(c, elem) // elem
    assert units == (c // per if planes * elem * c * c > 32768 else 1)
    if units > 1:
        assert img.shape == (1, k, units, planes, c, per)
        img = img.transpose(2, 3).reshape(1, k, planes, c, c)
    assert img.shape == (1, k, planes, c, c) and img.is_contiguous()
    parts = split_tf32(w) if tier == 0 else split_bf16(w) if tier == 1 else (w,)
    view = torch.int32 if tier == 0 else torch.int16
    for plane in range(planes):
        want = parts[plane].to(torch.float32 if tier == 0 else torch.bfloat16)
        got = _unswizzle(img[:, :, plane], elem=elem)
        assert torch.equal(got.contiguous().view(view), want.contiguous().view(view))


def _k1_tf32x3(x, w, b, d, slope, mask):
    """K1 as its "highest" kernel forms it: act(x) masked, then the 3xTF32
    conv (_tf32x3_conv: split_tf32's three products, an fp64 sum)."""
    xin = torch.nn.functional.leaky_relu(x, slope) * mask
    return _tf32x3_conv(xin, w, b, (w.shape[-1] - 1) // 2 * d, d)


@pytest.mark.parametrize("ch", [16, 32])
@pytest.mark.parametrize("k,d", [(3, 1), (5, 6), (7, 12)])
def test_k1_tf32x3_meets_the_module_bar_against_pallas(ch, k, d):
    """K1's 3xTF32 recipe, emulated, against pallas_conv1d_same at
    "highest" in interpret mode on the masked input (N = 300, two-sided
    bounds), within 2e-5; farther than the conv's reach outside [lo, hi)
    the output is exactly the bias, as the kernel's dead tiles write it."""
    rng = np.random.default_rng(ch * 100 + k * 10 + d)
    n = 300
    x = rng.standard_normal((2, ch, n)).astype(np.float32)
    w = (rng.standard_normal((ch, ch, k)) / np.sqrt(ch * k)).astype(np.float32)
    bias = (rng.standard_normal((ch,)) * 0.02).astype(np.float32)
    bounds = np.array([[37, 261], [0, 200]], np.int32)
    pos = np.arange(n)
    mask = ((pos >= bounds[:, :1]) & (pos < bounds[:, 1:]))[:, None, :].astype(np.float32)
    got = _k1_tf32x3(*_t((x, w, bias)), d, 0.1, torch.from_numpy(mask))
    want = pallas_conv1d_same(jnp.asarray(x * mask), jnp.asarray(w), jnp.asarray(bias),
                              dilation=d, act_slope=0.1, tile=128, interpret=True,
                              precision="highest")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    reach = (k - 1) // 2 * d
    dead = (pos < bounds[:, :1] - reach) | (pos >= bounds[:, 1:] + reach)
    for r in range(2):
        out = got.numpy()[r][:, dead[r]]
        assert out.size == 0 or np.array_equal(out, np.broadcast_to(bias[:, None], out.shape))


def test_conv1d_same_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 16, 64)
    with pytest.raises(ValueError, match="highest"):
        K1.conv1d_same(x, torch.zeros(16, 16, 3), precision="float32")
    with pytest.raises(ValueError, match="square"):
        K1.conv1d_same(x, torch.zeros(8, 16, 3))
    with pytest.raises(ValueError, match="odd"):
        K1.conv1d_same(x, torch.zeros(16, 16, 4))
    with pytest.raises(ValueError, match="cpu or cuda"):
        K1.conv1d_same(x.to("meta"), torch.zeros(16, 16, 3, device="meta"))


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("ch,k,d,n,slope", [
    (32, 11, 5, 1000, 0.0),
    (64, 7, 3, 700, 0.1),
])
def test_conv1d_same_plain_tiers_match_pallas(ch, k, d, n, slope, precision):
    """mxu_dot's tiers: "high" is the bf16x3 split, "default" one bf16 pass."""
    rng = np.random.default_rng(k * 10 + d)
    x = rng.standard_normal((2, ch, n)).astype(np.float32)
    w = (rng.standard_normal((ch, ch, k)) * 0.05).astype(np.float32)
    bias = rng.standard_normal((ch,)).astype(np.float32)
    got = K1.conv1d_same_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                               dilation=d, act_slope=slope, precision=precision)
    want = pallas_conv1d_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), dilation=d,
                              act_slope=slope, tile=512, interpret=True, precision=precision)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TIER_ATOL[precision], rtol=0)


def test_tiers_and_their_codes():
    """The tiers map as _pallas_precision maps them, and the tiers differ:
    at "high" the error of a conv against fp32 is ~2^-16 of its terms, at
    "default" ~2^-8."""
    assert [tier_code(t) for t in (None, "highest", "high", "default", "bfloat16")] == \
        [0, 0, 1, 2, 2]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 32, 200)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((32, 32, 5)) * 0.1).astype(np.float32))
    ref = tiered_conv1d(x.double(), w.double(), padding=2).float()
    errs = [float((tiered_conv1d(x, w, padding=2, precision=t) - ref).abs().max())
            for t in ("highest", "high", "default")]
    assert errs[0] < 1e-5 < errs[2] and errs[1] < 1e-4 and 10 * errs[1] < errs[2], errs


@pytest.mark.parametrize("fold,n", [(2, 998), (3, 100), (4, 998), (4, 1000)])
def test_fold_unfold_match_jax(fold, n):
    x = np.random.default_rng(fold).standard_normal((2, 8, n)).astype(np.float32)
    got = K4.fold_time_axis(torch.from_numpy(x), fold)
    want = j_fold(jnp.asarray(x), fold)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(K4.unfold_time_axis(got, fold, n).numpy(),
                                  np.asarray(j_unfold(want, fold, n)))
    np.testing.assert_array_equal(K4.unfold_time_axis(got, fold, n).numpy(), x)


def _folded_both(x, branches, fold, bounds, precision):
    got = K4.resblock1_mrf_folded_plain(
        torch.from_numpy(x), [(*_t(b[:4]), b[4], b[5]) for b in branches], fold=fold,
        bounds=None if bounds is None else torch.from_numpy(bounds), precision=precision)
    want = pallas_resblock1_mrf_folded(
        jnp.asarray(x), [(*_j(b[:4]), b[4], b[5]) for b in branches], fold=fold,
        bounds=None if bounds is None else jnp.asarray(bounds), interpret=True,
        precision=precision)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("bnd", [None, [450, 500], [[37, 401], [0, 500]]],
                         ids=["none", "one_sided", "two_sided"])
@pytest.mark.parametrize("fold", [2, 4])
def test_mrf_folded_plain_matches_pallas(fold, bnd, precision):
    """K4's plain version against the folded Pallas kernel: C=16, two
    branches (kernels 3/7, dilations 1/3), N = 500, not a multiple of 4 * 128
    (so the fold pads)."""
    rng = np.random.default_rng(fold)
    ch, n = 16, 500
    x = rng.standard_normal((2, ch, n)).astype(np.float32) * 0.3
    branches = [(*_branch_weights(rng, ch, k, 2), k, (1, 3)) for k in (3, 7)]
    bounds = None if bnd is None else np.asarray(bnd, np.int32)
    got, want = _folded_both(x, branches, fold, bounds, precision)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if bnd is not None:
        assert np.all(got[1, :, bounds[1] if bounds.ndim == 1 else bounds[1, 1]:] == 0.0)


def test_mrf_folded_plain_at_medium_level_3():
    """Medium's last level: C=32, kernels 3/7/11 at dilations 1/3/5, fold 4
    (F*C = 128 rows), a ragged N and two-sided bounds, at "high"."""
    rng = np.random.default_rng(11)
    ch, n = 32, 998
    x = rng.standard_normal((2, ch, n)).astype(np.float32) * 0.3
    branches = _mrf_branches(rng, ch)
    bounds = np.array([[37, 401], [0, 998]], np.int32)
    got, want = _folded_both(x, branches, 4, bounds, "high")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    k3 = R.resblock1_mrf_plain(torch.from_numpy(x), [(*_t(b[:4]), b[4], b[5]) for b in branches],
                               bounds=torch.from_numpy(bounds), precision="high")
    assert np.array_equal(got, k3.numpy())  # fold then unfold is the identity


def test_mrf_folded_cpu_runs_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((2, 16, 90)).astype(np.float32))
    br = [(*_t(_branch_weights(rng, 16, 3, 1)), 3, (1,))]
    before = K4.resblock1_mrf_folded.launches
    got = K4.resblock1_mrf_folded(x, br, fold=4, bounds=torch.tensor([90, 50]))
    assert torch.equal(got, K4.resblock1_mrf_folded_plain(x, br, fold=4,
                                                          bounds=torch.tensor([90, 50])))
    assert K4.resblock1_mrf_folded.launches == before
    with pytest.raises(ValueError, match="fold"):
        K4.resblock1_mrf_folded(x, br, fold=0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        K4.resblock1_mrf_folded(x.to("meta"), br)


def test_folded_probe_refuses_to_run_without_a_card():
    """The probe times the kernels on a card and has no CPU path."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from piper_tpu_torch.tools import folded_probe

    with pytest.raises(SystemExit, match="no CUDA device"):
        folded_probe.main(["--b", "1", "--shapes", "16:64"])


@pytest.mark.parametrize("r,q", [(2, 129), (2, 2048), (4, 1000), (8, 17), (8, 4099)])
def test_interleave_plain_matches_jax_expression(r, q):
    """K5's plain version against the function the Pallas kernel
    `mosaic_interleave` computes: JAX's interleave expression
    y.transpose(0, 2, 3, 1).reshape(b, c, q * r), the same as
    piper_tpu/ops/conv.py:121. The Pallas kernel itself sits in a closure
    inside tools/ct_probe.py's main, which no test can reach, so the
    expression stands in for it. A permutation: exact, ragged q included."""
    y = np.random.default_rng(r * q).standard_normal((2, r, 24, q)).astype(np.float32)
    b, _, c, _ = y.shape
    want = np.asarray(jnp.asarray(y).transpose(0, 2, 3, 1).reshape(b, c, q * r))
    got = K5.interleave_plain(torch.from_numpy(y))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    before = K5.interleave.launches
    assert torch.equal(K5.interleave(torch.from_numpy(y)), got)  # CPU: the plain version
    assert K5.interleave.launches == before


def test_interleave_refuses_what_the_kernel_does_not_take():
    """The wrapper checks dtype, rank, contiguity and r on every device, and
    refuses a tensor that is neither on the CPU nor on a card."""
    y = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="float32"):
        K5.interleave(y.double())
    with pytest.raises(ValueError, match=r"\(B, r, c, q\)"):
        K5.interleave(y[0])
    with pytest.raises(ValueError, match="contiguous"):
        K5.interleave(y.transpose(2, 3))
    with pytest.raises(ValueError, match="1 to 8"):
        K5.interleave(torch.zeros(1, 9, 8, 64))
    with pytest.raises(ValueError, match="cpu or cuda"):
        K5.interleave(y.to("meta"))


def _unswizzle(img, elem=2):
    """(M, K, C, C) wgmma B images of `elem`-byte values -> (M, C_out,
    C_in, K), read as the card reads them: a row of C values is cut into
    atoms of R bytes along C_in, R the widest of 128, 64 and 32 that
    divides C * elem, each atom all C rows (C * R bytes) after the one
    before, so element (row r, column p) is at
    byte a = (p // (R / elem)) * C * R + r * R + (p % (R / elem)) * elem of
    a 1024-byte aligned tile, and the card finds it at byte a XOR (((a >> 7)
    & (2^b - 1)) << 4) of the image, b = 3, 2, 1 for R = 128, 64, 32
    (CUTLASS's Swizzle<b, 4, 3>)."""
    m, k, c, _ = img.shape
    row = next(r for r in (128, 64, 32) if c * elem % r == 0)
    per = row // elem  # values a row of one atom
    bits = {128: 3, 64: 2, 32: 1}[row]
    r, p = torch.meshgrid(torch.arange(c), torch.arange(c), indexing="ij")
    a = (p // per) * c * row + r * row + (p % per) * elem
    phys = (a ^ (((a >> 7) & ((1 << bits) - 1)) << 4)) // elem
    return img.reshape(m, k, c * c)[:, :, phys.flatten()].reshape(m, k, c, c).permute(0, 2, 3, 1)


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("c", [16, 32, 64])
def test_wgmma_weights_are_the_bf16_split_in_the_swizzled_image(c, k):
    """The wgmma stage's weights: every (co, ci, tap) once; the swizzled
    image inverts to w by the card's own address rule; each (conv, tap) is
    one contiguous tile of P planes; hi and lo equal precision.py's bf16
    split bit for bit ("high"), one plane of bf16(w) at "default"."""
    m = 3
    idx = torch.arange(m * c * c * k).reshape(1, m, c, c, k)
    img = R.wgmma_image(idx)
    assert img.shape == (m, k, 1, c, c) and img.is_contiguous()
    assert torch.equal(img.flatten().sort().values, idx.flatten())
    assert torch.equal(_unswizzle(img[:, :, 0]), idx[0])

    rng = np.random.default_rng(c * k)
    w = torch.from_numpy((rng.standard_normal((m, c, c, k)) / np.sqrt(c * k)).astype(np.float32))
    hi, lo = split_bf16(w)
    high = R.wgmma_weights(w, tier_code("high"))
    assert high.dtype == torch.bfloat16 and high.shape == (m, k, 2, c, c)
    assert high.is_contiguous()
    got_hi, got_lo = _unswizzle(high[:, :, 0]), _unswizzle(high[:, :, 1])
    assert torch.equal(got_hi.view(torch.int16), hi.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(got_lo.view(torch.int16), lo.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(got_hi.float() + got_lo.float(), hi + lo)
    default = R.wgmma_weights(w, tier_code("default"))
    assert default.shape == (m, k, 1, c, c) and default.is_contiguous()
    assert torch.equal(_unswizzle(default[:, :, 0]).view(torch.int16),
                       w.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(R.wgmma_weights(w.to(torch.bfloat16), tier_code("default")), default)


@pytest.mark.parametrize("shape,match", [
    ((1, 8, 8, 3), "multiple of 16"),
    ((1, 48, 48, 3), "16, 32 or 64"),
    ((1, 32, 16, 3), "square"),
])
def test_wgmma_weights_refuse_other_widths(shape, match):
    with pytest.raises(ValueError, match=match):
        R.wgmma_weights(torch.zeros(shape), tier_code("high"))


def _event(key, count, us, device="CUDA"):
    from types import SimpleNamespace

    return SimpleNamespace(key=key, count=count, device_time_total=us,
                           device_type=getattr(torch.autograd.DeviceType, device))


LOST_HEAD = "lost head"


def _stub_profiler(monkeypatch) -> list:
    """torch.profiler.profile and the card's calls stubbed: each profiled
    window's averaged events are the next entry of the returned list, behind
    its sentinels, or a window that lost them (LOST_HEAD: one kernel
    before the first call's)."""
    windows = []

    class StubProfile:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            w = windows.pop(0)
            if w == LOST_HEAD:
                return [_event("copy", 1, 1.0)]
            return [_event("at::cuda::(anonymous namespace)::spin_kernel(long)",
                           timing.SENTINELS, 128.0)] + w

    monkeypatch.setattr(torch.profiler, "profile", StubProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    return windows


def test_device_kernels_sums_only_the_named_kernels():
    events = [_event("void (anonymous namespace)::resblock1_kernel<false, false, 1>(Args)",
                     6, 600.0),
              _event("void at::native::elementwise_kernel<128, 4>(...)", 12, 50.0),
              _event("aten::resblock1_kernel_on_the_host", 1, 999.0, device="CPU")]
    assert timing.device_kernels(events, "resblock1_kernel") == (6, 600.0)
    assert timing.device_kernels(events, "elementwise") == (12, 50.0)
    assert timing.device_kernels(events) == (18, 650.0)
    assert timing.device_kernels(events, "conv1d_same") == (0, 0.0)


def test_device_ms_requires_the_expected_kernel_count(monkeypatch):
    """A window with another count than expected * reps is profiled again,
    and after _PROFILE_ATTEMPTS such windows device_ms raises."""
    windows = _stub_profiler(monkeypatch)
    calls = []
    fn = lambda: calls.append(1)  # noqa: E731
    kernel = "resblock1_kernel<true, false, 2>"
    # One kernel of six went missing from the first window: profiled again.
    windows[:] = [[_event(kernel, 5, 500.0)], [_event(kernel, 6, 630.0), _event("copy", 9, 1.0)]]
    assert timing.device_ms(fn, reps=3, name="resblock1_kernel", expected=2) == \
        pytest.approx(630.0 / 3 / 1e3)
    assert len(calls) == 1 + 3 + 3 and not windows
    windows[:] = [[_event(kernel, 7, 700.0)]] * timing._PROFILE_ATTEMPTS
    sevens = ", ".join(["7"] * timing._PROFILE_ATTEMPTS)
    with pytest.raises(RuntimeError, match=r"expected 6 kernels named 'resblock1_kernel'.*"
                                           rf"\[{sevens}\]"):
        timing.device_ms(fn, reps=3, name="resblock1_kernel", expected=2)
    # Without `expected`, only an empty window is refused.
    windows[:] = [[], [_event("copy", 3, 30.0)]]
    assert timing.device_ms(fn, reps=3) == pytest.approx(30.0 / 3 / 1e3)


def test_device_kernels_leave_out_the_windows_sentinels():
    events = [_event("at::cuda::(anonymous namespace)::spin_kernel(long)", 128, 90.0),
              _event("void at::native::elementwise_kernel<128, 4>(...)", 12, 50.0)]
    assert timing.device_kernels(events) == (12, 50.0)
    assert timing.device_kernels(events, timing.SENTINEL) == (128, 90.0)


@pytest.mark.parametrize("timer", ["device_ms", "call_kernels", "profile_call"])
def test_a_window_that_lost_its_sentinels_is_profiled_again(monkeypatch, timer):
    """On the card torch.profiler has dropped the first kernels of a window
    (one kernel, or hundreds): a window that kept none of its sentinels may
    have lost the first call's kernels too, so it is never counted or summed
    but profiled again; a window of lost heads only raises."""
    windows = _stub_profiler(monkeypatch)
    counter = _Counter()

    def fn():  # one call: 3 launches of the kernel
        counter.launches += 3

    kernel = "resblock1_kernel<false, false, 0>"
    whole = [_event(kernel, 30, 300.0), _event("copy", 150, 15.0)]
    if timer == "device_ms":
        windows[:] = [LOST_HEAD, whole]
        assert timing.device_ms(fn, name="resblock1_kernel", expected=3) == \
            pytest.approx(300.0 / 10 / 1e3)
        windows[:] = [LOST_HEAD] * timing._PROFILE_ATTEMPTS
        with pytest.raises(RuntimeError, match=r"expected 30 kernels.*'lost head'"):
            timing.device_ms(fn, name="resblock1_kernel", expected=3)
    elif timer == "call_kernels":
        # A lost head between two whole windows does not part them.
        windows[:] = [whole, LOST_HEAD, whole]
        assert timing.call_kernels(fn, "resblock1_kernel") == (18, 3)
        windows[:] = [LOST_HEAD] * (timing._PROFILE_ATTEMPTS + 1)
        with pytest.raises(RuntimeError, match="no two windows of 10 calls agree"):
            timing.call_kernels(fn, "resblock1_kernel")
    else:
        one = [_event(kernel, 3, 30.0), _event("copy", 15, 1.5)]
        windows[:] = [LOST_HEAD, one]
        assert timing.profile_call(fn, "resblock1_kernel", [counter]) == {
            "device_kernels": 18, "device_busy_ms": pytest.approx(0.0315),
            "kernel_symbol": "resblock1_kernel", "kernel_ms": pytest.approx(0.03),
            "kernel_launches": 3}
        windows[:] = [LOST_HEAD] * timing._PROFILE_ATTEMPTS
        with pytest.raises(AssertionError, match="lost head, 3 launched"):
            timing.profile_call(fn, "resblock1_kernel", [counter])
    assert not windows


# ---- "highest" on the tensor cores: 3xTF32 ----


def _rna_tf32_reference(x: np.ndarray) -> np.ndarray:
    """tf32 rounding to nearest, ties away from zero, in numpy's own terms:
    the magnitude's 32-bit pattern split at the 13th bit, rounded up where
    the cut part is at least half of it."""
    bits = x.astype(np.float32).view(np.uint32)
    sign, mag = bits & np.uint32(0x80000000), bits & np.uint32(0x7FFFFFFF)
    cut = mag & np.uint32(0x1FFF)
    kept = mag - cut
    up = cut >= np.uint32(0x1000)
    kept = np.where(up, kept + np.uint32(0x2000), kept).astype(np.uint32)
    return (sign | kept).view(np.float32)


def test_split_tf32_is_rna_rounding_bit_for_bit():
    """big and small are tf32 values (the low 13 bits zero), big is x
    rounded to nearest with ties away from zero and small the same of
    x - big, as cvt.rna.tf32.f32; big + small is x within 2^-22 of |x|, or
    within 2^-137 where a part is subnormal (the cut bits are then a fixed
    2^-136, as on the card). Ties, zeros, negatives and subnormals
    included."""
    rng = np.random.default_rng(22)
    tiny = np.finfo(np.float32).tiny
    ties = (np.array([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, 3 * 2.0 ** -12], np.float64)
            .astype(np.float32))  # exactly half a tf32 ulp past a tf32 value
    special = np.array([0.0, -0.0, tiny, -tiny, tiny / 3, -tiny / 7, tiny * 0.5 + tiny / 4096,
                        1.0, -1.0, 65504.0, 1e-30, -3e-38], np.float32)
    x = np.concatenate([rng.standard_normal(4000).astype(np.float32) * 10.0 ** rng.integers(
        -20, 20, 4000), ties, -ties, special]).astype(np.float32)
    big, small = (t.numpy() for t in split_tf32(torch.from_numpy(x)))
    want_big = _rna_tf32_reference(x)
    assert np.array_equal(big.view(np.uint32), want_big.view(np.uint32))
    assert np.array_equal(small.view(np.uint32),
                          _rna_tf32_reference((x - want_big).astype(np.float32)).view(np.uint32))
    for t in (big, small):
        assert not np.any(t.view(np.uint32) & np.uint32(0x1FFF))
    # ties round away from zero: 1 + 2^-11 -> 1 + 2^-10, and its negative
    assert big[4000] == np.float32(1 + 2.0 ** -10) and big[4003] == -big[4000]
    err = np.abs(big.astype(np.float64) + small - x.astype(np.float64))
    assert np.all(err <= np.maximum(2.0 ** -22 * np.abs(x.astype(np.float64)), 2.0 ** -137))
    normal = np.abs(x) >= tiny * 2.0 ** 12  # small is normal too
    assert normal.sum() > 4000 and np.all(err[normal] <= 2.0 ** -22 * np.abs(x[normal]))
    assert big.dtype == np.float32 and small.dtype == np.float32


def _tf32_planes(img, c):
    """wgmma_tf32_weights' image as (M, K, 2, C, C), plane by plane: past
    C = 64 it is atom by atom, each atom's two planes, (M, K, A, 2, C, R/4)."""
    if img.ndim == 5:
        return img
    m, k = img.shape[:2]
    return img.transpose(2, 3).reshape(m, k, 2, c, c)


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("c", [16, 32, 48, 64, 80, 96, 112])
def test_wgmma_tf32_weights_are_the_tf32_split_in_the_swizzled_image(c, k):
    """The "highest" tier's weights: every (co, ci, tap) once; the image
    (rows of 4C bytes: 128-byte atoms along C_in, two at C=64, one at 32,
    three at 96; else 64-byte atoms, one at 16, three at 48, five at 80,
    seven at 112) inverts to w by the card's own address rule; each (conv,
    tap) is one contiguous tile of two planes, and past C=64 each of its
    atoms one contiguous unit of both planes; big and small equal
    precision.py's split_tf32 bit for bit, their low 13 bits zero."""
    m = 3
    idx = torch.arange(2 * m * c * c * k).reshape(2, m, c, c, k)
    img = R.wgmma_image(idx, elem=4)
    assert img.shape == (m, k, 2, c, c) and img.is_contiguous()
    assert torch.equal(img.flatten().sort().values, idx.flatten())
    for plane in (0, 1):
        assert torch.equal(_unswizzle(img[:, :, plane], elem=4), idx[plane])
        # each (conv, tap, plane) tile holds that conv's tap and no other
        assert torch.equal(img[:, :, plane].reshape(m, k, -1).sort(dim=2).values,
                           idx[plane].permute(0, 3, 1, 2).reshape(m, k, -1).sort(dim=2).values)

    rng = np.random.default_rng(c * k + 1)
    w = torch.from_numpy((rng.standard_normal((m, c, c, k)) / np.sqrt(c * k)).astype(np.float32))
    big, small = split_tf32(w)
    image = R.wgmma_tf32_weights(w)
    assert image.dtype == torch.float32 and image.is_contiguous()
    units = R._tap_units(c, 0)
    if units == 1:
        assert image.shape == (m, k, 2, c, c)
    else:
        per = 32 if c % 32 == 0 else 16  # fp32 values a row of one atom
        assert units == c // per and image.shape == (m, k, units, 2, c, per)
    planes = _tf32_planes(image, c)
    got_big = _unswizzle(planes[:, :, 0], elem=4).view(torch.int32)
    got_small = _unswizzle(planes[:, :, 1], elem=4).view(torch.int32)
    assert torch.equal(got_big, big.view(torch.int32))
    assert torch.equal(got_small, small.view(torch.int32))
    assert not bool((image.view(torch.int32) & 0x1FFF).any())
    assert bool((small != 0).any())


@pytest.mark.parametrize("shape,match", [
    ((1, 8, 8, 3), "multiple of 16"),
    ((1, 128, 128, 3), "a multiple of 16 below 128"),
    ((1, 32, 16, 3), "square"),
])
def test_wgmma_tf32_weights_refuse_other_widths(shape, match):
    with pytest.raises(ValueError, match=match):
        R.wgmma_tf32_weights(torch.zeros(shape))


class _H100Props:
    shared_memory_per_block_optin = 232448
    multi_processor_count = 132


def test_highest_shared_memory_and_tiles(monkeypatch):
    """"highest" on the wgmma stage: a tap's image and a buffer are two fp32
    planes (tf32 big and small), 32 KB a tap at C=64. At C=64 act(y) and
    act(conv1) share one buffer, overwritten in place (two do not fit beside
    a ring of taps); at C=32 and 16 each has its own. Every configuration
    wgmma_configs offers at tier 0, and so every one _pick_tile can return,
    fits 232,448 bytes and a window of 256 lanes. The bf16 tiers' tile rule
    holds (tile 136 at halo 60, at B=1 and at the serving batch), and a
    chunk of one tap takes 3 slots, the most that fit: K2 (C=64) runs
    (136, 3, 1) at k=11, (184, 3, 1) at k=7 and at k=3 (168, 2, 2) at B=1,
    (232, 3, 1) at B=32; K3 (C=32) (136, 2, 6); the high voice's C=16
    level (136, 2, 11). The widths no preset voice has: C=48 in place with
    whole taps a unit; past C=64 one atom of a tap (both planes) a unit of
    the ring, with a window of 192 lanes at C=96 and 112."""
    lanes = 136 + 120 + 1  # the window and the lane that takes the stores outside a stage
    assert R._smem_bytes(64, 136, 60, False, 0, 3, 1) == (
        1024 + 3 * 32768 + 128 + 2 * 4 * lanes * 64 + 16 * 60) == 232000
    assert R._smem_bytes(32, 136, 60, True, 0, 2, 6) == (
        1024 + 2 * 6 * 8192 + 128 + 2 * 2 * 4 * lanes * 32 + 16 * 60) == 232000
    assert R._smem_bytes(16, 136, 60, True, 0, 2, 11) == (
        1024 + 2 * 11 * 2048 + 128 + 2 * 2 * 4 * lanes * 16 + 16 * 60)
    limit = _H100Props.shared_memory_per_block_optin
    assert R._smem_bytes(64, 136, 60, False, 0, 2, 2) > limit  # two taps a slot at C=64
    assert R._smem_bytes(32, 136, 60, True, 0, 2, 11) > limit  # a whole conv at C=32
    assert [R._tap_units(c, 0) for c in R._HIGHEST_WIDTHS] == [1, 1, 1, 1, 5, 3, 7]
    assert R._smem_bytes(48, 136, 60, False, 0, 2, 3) == (
        1024 + 2 * 3 * 18432 + 128 + 2 * 4 * lanes * 48 + 16 * 60)
    assert R._smem_bytes(112, 72, 60, False, 0, 3, 1) == (
        1024 + 3 * 14336 + 128 + 2 * 4 * 193 * 112 + 16 * (256 - 192 + 60))

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _H100Props())

    def pick(b, c, n, halo=60, mean=False, taps=11):
        return R._pick_tile(torch.empty((b, c, n), device="meta"), halo, mean, 256, 0, taps)

    for frames in (128, 192):
        for b in (1, 32):
            assert pick(b, 64, frames * 128) == (136, 3, 1)              # K2, k=11
            assert pick(b, 32, frames * 256, mean=True) == (136, 2, 6)   # K3
    assert pick(1, 64, 128 * 128, halo=36, taps=7) == (184, 3, 1)
    assert pick(1, 64, 128 * 128, halo=12, taps=3) == (168, 2, 2)
    assert pick(32, 64, 192 * 128, halo=12, taps=3) == (232, 3, 1)
    assert pick(1, 16, 128 * 512, mean=True) == (136, 2, 11)
    assert pick(1, 48, 128 * 128) == (136, 2, 3)
    assert pick(1, 80, 128 * 128) == (136, 2, 3)
    assert pick(1, 96, 128 * 128) == pick(1, 112, 128 * 128) == (72, 3, 1)
    for c in R._HIGHEST_WIDTHS:
        for halo, taps in ((60, 11), (36, 7), (12, 3)):
            configs = R.wgmma_configs(torch.empty((1, c, 99), device="meta"), halo, 256, 0, taps)
            assert configs and all(
                t + 2 * halo <= 256 and R._smem_bytes(c, t, halo, False, 0, r, ch) <= limit
                for t, r, ch in configs), (c, halo)


@pytest.mark.parametrize("tier", ["high", "default"])
def test_wgmma_shared_memory_and_tiles(monkeypatch, tier):
    """The wgmma stage at K2's and K3's widest branch (k=11, dilations
    1/3/5: halo 60): a window of at most 256 lanes (4 warpgroups x 64), so
    tile 136 fills it; a ring slot holds `chunk` taps' images (rounded to
    1024 bytes). At B=1 (128 frames) and at the serving batch (B=32,
    T=192) the wave rule picks tile 136 for K2 (C=64, N = 128 or 192
    frames x 128) and K3 (C=32, x 256) alike, with 2 slots of as many taps
    as fit: a whole conv at C=32 and 16, 6 at C=64 "default", 3 at C=64
    "high" (232,000 of 232,448 bytes). K2's k=3 branch (halo 12) takes 3
    warpgroups' window at B=1 (tile 168, one wave of 98 blocks) and the full
    256 lanes at B=32 (tile 232)."""
    code = tier_code(tier)
    planes = 2 if tier == "high" else 1
    lanes = 136 + 120 + 1  # the window and the lane that takes the stores outside a stage

    def slot(c, chunk):
        return -(-chunk * planes * 2 * c * c // 1024) * 1024

    for c, chunk in ((64, 3), (32, 11), (16, 11), (64, 1)):
        assert R._smem_bytes(c, 136, 60, c != 64, code, 2, chunk) == (
            1024 + 2 * slot(c, chunk) + 128 + 2 * planes * 2 * lanes * c + 16 * 60)
    assert R._smem_bytes(64, 136, 60, False, 1, 2, 3) == 232000
    assert R._smem_bytes(64, 136, 60, False, 1, 2, 4) > _H100Props.shared_memory_per_block_optin

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _H100Props())
    halo = R.branch_halo(11, (1, 3, 5))

    def pick(b, c, n, halo=halo, mean=False, tile_max=256, taps=11):
        return R._pick_tile(torch.empty((b, c, n), device="meta"), halo, mean, tile_max, code,
                            taps)

    k2_chunk = 3 if tier == "high" else 6
    for frames in (128, 192):
        for b in (1, 32):
            assert pick(b, 64, frames * 128) == (136, 2, k2_chunk)      # K2
            assert pick(b, 32, frames * 256, mean=True) == (136, 2, 11)  # K3
    assert pick(1, 16, 128 * 512, mean=True) == (136, 2, 11)
    assert pick(1, 64, 128 * 128, halo=12, taps=3) == (168, 2, 3)
    assert pick(32, 64, 192 * 128, halo=12, taps=3) == (232, 2, 3)
    assert pick(2, 16, 1000, tile_max=32) == (32, 2, 11)  # a cap below the fill tile
    configs = R.wgmma_configs(torch.empty((1, 64, 99), device="meta"), halo, 256, code, 7)
    assert {r for _, r, _ in configs} == set(R._RINGS)
    assert {ch for _, _, ch in configs} <= {1, 2, 3, 4, 6, 7}
    assert all(t + 2 * halo <= 256 and R._smem_bytes(64, t, halo, False, code, r, ch) <= 232448
               for t, r, ch in configs)
    with pytest.raises(ValueError, match="256 lanes"):
        pick(1, 64, 4096, halo=130)


def _tf32x3_conv(x, w, b, padding, dilation):
    """A conv as K2-K4 form it at "highest": big*big + big*small +
    small*big of split_tf32's parts, summed in fp64 (each product exact),
    the bias added, rounded to fp32 once."""
    (xb, xs), (wb, ws) = split_tf32(x), split_tf32(w)

    def conv(a, v):
        return torch.nn.functional.conv1d(a.double(), v.double(), padding=padding,
                                          dilation=dilation)

    return (conv(xb, wb) + conv(xs, wb) + conv(xb, ws) + b.double()[:, None]).float()


def _tf32x3_chain(x, w1s, b1s, w2s, b2s, k, dils, mask, slope=0.1):
    def act(v):
        return torch.nn.functional.leaky_relu(v, slope) * mask

    y, h = x, (k - 1) // 2
    for m, d in enumerate(dils):
        t = _tf32x3_conv(act(y), w1s[m], b1s[m], h * d, d)
        y = y + _tf32x3_conv(act(t), w2s[m], b2s[m], h, 1)
    return y


@pytest.mark.parametrize("ch", [16, 32])
def test_tf32x3_chain_meets_the_module_bar_against_pallas(ch):
    """The 3xTF32 recipe, emulated, against the Pallas kernels at "highest"
    in interpret mode (fp32 products on the CPU): one branch at k = 11 and
    the three-branch MRF stage, N = 300 with two-sided bounds, within
    2e-5."""
    rng = np.random.default_rng(ch + 300)
    n = 300
    x = rng.standard_normal((2, ch, n)).astype(np.float32) * 0.3
    bounds = np.array([[37, 261], [0, 200]], np.int32)
    pos = np.arange(n)
    mask = torch.from_numpy(((pos >= bounds[:, :1]) & (pos < bounds[:, 1:]))[:, None, :]
                            .astype(np.float32))
    branches = _mrf_branches(rng, ch)
    w1s, b1s, w2s, b2s, k, dils = branches[2]
    got = _tf32x3_chain(torch.from_numpy(x), *_t((w1s, b1s, w2s, b2s)), k, dils, mask) * mask
    want = pallas_resblock1_branch(jnp.asarray(x), *_j((w1s, b1s, w2s, b2s)), kernel=k,
                                   dilations=dils, bounds=jnp.asarray(bounds), tile=128,
                                   interpret=True, precision="highest")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)

    ys = [_tf32x3_chain(torch.from_numpy(x), *_t(b[:4]), b[4], b[5], mask) for b in branches]
    got = sum(ys) / len(ys) * mask
    want = pallas_resblock1_mrf(jnp.asarray(x), [(*_j(b[:4]), b[4], b[5]) for b in branches],
                                bounds=jnp.asarray(bounds), tile=128, interpret=True,
                                precision="highest")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    assert np.all(got.numpy()[0, :, :37] == 0.0) and np.all(got.numpy()[1, :, 200:] == 0.0)


def test_sass_ops_count_each_kernels_products(monkeypatch):
    """build.sass_ops reads cuobjdump -sass of the library: per kernel whose
    demangled name holds the symbol, its HGMMA (wgmma) and HMMA (mma.sync)
    instructions, each opcode counted as a word (HGMMA is not HMMA)."""
    from piper_tpu_torch.ops.kernels import build

    listing = "\n".join([
        "\tFunction : _Z16resblock1_kernelILi0EEvv",
        "        /*0100*/  HGMMA.64x64x8.F32.TF32 R24, gdesc[UR4], R24, gsb0 ;",
        "        /*0110*/  HGMMA.64x64x8.F32.TF32 R24, gdesc[UR8], R24 ;",
        "\tFunction : _Z16resblock1_kernelILi1EEvv",
        "        /*0100*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
        "\tFunction : _Z11conv1d_samev",
        "        /*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
    ])

    class Done:
        stdout = listing

    monkeypatch.setattr(build, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(build.subprocess, "run", lambda *a, **k: Done())
    monkeypatch.setattr(build, "_demangle", lambda names: [
        {"_Z16resblock1_kernelILi0EEvv": "void resblock1_kernel<0>()",
         "_Z16resblock1_kernelILi1EEvv": "void resblock1_kernel<1>()"}.get(n, n) for n in names])
    assert build.sass_ops(Path("lib.so"), "resblock1_kernel") == {
        "void resblock1_kernel<0>()": {"HGMMA": 2, "HMMA": 0},
        "void resblock1_kernel<1>()": {"HGMMA": 0, "HMMA": 1}}


def test_chip_smoke_resblock_sass_check_reads_each_tier():
    """chip_smoke's resblock_ptxas check: the tier of each instantiation,
    demangled either way, and every instantiation with an HMMA or without
    an HGMMA."""
    import chip_smoke

    wg, mma = {"HGMMA": 72, "HMMA": 0}, {"HGMMA": 0, "HMMA": 96}
    sass = {
        "void piper_rb::resblock1_kernel<(bool)1, (bool)0, (int)0, float, (int)64>(piper_rb::Args)":
            wg,
        "void piper_rb::resblock1_kernel<true, false, 1, float, 32>(piper_rb::Args)": wg,
        "void piper_rb::resblock1_kernel<(bool)0, (bool)0, (int)2, __nv_bfloat16, (int)16>"
        "(piper_rb::Args)": mma,
    }
    tiers, wrong = chip_smoke.resblock_sass_check(sass)
    assert tiers == {0, 1, 2}
    assert list(wrong) == [next(k for k in sass if "__nv_bfloat16" in k)]
    assert chip_smoke.resblock_sass_check({}) == (set(), {})


def test_chip_smoke_conv1d_sass_check_reads_each_variant():
    """chip_smoke's conv1d_ptxas check: the (padded C, tier, I/O type) of
    each K1 instantiation, demangled either way, and every instantiation
    with an HMMA or without an HGMMA; the library must hold every variant."""
    import chip_smoke

    wg, mma = {"HGMMA": 9, "HMMA": 0}, {"HGMMA": 0, "HMMA": 96}
    sass = {
        "void piper_k1::conv1d_same_kernel<(int)128, (int)0, float>(piper_k1::Args)": wg,
        "void piper_k1::conv1d_same_kernel<48, 1, float>(piper_k1::Args)": wg,
        "void piper_k1::conv1d_same_kernel<(int)16, (int)2, __nv_bfloat16>(piper_k1::Args)": mma,
    }
    variants, wrong = chip_smoke.conv1d_sass_check(sass)
    assert variants == {(128, 0, "float"), (48, 1, "float"), (16, 2, "bf16")}
    assert list(wrong) == [next(k for k in sass if "__nv_bfloat16" in k)]
    assert chip_smoke.conv1d_sass_check({}) == (set(), {})
    assert len(chip_smoke.K1_VARIANTS) == 32 and variants < chip_smoke.K1_VARIANTS


class _Counter:
    """A wrapper's launch counter, as the kernel wrappers carry one."""
    launches = 0


def test_whole_wrapper_device_ms_refuses_a_short_window(monkeypatch):
    """chip_smoke's whole-wrapper rows: the kernels per call are the count
    that two profiled windows agree on, whose kernels by symbol equal the
    wrapper's launches (its counter); then device_ms requires that count
    per call. A timed window with fewer kernels is profiled again and, when
    every window is short, raises: it is never summed."""
    import chip_smoke

    windows = _stub_profiler(monkeypatch)
    counter = _Counter()

    def fn():  # one wrapper call: 3 kernel launches
        counter.launches += 3

    kernel = "void (anonymous namespace)::resblock1_kernel<false, false, 0>(Args)"
    reps = 10
    short = [_event(kernel, 3 * reps, 3000.0), _event("elementwise_kernel", 15 * reps - 1, 199.0)]
    full = [_event(kernel, 3 * reps, 3000.0), _event("elementwise_kernel", 15 * reps, 200.0)]
    # Two windows agree on 18 kernels a call, 3 by symbol; one short timed
    # window, then a whole one: only the whole one is summed.
    windows[:] = [full, full, short, full]
    row = chip_smoke._whole_call_ms(fn, chip_smoke.RESBLOCK_SYMBOL, counter)
    assert row == {"device_ms": pytest.approx(3200.0 / reps / 1e3), "device_kernels": 18}
    assert not windows
    # A short first window does not set the count; every timed window
    # short: raises.
    windows[:] = [short, full, full] + [short] * timing._PROFILE_ATTEMPTS
    shorts = ", ".join(["179"] * timing._PROFILE_ATTEMPTS)
    with pytest.raises(RuntimeError, match=rf"expected 180 kernels in 10 calls.*\[{shorts}\]"):
        chip_smoke._whole_call_ms(fn, chip_smoke.RESBLOCK_SYMBOL, counter)
    assert not windows
    # The kernels by symbol must be the counter's launches per call.
    two = [_event(kernel, 2 * reps, 200.0)]
    windows[:] = [two, two]
    with pytest.raises(AssertionError, match="2 kernels per call in the profiler's windows, "
                                             "3 launched"):
        chip_smoke._whole_call_ms(fn, chip_smoke.RESBLOCK_SYMBOL, counter)
    # A plain version's row: its own count; windows that never agree, or
    # counts that are no multiple of the calls, raise.
    windows[:] = [[_event("copy", 4 * reps, 80.0)]] * 3
    assert chip_smoke._whole_call_ms(fn, prefix="plain_") == {
        "plain_device_ms": pytest.approx(80.0 / reps / 1e3), "plain_device_kernels": 4}
    windows[:] = [[_event("copy", 40 - i % 2, 1.0)] for i in range(timing._PROFILE_ATTEMPTS + 1)]
    with pytest.raises(RuntimeError, match="no two windows of 10 calls agree"):
        chip_smoke._whole_call_ms(fn, prefix="plain_")
    windows[:] = [[_event("copy", 41, 1.0)]] * (timing._PROFILE_ATTEMPTS + 1)
    with pytest.raises(RuntimeError, match="no two windows of 10 calls agree"):
        chip_smoke._whole_call_ms(fn, prefix="plain_")
