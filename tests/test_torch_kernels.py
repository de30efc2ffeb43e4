"""The plain versions of the port's ResBlock1 kernels against the Pallas
kernels they replace, run in interpret mode on the CPU (the cases of
tests/test_pallas_kernels.py). Tolerance 1e-5 max-abs: the same float32
conv chain, summed in another order. The CUDA kernels themselves run only
on a card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piper_tpu.ops.pallas.resblock import pallas_resblock1_branch, pallas_resblock1_mrf
from piper_tpu_torch.ops.kernels import resblock as R

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-5


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


def _branch_both(x, ws, k, dils, bounds, tile):
    got = R.resblock1_branch_plain(torch.from_numpy(x), *_t(ws), kernel=k, dilations=dils,
                                   bounds=None if bounds is None else torch.from_numpy(bounds))
    want = pallas_resblock1_branch(jnp.asarray(x), *_j(ws), kernel=k, dilations=dils,
                                   bounds=None if bounds is None else jnp.asarray(bounds),
                                   tile=tile, interpret=True)
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


def test_branch_plain_two_sided_bounds():
    rng = np.random.default_rng(1)
    ch, k, dils, n = 32, 7, (1, 3), 512
    x = rng.standard_normal((2, ch, n)).astype(np.float32) * 0.3
    bounds = np.array([[37, 401], [0, 512]], np.int32)
    got, want = _branch_both(x, _branch_weights(rng, ch, k, len(dils)), k, dils, bounds, 256)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
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


@pytest.mark.parametrize("bnd", [None, [700, 1000], [[37, 401], [0, 1000]]])
def test_mrf_plain_matches_pallas(bnd):
    """Three branches (kernels 3/7/11, dilations 1/3/5) and their mean."""
    rng = np.random.default_rng(7)
    ch, n = 32, 1000
    x = rng.standard_normal((2, ch, n)).astype(np.float32) * 0.3
    branches = _mrf_branches(rng, ch)
    bounds = None if bnd is None else np.asarray(bnd, np.int32)
    got = R.resblock1_mrf_plain(
        torch.from_numpy(x), [(*_t(b[:4]), b[4], b[5]) for b in branches],
        bounds=None if bounds is None else torch.from_numpy(bounds))
    want = pallas_resblock1_mrf(
        jnp.asarray(x), [(*_j(b[:4]), b[4], b[5]) for b in branches],
        bounds=None if bounds is None else jnp.asarray(bounds), tile=256, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


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
    quietly computed elsewhere; a lower tier is refused."""
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
        R.resblock1_branch(xc, wc, bc, wc, bc, kernel=3, dilations=(1,), precision="high")


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
