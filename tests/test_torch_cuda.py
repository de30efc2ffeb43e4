"""The port's CUDA kernels against their plain versions, on a card.

Skipped without a CUDA device. This file imports no JAX, so it also runs on
a machine with a card and no JAX (where tests/conftest.py cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance 1e-4 max-abs, as chip_smoke.py states it: up to C*k = 704-term
fp32 sums chained over six convs, in another order than cuDNN's.
"""

import pytest
import torch

from piper_tpu_torch.engine.runtime import fp32_exact
from piper_tpu_torch.ops.kernels import resblock as R

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with torch.inference_mode(), fp32_exact():
        yield torch.device("cuda")


def _weights(gen, c, k, m, dev):
    s = (c * k) ** -0.5
    return tuple((torch.randn(*shape, generator=gen) * sc).to(dev)
                 for shape, sc in (((m, c, c, k), s), ((m, c), 0.02),
                                   ((m, c, c, k), s), ((m, c), 0.02)))


@pytest.mark.parametrize("c,k,dils,n,bounds", [
    (64, 11, (1, 3, 5), 5000, [[0, 5000], [0, 1234]]),
    (16, 5, (1, 2), 777, [[33, 700], [0, 777]]),
    (32, 3, (2,), 300, None),
])
def test_branch_kernel_matches_plain(cuda, c, k, dils, n, bounds):
    gen = torch.Generator().manual_seed(c + k + n)
    x = (torch.randn(2, c, n, generator=gen) * 0.3).to(cuda)
    ws = _weights(gen, c, k, len(dils), cuda)
    bnd = None if bounds is None else torch.tensor(bounds, dtype=torch.int32, device=cuda)
    before = R.resblock1_branch.launches
    got = R.resblock1_branch(x, *ws, kernel=k, dilations=dils, bounds=bnd)
    torch.cuda.synchronize()
    assert R.resblock1_branch.launches == before + 1
    want = R.resblock1_branch_plain(x, *ws, kernel=k, dilations=dils, bounds=bnd)
    assert float((got - want).abs().max()) <= ATOL
    if bounds is not None:
        assert bool((got[1, :, bounds[1][1]:] == 0).all())


@pytest.mark.parametrize("c,n,tile", [(32, 9000, 256), (16, 1000, 32)])
def test_mrf_kernel_matches_plain(cuda, c, n, tile):
    gen = torch.Generator().manual_seed(n)
    x = (torch.randn(2, c, n, generator=gen) * 0.3).to(cuda)
    branches = [(*_weights(gen, c, k, 3, cuda), k, (1, 3, 5)) for k in (3, 7, 11)]
    bnd = torch.tensor([n - 10, n // 4], dtype=torch.int32, device=cuda)
    got = R.resblock1_mrf(x, branches, bounds=bnd, tile=tile)
    torch.cuda.synchronize()
    want = R.resblock1_mrf_plain(x, branches, bounds=bnd)
    assert float((got - want).abs().max()) <= ATOL
    assert bool((got[1, :, n // 4:] == 0).all())


def test_kernel_refuses_bad_arguments(cuda):
    x = torch.zeros(1, 12, 64, device=cuda)  # C=12 is not a multiple of 8
    w, b = torch.zeros(1, 12, 12, 3, device=cuda), torch.zeros(1, 12, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        R.resblock1_branch(x, w, b, w, b, kernel=3, dilations=(1,))
    x = torch.zeros(1, 16, 64, device=cuda).transpose(1, 2).contiguous().transpose(1, 2)
    w, b = torch.zeros(1, 16, 16, 3, device=cuda), torch.zeros(1, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        R.resblock1_branch(x, w, b, w, b, kernel=3, dilations=(1,))
