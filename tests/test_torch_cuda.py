"""The port's CUDA kernels against their plain versions, on a card.

Skipped without a CUDA device. This file imports no JAX, so it also runs on
a machine with a card and no JAX (where tests/conftest.py cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance 1e-4 max-abs at the "highest" and "high" tiers, as chip_smoke.py
states it: up to C*k = 704-term fp32 sums of exact products chained over six
convs, in another order than cuDNN's; at "highest" K2/K3/K4 form each
product as 3xTF32, about 2^-21 from the fp32 product. 5e-3 at "default",
where one bf16 rounding of a conv's input may flip between the two versions
and the chain carries the flip on (measured up to 2.2e-3 for K2 at C=64,
k=11 on the H100; chip_smoke.py says more). K2/K3/K4 run every tier on the
tensor cores (wgmma), whose fp32 sums run in yet another order: the same
bars. K1 runs every tier on wgmma too; one conv carries no flip, so its
x_low tests hold every tier to 1e-4 (K1_ATOL). K1-K3 on bf16
activations (the "bfloat16" mode, "default" only) are held within one bf16
ulp of the fp32-input "default" kernel on the same values, and within the
bar plus one ulp of their plain versions.
"""

import pytest
import torch

import torch.nn.functional as F

from piper_tpu_torch.ops import conv as ops_conv
from piper_tpu_torch.ops.conv import conv_transpose1d_polyphase
from piper_tpu_torch.ops.kernels import conv as K1
from piper_tpu_torch.ops.kernels import folded as K4
from piper_tpu_torch.ops.kernels import interleave as K5
from piper_tpu_torch.ops.kernels import resblock as R
from piper_tpu_torch.ops.kernels.precision import fp32_exact, tier_scope
from piper_tpu_torch.tools.timing import device_kernels, device_ms, profiled

pytestmark = pytest.mark.cuda
ATOL = 1e-4
TIER_ATOL = {"highest": ATOL, "high": ATOL, "default": 5e-3}
TIERS = list(TIER_ATOL)


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
    x = torch.zeros(1, 12, 64, device=cuda)  # C=12 is not a multiple of 16
    w, b = torch.zeros(1, 12, 12, 3, device=cuda), torch.zeros(1, 12, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        R.resblock1_branch(x, w, b, w, b, kernel=3, dilations=(1,))
    x = torch.zeros(1, 16, 64, device=cuda).transpose(1, 2).contiguous().transpose(1, 2)
    w, b = torch.zeros(1, 16, 16, 3, device=cuda), torch.zeros(1, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        R.resblock1_branch(x, w, b, w, b, kernel=3, dilations=(1,))


@pytest.mark.parametrize("c,k,d,n,slope,with_bias", [
    (64, 7, 12, 8192, 0.1, True),   # x_low level 1 at 128 frames
    (32, 5, 6, 32768, 0.1, True),   # x_low level 2 at 128 frames
    (64, 3, 1, 2049, 0.0, True),    # ragged N, no activation
    (32, 7, 3, 1000, 0.1, False),
    (16, 11, 5, 300, 0.1, True),    # one tile, the runtime tap loop
])
def test_conv1d_same_kernel_matches_plain(cuda, c, k, d, n, slope, with_bias):
    gen = torch.Generator().manual_seed(c * k + d + n)
    x = (torch.randn(2, c, n, generator=gen) * 0.3).to(cuda)
    w = (torch.randn(c, c, k, generator=gen) * (c * k) ** -0.5).to(cuda)
    b = (torch.randn(c, generator=gen) * 0.02).to(cuda) if with_bias else None
    before = K1.conv1d_same.launches
    got = K1.conv1d_same(x, w, b, dilation=d, act_slope=slope)
    torch.cuda.synchronize()
    assert K1.conv1d_same.launches == before + 1
    want = K1.conv1d_same_plain(x, w, b, dilation=d, act_slope=slope)
    assert float((got - want).abs().max()) <= ATOL
    # Each output's sum runs in the same order whatever the tile.
    assert torch.equal(K1.conv1d_same(x, w, b, dilation=d, act_slope=slope, tile=32), got)


def test_conv1d_same_kernel_refuses_bad_arguments(cuda):
    """K1 takes every square C up to 128 in its narrow design (C=12 runs as
    16 zero-padded channels; C=120 at k=11, 633 KB of weights, streams them
    an atom of a tap at a time), each against its plain version; it refuses
    another dtype, C past 256 (C=129 runs the wide design), "default" in
    the wide design, and a window no tile fits beside a weight slot."""
    gen = torch.Generator().manual_seed(12)
    for c, k, d in ((12, 3, 1), (120, 11, 5)):
        x = (torch.randn(2, c, 1000, generator=gen) * 0.3).to(cuda)
        w = (torch.randn(c, c, k, generator=gen) * (c * k) ** -0.5).to(cuda)
        b = (torch.randn(c, generator=gen) * 0.02).to(cuda)
        for tier in TIERS:
            got = K1.conv1d_same(x, w, b, dilation=d, act_slope=0.1, precision=tier)
            torch.cuda.synchronize()
            want = K1.conv1d_same_plain(x, w, b, dilation=d, act_slope=0.1, precision=tier)
            assert _max_err(got, want) <= K1_ATOL, (c, tier)
    x = torch.zeros(1, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        K1.conv1d_same(x, torch.zeros(16, 16, 3, device=cuda, dtype=torch.float64))
    x = torch.zeros(1, 257, 64, device=cuda)
    with pytest.raises(ValueError, match="at most 256"):
        K1.conv1d_same(x, torch.zeros(257, 257, 3, device=cuda))
    x = torch.zeros(1, 129, 64, device=cuda)
    with pytest.raises(ValueError, match="'default'"):
        K1.conv1d_same(x, torch.zeros(129, 129, 3, device=cuda), precision="default")
    x = torch.zeros(1, 120, 64, device=cuda)  # pad 150: 374 KB of tf32 window planes
    with pytest.raises(ValueError, match="shared memory"):
        K1.conv1d_same(x, torch.zeros(120, 120, 11, device=cuda), dilation=30)
    x = torch.zeros(1, 128, 64, device=cuda)  # pad 300: 170 KB of window buffers
    with pytest.raises(ValueError, match="shared memory"):
        K1.conv1d_same(x, torch.zeros(128, 128, 11, device=cuda), dilation=60)


def _max_err(got, want):
    return float((got - want).abs().max())


# K1's bar at every tier: one conv has no chain to carry a bf16 rounding
# flip (the kernel and its plain version round the same fp32 input), so the
# tiers differ only in the order of up to C*k = 448-term fp32 sums.
K1_ATOL = 1e-4
X_LOW_CONVS = ((3, 1), (3, 2), (5, 2), (5, 6), (7, 3), (7, 12))  # x_low's (k, d)


def _k1_bounds(n, dev):
    return {"none": None,
            "one_sided": torch.tensor([n, n - 300], dtype=torch.int32, device=dev),
            "two_sided": torch.tensor([[37, n - 401], [0, n // 3]], dtype=torch.int32, device=dev),
            "empty_and_full": torch.tensor([[500, 500], [-3, n + 9]], dtype=torch.int32,
                                           device=dev)}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("c", [16, 24, 32, 48, 64, 120])  # 24, 120: zero-padded to 32, 128
def test_conv1d_same_kernel_x_low_convs_with_bounds(cuda, tier, c):
    """K1 against its plain version at every (k, d) of x_low's ResBlock2
    convs (and k=11, the ResBlock1 branch's widest, at C=64 and 120), B=2
    at a ragged N, every bounds case (one- and two-sided, empty and full
    rows), one launch counted per call; bit-equal when the time tile
    changes (each output's sum runs in the same order whatever the tile).
    Every tier on wgmma ("highest" as 3xTF32), within 1e-4."""
    gen = torch.Generator().manual_seed(c)
    n = 3001
    x = (torch.randn(2, c, n, generator=gen) * 0.3).to(cuda)
    convs = X_LOW_CONVS + (((11, 5),) if c in (64, 120) else ())
    for k, d in convs:
        w = (torch.randn(c, c, k, generator=gen) * (c * k) ** -0.5).to(cuda)
        b = (torch.randn(c, generator=gen) * 0.02).to(cuda)
        for case, bnd in _k1_bounds(n, cuda).items():
            before = K1.conv1d_same.launches
            got = K1.conv1d_same(x, w, b, dilation=d, act_slope=0.1, bounds=bnd, precision=tier)
            torch.cuda.synchronize()
            assert K1.conv1d_same.launches == before + 1
            want = K1.conv1d_same_plain(x, w, b, dilation=d, act_slope=0.1, bounds=bnd,
                                        precision=tier)
            assert _max_err(got, want) <= K1_ATOL, (k, d, case)
            for cap in (128, 64, 32):  # two and one warpgroups, and half of one
                again = K1.conv1d_same(x, w, b, dilation=d, act_slope=0.1, bounds=bnd,
                                       precision=tier, tile=cap)
                assert torch.equal(again, got), (k, d, case, cap)


@pytest.mark.parametrize("tier", TIERS)
def test_device_ms_counts_the_conv1d_same_kernels(cuda, tier):
    """device_ms by K1's symbol: six launches per call of x_low's level-2
    convs; a wrong expected count raises."""
    gen = torch.Generator().manual_seed(6)
    x = (torch.randn(1, 32, 8192, generator=gen) * 0.3).to(cuda)
    convs = [((torch.randn(32, 32, k, generator=gen) * (32 * k) ** -0.5).to(cuda), d)
             for k, d in X_LOW_CONVS]

    def call():
        return [K1.conv1d_same(x, w, None, dilation=d, act_slope=0.1, precision=tier)
                for w, d in convs]

    assert device_ms(call, reps=3, name="conv1d_same", expected=6) > 0
    with pytest.raises(RuntimeError, match="expected 15 kernels named 'conv1d_same'"):
        device_ms(call, reps=3, name="conv1d_same", expected=5)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("c,k,d,n", [(64, 7, 12, 8192), (32, 5, 6, 32768), (64, 11, 5, 1001),
                                     (16, 9, 2, 777)])  # k=9: the runtime tap loop
def test_conv1d_same_kernel_tiers_match_plain(cuda, tier, c, k, d, n):
    gen = torch.Generator().manual_seed(c + k + d + n)
    x = (torch.randn(2, c, n, generator=gen) * 0.3).to(cuda)
    w = (torch.randn(c, c, k, generator=gen) * (c * k) ** -0.5).to(cuda)
    b = (torch.randn(c, generator=gen) * 0.02).to(cuda)
    got = K1.conv1d_same(x, w, b, dilation=d, act_slope=0.1, precision=tier)
    torch.cuda.synchronize()
    want = K1.conv1d_same_plain(x, w, b, dilation=d, act_slope=0.1, precision=tier)
    assert _max_err(got, want) <= TIER_ATOL[tier]


# At "high" the card's PyTorch convs around the kernels (the flows,
# conv_pre, each level's conv-transpose, conv_post) run in fp32:
# tier_scope keeps cuDNN's TF32 off, since the reference's "high" keeps
# about 16 mantissa bits and TF32 10. The wide levels' ResBlock convs no
# longer go to cuDNN at "high" (K1's wide design runs them, below); their
# shapes stay here for the PyTorch conv wrapper, which a "default" level
# and the CPU still run them through. Against the fp64 conv an fp32 sum of
# up to 2,816 products of outputs up to ~5 lands within a few 1e-6; TF32
# alone lands near 1e-3 (its 2^-11 of each product).
HIGH_CONV_ATOL = 5e-5


@pytest.mark.parametrize("what,b,c_in,c_out,k,d", [
    ("conv1d", 8, 256, 256, 3, 5),     # medium level 0's ResBlock convs
    ("conv1d", 8, 128, 128, 11, 1),    # level 1's
    ("conv1d", 4, 192, 512, 7, 1),     # conv_pre
    ("conv1d", 4, 32, 1, 7, 1),        # conv_post
    ("conv1d", 4, 96, 96, 5, 4),       # x_low's flows, dilated
    ("conv_transpose1d", 4, 512, 256, 16, 8),  # level 0's upsampling, stride 8
    ("conv_transpose1d", 4, 64, 32, 4, 2),     # level 3's, stride 2
])
def test_high_conv_is_fp32_at_the_decode_stage_shapes(cuda, what, b, c_in, c_out, k, d):
    gen = torch.Generator().manual_seed(c_in + c_out + k)
    t = 600
    x = torch.randn(b, c_in, t, generator=gen).to(cuda)
    if what == "conv1d":
        w = (torch.randn(c_out, c_in, k, generator=gen) * (c_in * k) ** -0.5).to(cuda)
        kw, conv, ours = dict(padding=(k - 1) // 2 * d, dilation=d), F.conv1d, ops_conv.conv1d
    else:
        w = (torch.randn(c_in, c_out, k, generator=gen) * (c_in * k / d) ** -0.5).to(cuda)
        kw = dict(stride=d, padding=(k - d) // 2)
        conv, ours = F.conv_transpose1d, ops_conv.conv_transpose1d
    bias = (torch.randn(c_out, generator=gen) * 0.1).to(cuda)
    with tier_scope("high", cuda):
        assert not torch.backends.cudnn.allow_tf32
        got = ours(x, w, bias, **kw)
    torch.cuda.synchronize()
    want = conv(x.double(), w.double(), bias.double(), **kw)
    assert got.shape == want.shape
    assert _max_err(got.double(), want) <= HIGH_CONV_ATOL


# -- K1's wide design (C = 128 to 256: a high voice's levels 0 and 1) ----

# (C, k, d) of the wide levels: a high voice's three branches at every
# dilation, and x_low's level 0 (ResBlock2 at C=128, halo up to 36).
WIDE_CONVS = [(c, k, d) for c in (256, 128) for k in (3, 7, 11) for d in (1, 3, 5)]
X_LOW_WIDE = [(128, k, d) for k, d in X_LOW_CONVS]


def _wide_case(c, k, b, n, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, c, n, generator=gen) * 0.3).to(dev)
    w = (torch.randn(c, c, k, generator=gen) * (c * k) ** -0.5).to(dev)
    bias = (torch.randn(c, generator=gen) * 0.02).to(dev)
    res = (torch.randn(b, c, n, generator=gen) * 0.5).to(dev)
    lo = torch.randint(0, n // 4, (b,), generator=gen)
    hi = torch.randint(n // 2, n + 1, (b,), generator=gen)
    return x, w, bias, res, torch.stack([lo, hi], 1).to(dev, torch.int32)


@pytest.mark.parametrize("tier", ["highest", "high"])
@pytest.mark.parametrize("b,n", [(1, 1001), (8, 2561), (128, 777)])
@pytest.mark.parametrize("c,k,d", WIDE_CONVS + X_LOW_WIDE)
def test_wide_conv_matches_plain(cuda, tier, b, n, c, k, d):
    """K1's wide design against its plain version at the wide levels'
    shapes, ragged N, with and without bounds and residual: TIER_ATOL, the
    residual added bit-equal to adding it after, a launch counted in both
    counters."""
    x, w, bias, res, bnd = _wide_case(c, k, b, n, cuda, c + k + d + b)
    for bounds in (None, bnd):
        for r in (None, res):
            before = (K1.conv1d_same.launches, K1.conv1d_same.wide_launches)
            got = K1.conv1d_same(x, w, bias, dilation=d, act_slope=0.1, bounds=bounds,
                                 residual=r, precision=tier)
            torch.cuda.synchronize()
            assert (K1.conv1d_same.launches, K1.conv1d_same.wide_launches) == (
                before[0] + 1, before[1] + 1)
            want = K1.conv1d_same_plain(x, w, bias, dilation=d, act_slope=0.1, bounds=bounds,
                                        residual=r, precision=tier)
            assert _max_err(got, want) <= TIER_ATOL[tier], (bounds is None, r is None)
            if r is not None:
                alone = K1.conv1d_same(x, w, bias, dilation=d, act_slope=0.1, bounds=bounds,
                                       precision=tier)
                assert torch.equal(got, r + alone)


@pytest.mark.parametrize("tier", ["highest", "high"])
@pytest.mark.parametrize("c,k,d", [(256, 11, 5), (128, 3, 1), (200, 7, 12)])
def test_wide_conv_does_not_depend_on_tile_or_ring(cuda, tier, c, k, d):
    """Every (tile, ring) the wide kernel can launch gives the wrapper's
    output bit for bit (C=200 runs as 256 zero-padded channels)."""
    x, w, bias, res, bnd = _wide_case(c, k, 3, 1500, cuda, c * k)
    code = 0 if tier == "highest" else 1
    want = K1.conv1d_same(x, w, bias, dilation=d, act_slope=0.1, bounds=bnd, residual=res,
                          precision=tier)
    configs = K1.wide_configs(x, k, (k - 1) // 2 * d, 4096, code)
    assert len(configs) > 3
    for config in configs:
        got = K1._launch_wide(x, w, k, bias, bnd, res, d, 0.1, code, config)
        assert torch.equal(got, want), config


@pytest.mark.parametrize("c,dtype,tier", [(64, torch.float32, "high"),
                                          (120, torch.float32, "highest"),
                                          (32, torch.bfloat16, "default"),
                                          (128, torch.float32, "default"),
                                          (128, torch.bfloat16, "default")])
def test_narrow_conv_residual_is_bit_equal_to_adding_after(cuda, c, dtype, tier):
    """K1's narrow design adds the residual in its epilogue as PyTorch adds
    it after the conv, in bf16 too (the conv's output rounded first); C=128
    at "default" runs on it, no wide launch."""
    x, w, bias, res, bnd = (t if t.dtype == torch.int32 else t.to(dtype)
                            for t in _wide_case(c, 7, 2, 3001, cuda, c))
    for bounds in (None, bnd):
        wide = K1.conv1d_same.wide_launches
        got = K1.conv1d_same(x, w, bias, dilation=3, act_slope=0.1, bounds=bounds, residual=res,
                             precision=tier)
        assert K1.conv1d_same.wide_launches == wide
        alone = K1.conv1d_same(x, w, bias, dilation=3, act_slope=0.1, bounds=bounds,
                               precision=tier)
        assert got.dtype == dtype and torch.equal(got, res + alone)


def test_a_high_decode_runs_its_wide_levels_on_k1(card_voices):
    """One decode of the piper_high-width (medium preset) vocoder at "high"
    launches 36 wide K1 kernels, 18 a wide level, and levels 0-1 launch no
    cuDNN fprop kernel: the level's convs are K1's, its conv-transpose
    cuDNN's dgrad."""
    import numpy as np

    from piper_tpu_torch.engine.runtime import PiperRuntime
    from piper_tpu_torch.models.vits import hifigan
    from piper_tpu_torch.models.vits.params import Prefix

    rt = PiperRuntime(*card_voices["medium"], device="cuda")
    hp, params = rt.hparams, rt.params
    gen = torch.Generator().manual_seed(5)
    frames = 96
    z = torch.randn(2, hp.inter_channels, frames, generator=gen).cuda()
    lengths = torch.tensor([frames, 61], dtype=torch.int32, device="cuda")
    mask = (torch.arange(frames, device="cuda")[None] < lengths[:, None]).float()[:, None]
    with torch.inference_mode():
        before = K1.conv1d_same.wide_launches
        out = hifigan.hifigan_generator(z * mask, params, hp, t_mask=mask, t_bounds=lengths,
                                        level_precisions="high")
        torch.cuda.synchronize()
        assert K1.conv1d_same.wide_launches - before == 36
        assert bool(torch.isfinite(out).all())
        p = Prefix(params, "dec")
        x0 = hifigan.conv1d(z * mask, p["conv_pre.weight"], p["conv_pre.bias"], padding=3)
        bounds0 = torch.stack([torch.zeros_like(lengths), lengths], 1)
        got = {}

        def levels():
            x, m, bounds = x0, mask, bounds0
            for i in (0, 1):
                with tier_scope("high", "cuda"):
                    x, m, bounds = hifigan._level(x, m, bounds, i, p, hp, False, "high")
            got["x"] = x

        events = None
        for _ in range(5):  # a window that lost its head is profiled again
            events = profiled(levels)
            if events is not None:
                break
    assert events is not None
    names = [e.key for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert device_kernels(events, "conv1d_same_wide_kernel")[0] == 36
    assert not [n for n in names if "fprop" in n], sorted(set(names))
    assert np.isfinite(got["x"].float().cpu().numpy()).all()


# The mixed tiers (the JAX bench's default: encoder "highest", flows and
# vocoder "high") against fp32 on the same card, through the runtime's own
# tier scopes: with fp32 convs around the kernels only the kernels' "high"
# products differ, about 1.5e-5 from fp32 on the H100 (PERF.md); with TF32
# convs there the same comparisons landed at 4.9e-4 to 9.5e-4. Held to a
# fifth of chip_smoke's 5e-4 margin target, so that TF32 around the kernels
# at any stage would show.
MIXED_MARGIN_ATOL = 1e-4
BENCH_MIX = {"precision": "highest", "vocoder_precision": "high", "flow_precision": "high"}


@pytest.mark.parametrize("quality", ["medium", "x_low"])
def test_mixed_tiers_keep_their_margin_on_the_card(card_voices, quality):
    """Four injected rows of f = 1/2/4/8, one batch at the mixed tiers
    against the same batch at fp32, row by row; then a batch of 32 f=8 rows
    at the mixed tiers, its first and last rows against their own one-row
    runs (cuDNN picks its algorithms by shape)."""
    import numpy as np

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions

    mixed = PiperRuntime(*card_voices[quality], RuntimeOptions(**BENCH_MIX), device="cuda")
    fp32 = PiperRuntime(*card_voices[quality], device="cuda")
    kw = dict(noise_scale=None, length_scale=None, noise_w=None, speaker_ids=None)
    rng = np.random.default_rng(4)

    def noise(b, p):
        width = max(64, -(-2 * p // 64) * 64)
        return (rng.standard_normal((b, 2, p)).astype(np.float32),
                rng.standard_normal((b, mixed.hparams.inter_channels, width)).astype(np.float32))

    rows = [FIXTURE_PHONEME_IDS * f for f in (1, 2, 4, 8)]
    dp, mn = noise(4, len(rows[-1]))
    got, _ = mixed._synthesize_batch_impl(rows, dp_noise=dp, main_noise=mn, **kw)
    want, _ = fp32._synthesize_batch_impl(rows, dp_noise=dp, main_noise=mn, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=MIXED_MARGIN_ATOL, rtol=0)

    ids = FIXTURE_PHONEME_IDS * 8
    dp, mn = noise(32, len(ids))
    batch, _ = mixed._synthesize_batch_impl([ids] * 32, dp_noise=dp, main_noise=mn, **kw)
    for i in (0, 31):
        solo, _ = mixed._synthesize_batch_impl([ids], dp_noise=dp[i:i + 1],
                                               main_noise=mn[i:i + 1], **kw)
        assert batch[i].shape == solo[0].shape
        np.testing.assert_allclose(batch[i], solo[0], atol=MIXED_MARGIN_ATOL, rtol=0)


@pytest.mark.parametrize("tier", TIERS)
def test_branch_kernel_tiers_match_plain(cuda, tier):
    gen = torch.Generator().manual_seed(11)
    c, k, dils, n = 64, 11, (1, 3, 5), 4096
    x = (torch.randn(2, c, n, generator=gen) * 0.3).to(cuda)
    ws = _weights(gen, c, k, len(dils), cuda)
    bnd = torch.tensor([[37, n - 401], [0, n]], dtype=torch.int32, device=cuda)
    got = R.resblock1_branch(x, *ws, kernel=k, dilations=dils, bounds=bnd, precision=tier)
    torch.cuda.synchronize()
    want = R.resblock1_branch_plain(x, *ws, kernel=k, dilations=dils, bounds=bnd, precision=tier)
    assert _max_err(got, want) <= TIER_ATOL[tier]


def _mrf_branches(gen, c, dev):
    return [(*_weights(gen, c, k, 3, dev), k, (1, 3, 5)) for k in (3, 7, 11)]


@pytest.mark.parametrize("tier", TIERS)
def test_mrf_kernel_tiers_match_plain(cuda, tier):
    gen = torch.Generator().manual_seed(12)
    c, n = 32, 8192
    x = (torch.randn(2, c, n, generator=gen) * 0.3).to(cuda)
    branches = _mrf_branches(gen, c, cuda)
    bnd = torch.tensor([[37, n - 401], [0, n // 3]], dtype=torch.int32, device=cuda)
    got = R.resblock1_mrf(x, branches, bounds=bnd, precision=tier)
    torch.cuda.synchronize()
    want = R.resblock1_mrf_plain(x, branches, bounds=bnd, precision=tier)
    assert _max_err(got, want) <= TIER_ATOL[tier]


# Row 0 two-sided, row 1 whole, row 2 dead (every tile skipped).
def _three_rows(n, dev):
    return torch.tensor([[37, n - 101], [0, n], [0, 0]], dtype=torch.int32, device=dev)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("c,k,n", [
    (64, 11, 5000),   # K2's level: ragged against the tile
    (64, 3, 1000),
    (32, 7, 3001),
    (16, 11, 100),    # N below the tile
    (16, 3, 257),
])
def test_branch_kernel_mma_tiers_match_plain(cuda, tier, c, k, n):
    """K2 on the tensor cores at every tier (3xTF32 at "highest", against
    the plain fp32 version): C 16/32/64, k 3/7/11 at dilations 1/3/5, B=3,
    the dead row and the masked edges exactly zero."""
    gen = torch.Generator().manual_seed(c * k + n)
    dils = (1, 3, 5)
    x = (torch.randn(3, c, n, generator=gen) * 0.3).to(cuda)
    ws = _weights(gen, c, k, len(dils), cuda)
    bnd = _three_rows(n, cuda)
    before = R.resblock1_branch.launches
    got = R.resblock1_branch(x, *ws, kernel=k, dilations=dils, bounds=bnd, precision=tier)
    torch.cuda.synchronize()
    assert R.resblock1_branch.launches == before + 1
    want = R.resblock1_branch_plain(x, *ws, kernel=k, dilations=dils, bounds=bnd,
                                    precision=tier)
    assert _max_err(got, want) <= TIER_ATOL[tier]
    assert bool((got[2] == 0).all()) and bool((got[0, :, :37] == 0).all())
    assert bool((got[0, :, n - 101:] == 0).all())


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("c,n", [(64, 4100), (32, 9000), (32, 200), (16, 1001)])
def test_mrf_kernel_mma_tiers_match_plain(cuda, tier, c, n):
    """K3 on the tensor cores at every tier: three branches (k 3/7/11,
    dilations 1/3/5), C 16/32/64, N ragged or below the tile, B=3 with a
    dead row."""
    gen = torch.Generator().manual_seed(c + n)
    x = (torch.randn(3, c, n, generator=gen) * 0.3).to(cuda)
    branches = _mrf_branches(gen, c, cuda)
    bnd = _three_rows(n, cuda)
    before = R.resblock1_mrf.launches
    got = R.resblock1_mrf(x, branches, bounds=bnd, precision=tier)
    torch.cuda.synchronize()
    assert R.resblock1_mrf.launches == before + 1
    want = R.resblock1_mrf_plain(x, branches, bounds=bnd, precision=tier)
    assert _max_err(got, want) <= TIER_ATOL[tier]
    assert bool((got[2] == 0).all()) and bool((got[0, :, n - 101:] == 0).all())


def test_mma_tiers_refuse_c_not_a_multiple_of_16(cuda):
    """Every tier runs on the tensor cores, so C=8 is refused at each of
    them, by K2, K3 and K4, with no launch and no fallback."""
    gen = torch.Generator().manual_seed(8)
    x = (torch.randn(1, 8, 300, generator=gen) * 0.3).to(cuda)
    ws = _weights(gen, 8, 3, 1, cuda)
    before = (R.resblock1_branch.launches, R.resblock1_mrf.launches,
              K4.resblock1_mrf_folded.launches)
    for tier in TIERS:
        with pytest.raises(ValueError, match="multiple of 16"):
            R.resblock1_branch(x, *ws, kernel=3, dilations=(1,), precision=tier)
        with pytest.raises(ValueError, match="multiple of 16"):
            R.resblock1_mrf(x, [(*ws, 3, (1,))], precision=tier)
        with pytest.raises(ValueError, match="multiple of 16"):
            K4.resblock1_mrf_folded(x, [(*ws, 3, (1,))], precision=tier)
    assert (R.resblock1_branch.launches, R.resblock1_mrf.launches,
            K4.resblock1_mrf_folded.launches) == before


# The wgmma stage (every tier: 3xTF32 at "highest", bf16 at "high" and
# "default"): C 16/32/64, k 3, 5 (the run-time tap loop), 7 and 11 at
# dilations 1/3/5, ragged N, B 1 and 3.
WGMMA_TIERS = ["highest", "high", "default"]


def _wgmma_bounds(case, b, n, dev):
    rows = {"none": None,
            "one_sided": [n, n - 300, 0],           # row 1 ends early, row 2 dead
            "two_sided": [[37, n - 101], [0, n], [0, 0]],
            "empty": [[0, 0], [0, n], [n // 3, n]]}[case]
    if rows is None:
        return None
    return torch.tensor(rows[:b], dtype=torch.int32, device=dev)


@pytest.mark.parametrize("tier", WGMMA_TIERS)
@pytest.mark.parametrize("c,k,b,n", [
    (64, 11, 3, 5000), (64, 5, 1, 3001), (64, 3, 3, 777), (64, 7, 1, 4096),
    (32, 11, 1, 2049), (32, 5, 3, 1000), (32, 7, 3, 300), (32, 3, 1, 6000),
    (16, 11, 3, 999), (16, 5, 1, 100), (16, 7, 3, 4097), (16, 3, 3, 257),
])
def test_wgmma_stage_branch_matches_plain(cuda, tier, c, k, b, n):
    """K2 on the wgmma stage against its plain version at every bounds case
    (dead rows and tiles included), exact zeros outside [lo, hi)."""
    gen = torch.Generator().manual_seed(c * k + n)
    dils = (1, 3, 5)
    x = (torch.randn(3, c, n, generator=gen) * 0.3).to(cuda)[:b].contiguous()
    ws = _weights(gen, c, k, len(dils), cuda)
    for case in ("none", "one_sided", "two_sided", "empty"):
        bnd = _wgmma_bounds(case, b, n, cuda)
        before = R.resblock1_branch.launches
        got = R.resblock1_branch(x, *ws, kernel=k, dilations=dils, bounds=bnd, precision=tier)
        torch.cuda.synchronize()
        assert R.resblock1_branch.launches == before + 1
        want = R.resblock1_branch_plain(x, *ws, kernel=k, dilations=dils, bounds=bnd,
                                        precision=tier)
        assert _max_err(got, want) <= TIER_ATOL[tier], case
        if bnd is not None:
            assert bool((got[want == 0] == 0).all()), case


@pytest.mark.parametrize("tier", WGMMA_TIERS)
@pytest.mark.parametrize("c,b,n", [(64, 3, 4100), (32, 1, 9000), (32, 3, 200), (16, 3, 1001),
                                   (16, 1, 33000)])
def test_wgmma_stage_mrf_matches_plain(cuda, tier, c, b, n):
    """K3 on the wgmma stage, branches of k 3, 5 and 11 (the narrower ones
    start with margin consumed; k=5 on the run-time tap loop), at every
    bounds case; K4 on the same input bit-equal to it."""
    gen = torch.Generator().manual_seed(c + n)
    x = (torch.randn(3, c, n, generator=gen) * 0.3).to(cuda)[:b].contiguous()
    branches = [(*_weights(gen, c, k, 3, cuda), k, (1, 3, 5)) for k in (3, 5, 11)]
    for case in ("none", "one_sided", "two_sided", "empty"):
        bnd = _wgmma_bounds(case, b, n, cuda)
        got = R.resblock1_mrf(x, branches, bounds=bnd, precision=tier)
        torch.cuda.synchronize()
        want = R.resblock1_mrf_plain(x, branches, bounds=bnd, precision=tier)
        assert _max_err(got, want) <= TIER_ATOL[tier], case
        if bnd is not None:
            assert bool((got[want == 0] == 0).all())
        assert torch.equal(got, K4.resblock1_mrf_folded(x, branches, fold=4, bounds=bnd,
                                                        precision=tier)), case


@pytest.mark.parametrize("tier", WGMMA_TIERS)
@pytest.mark.parametrize("c", [16, 32, 64])
def test_wgmma_stage_output_does_not_depend_on_tile_or_ring(cuda, tier, c):
    """Every (tile, slots, chunk) the stage offers (R.wgmma_configs) gives the
    wrapper's output bit for bit, for K2 (k=7) and K3."""
    gen = torch.Generator().manual_seed(c)
    n = 3000
    x = (torch.randn(2, c, n, generator=gen) * 0.3).to(cuda)
    bnd = torch.tensor([[37, n - 101], [0, n]], dtype=torch.int32, device=cuda)
    ws = _weights(gen, c, 7, 3, cuda)
    want = R.resblock1_branch(x, *ws, kernel=7, dilations=(1, 3, 5), bounds=bnd, precision=tier)
    configs = R.wgmma_configs(x, R.branch_halo(7, (1, 3, 5)), 256, R.tier_code(tier), 7)
    assert len(configs) > 3
    for config in configs:
        got = R._launch_branch(x, ws, 7, (1, 3, 5), bnd, 0.1, R.tier_code(tier), False, config)
        assert torch.equal(got, want), config
    branches = _mrf_branches(gen, c, cuda)
    want = R.resblock1_mrf(x, branches, bounds=bnd, precision=tier)
    for config in R.wgmma_configs(x, 60, 256, R.tier_code(tier)):
        got = R._launch_mrf(x, branches, bnd, 0.1, R.tier_code(tier), False, 256, config)
        assert torch.equal(got, want), config


@pytest.mark.parametrize("c", [16, 32, 64])
def test_wgmma_stage_bf16_io_matches_the_fp32_input_kernel(cuda, c):
    """bf16 activations at "default" on the wgmma stage, K2 and K3: within
    one bf16 ulp of the fp32-input kernel on the same values."""
    from piper_tpu_torch.ops.kernels.precision import bf16_ulps

    gen = torch.Generator().manual_seed(19 + c)
    n = 2500
    x = (torch.randn(2, c, n, generator=gen) * 0.3).to(cuda).bfloat16()
    bnd = torch.tensor([n, 1200], dtype=torch.int32, device=cuda)
    ws = [w.bfloat16() for w in _weights(gen, c, 11, 3, cuda)]
    got = R.resblock1_branch(x, *ws, kernel=11, dilations=(1, 3, 5), bounds=bnd,
                             precision="default")
    ref = R.resblock1_branch(x.float(), *[w.float() for w in ws], kernel=11, dilations=(1, 3, 5),
                             bounds=bnd, precision="default").bfloat16()
    assert got.dtype == torch.bfloat16 and bf16_ulps(got, ref) <= 1.0
    branches = [tuple(w.bfloat16() for w in br[:4]) + br[4:] for br in _mrf_branches(gen, c, cuda)]
    got = R.resblock1_mrf(x, branches, bounds=bnd, precision="default")
    ref = R.resblock1_mrf(x.float(), [tuple(w.float() for w in br[:4]) + br[4:]
                                      for br in branches], bounds=bnd,
                          precision="default").bfloat16()
    assert got.dtype == torch.bfloat16 and bf16_ulps(got, ref) <= 1.0


def test_wgmma_stage_refuses_other_widths(cuda):
    """C=48 (a multiple of 16, but no wgmma stage width of the bf16 tiers)
    is refused at the bf16 tiers with no launch; "highest" still runs it."""
    gen = torch.Generator().manual_seed(48)
    x = (torch.randn(1, 48, 500, generator=gen) * 0.3).to(cuda)
    ws = _weights(gen, 48, 3, 1, cuda)
    before = (R.resblock1_branch.launches, R.resblock1_mrf.launches)
    for tier in ("high", "default"):
        with pytest.raises(ValueError, match="16, 32 or 64"):
            R.resblock1_branch(x, *ws, kernel=3, dilations=(1,), precision=tier)
        with pytest.raises(ValueError, match="16, 32 or 64"):
            R.resblock1_mrf(x, [(*ws, 3, (1,))], precision=tier)
    assert (R.resblock1_branch.launches, R.resblock1_mrf.launches) == before
    got = R.resblock1_branch(x, *ws, kernel=3, dilations=(1,), precision="highest")
    want = R.resblock1_branch_plain(x, *ws, kernel=3, dilations=(1,), precision="highest")
    assert _max_err(got, want) <= ATOL


@pytest.mark.parametrize("c", [48, 80, 96, 112])
def test_highest_takes_the_other_widths_below_128(cuda, c):
    """At "highest" the stage takes every multiple of 16 below 128, as the
    Pallas kernels do: at C = 48, 80, 96 and 112 (no preset voice's), K2 at
    k 11 and 5 (the run-time tap loop) and K3 against their plain versions
    at every bounds case, K4 bit-equal to K3, and every (tile, slots,
    chunk) of K2 bit-equal to the wrapper's; C = 128 is refused."""
    gen = torch.Generator().manual_seed(c)
    n = 2000
    x = (torch.randn(3, c, n, generator=gen) * 0.3).to(cuda)
    branches = [(*_weights(gen, c, k, 3, cuda), k, (1, 3, 5)) for k in (11, 5, 3)]
    for case in ("none", "one_sided", "two_sided", "empty"):
        bnd = _wgmma_bounds(case, 3, n, cuda)
        for w1s, b1s, w2s, b2s, k, dils in branches[:2]:
            got = R.resblock1_branch(x, w1s, b1s, w2s, b2s, kernel=k, dilations=dils,
                                     bounds=bnd, precision="highest")
            want = R.resblock1_branch_plain(x, w1s, b1s, w2s, b2s, kernel=k, dilations=dils,
                                            bounds=bnd, precision="highest")
            assert _max_err(got, want) <= ATOL, (case, k)
        got = R.resblock1_mrf(x, branches, bounds=bnd, precision="highest")
        want = R.resblock1_mrf_plain(x, branches, bounds=bnd, precision="highest")
        assert _max_err(got, want) <= ATOL, case
        if bnd is not None:
            assert bool((got[want == 0] == 0).all()), case
        assert torch.equal(got, K4.resblock1_mrf_folded(x, branches, fold=4, bounds=bnd,
                                                        precision="highest")), case
    w1s, b1s, w2s, b2s, k, dils = branches[0]
    bnd = _wgmma_bounds("two_sided", 3, n, cuda)
    want = R.resblock1_branch(x, w1s, b1s, w2s, b2s, kernel=k, dilations=dils, bounds=bnd,
                              precision="highest")
    configs = R.wgmma_configs(x, R.branch_halo(k, dils), 256, 0, k)
    assert len(configs) > 3
    for config in configs:
        got = R._launch_branch(x, (w1s, b1s, w2s, b2s), k, dils, bnd, 0.1, 0, False, config)
        assert torch.equal(got, want), config
    x128 = torch.zeros(1, 128, 64, device=cuda)
    with pytest.raises(ValueError, match="a multiple of 16 below 128"):
        R.resblock1_branch(x128, *_weights(gen, 128, 3, 1, cuda), kernel=3, dilations=(1,),
                           precision="highest")


@pytest.mark.parametrize("tier", ["highest", "high"])
def test_device_ms_counts_the_kernel_launches(cuda, tier):
    """device_ms by kernel name: three branch launches per call; a wrong
    expected count raises."""
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn(1, 32, 4096, generator=gen) * 0.3).to(cuda)
    branches = _mrf_branches(gen, 32, cuda)

    def call():
        return [R.resblock1_branch(x, *b[:4], kernel=b[4], dilations=b[5], precision=tier)
                for b in branches]

    ms = device_ms(call, reps=3, name="resblock1_kernel", expected=3)
    assert 0 < ms < device_ms(call, reps=3)
    with pytest.raises(RuntimeError, match="expected 6 kernels named 'resblock1_kernel'"):
        device_ms(call, reps=3, name="resblock1_kernel", expected=2)


@pytest.mark.parametrize("tier", ["highest", "high", "default"])
@pytest.mark.parametrize("fold,c,n", [(2, 64, 4097), (4, 32, 8190), (4, 16, 999)])
def test_mrf_folded_kernel_matches_plain_and_k3(cuda, tier, fold, c, n):
    """K4 against its plain version, and bit for bit against K3: the same
    chain over the same windows, only the loads' and stores' addresses
    differ. N is not a multiple of the fold; row 0 is two-sided, row 1 ends
    early."""
    gen = torch.Generator().manual_seed(fold * n)
    x = (torch.randn(2, c, n, generator=gen) * 0.3).to(cuda)
    branches = _mrf_branches(gen, c, cuda)
    bnd = torch.tensor([[37, n - 401], [0, n // 3]], dtype=torch.int32, device=cuda)
    before = K4.resblock1_mrf_folded.launches
    got = K4.resblock1_mrf_folded(x, branches, fold=fold, bounds=bnd, precision=tier)
    torch.cuda.synchronize()
    assert K4.resblock1_mrf_folded.launches == before + 1
    assert got.shape == x.shape and got.is_contiguous()
    want = K4.resblock1_mrf_folded_plain(x, branches, fold=fold, bounds=bnd, precision=tier)
    assert _max_err(got, want) <= TIER_ATOL[tier]
    assert bool((got[1, :, n // 3:] == 0).all()) and bool((got[0, :, :37] == 0).all())
    assert torch.equal(got, R.resblock1_mrf(x, branches, bounds=bnd, precision=tier))


def test_mrf_folded_kernel_refuses_bad_arguments(cuda):
    gen = torch.Generator().manual_seed(3)
    br16 = _mrf_branches(gen, 16, cuda)
    x = torch.zeros(1, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="fold"):
        K4.resblock1_mrf_folded(x, br16, fold=0)
    with pytest.raises(ValueError, match="tiers"):
        K4.resblock1_mrf_folded(x, br16, precision="float32")
    with pytest.raises(ValueError, match="contiguous"):
        K4.resblock1_mrf_folded(x.transpose(1, 2).contiguous().transpose(1, 2), br16)
    with pytest.raises(ValueError, match="1..4 branches"):
        K4.resblock1_mrf_folded(x, br16 * 2)
    x12 = torch.zeros(1, 12, 64, device=cuda)
    w, b = torch.zeros(1, 12, 12, 3, device=cuda), torch.zeros(1, 12, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        K4.resblock1_mrf_folded(x12, [(w, b, w, b, 3, (1,))])


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("q", [2048, 3000, 129])  # a multiple of the block's 1024, ragged
@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_interleave_kernel_is_bit_equal_to_plain(cuda, r, q, b):
    """K5 is a permutation: bit-equal to its plain version, and one launch."""
    gen = torch.Generator().manual_seed(r * q + b)
    y = torch.randn(b, r, 40, q, generator=gen).to(cuda)
    before = K5.interleave.launches
    got = K5.interleave(y)
    torch.cuda.synchronize()
    assert K5.interleave.launches == before + 1
    assert got.shape == (b, 40, q * r) and got.is_contiguous()
    assert torch.equal(got, K5.interleave_plain(y))


def test_interleave_kernel_refuses_bad_arguments(cuda):
    """A bad input raises on the card; nothing falls back to the plain
    version, and nothing launches."""
    before = K5.interleave.launches
    y = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        K5.interleave(y.double())
    with pytest.raises(ValueError, match="contiguous"):
        K5.interleave(y.transpose(2, 3))
    with pytest.raises(ValueError, match=r"\(B, r, c, q\)"):
        K5.interleave(y[0])
    with pytest.raises(ValueError, match="1 to 8"):
        K5.interleave(torch.zeros(1, 9, 8, 64, device=cuda))
    assert K5.interleave.launches == before


@pytest.mark.parametrize("stride,k,padding,output_padding", [
    (8, 16, 4, 0), (2, 4, 1, 0), (4, 8, 2, 0), (2, 5, 1, 0), (1, 3, 1, 0), (3, 7, 2, 2)])
def test_polyphase_conv_transpose_matches_pytorch(cuda, stride, k, padding, output_padding):
    """The polyphase lowering through K5 against F.conv_transpose1d, TF32
    off: the same products summed in another order."""
    gen = torch.Generator().manual_seed(stride * k)
    x = torch.randn(2, 64, 300, generator=gen).to(cuda)
    w = (torch.randn(64, 32, k, generator=gen) / (64 * k) ** 0.5).to(cuda)
    b = (torch.randn(32, generator=gen) * 0.02).to(cuda)
    before = K5.interleave.launches
    with tier_scope("highest", cuda):
        got = conv_transpose1d_polyphase(x, w, b, stride=stride, padding=padding,
                                         output_padding=output_padding)
        want = F.conv_transpose1d(x, w, b, stride=stride, padding=padding,
                                  output_padding=output_padding)
    torch.cuda.synchronize()
    assert K5.interleave.launches == before + (stride > 1)
    assert got.shape == want.shape
    assert _max_err(got, want) <= ATOL


@pytest.fixture(scope="module")
def card_voices(tmp_path_factory):
    """Full-width synthetic medium and x_low voices (seed 0); written only
    where there is a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

    root = tmp_path_factory.mktemp("card_voices")
    return {q: make_synthetic_voice(root / q, quality=q, seed=0) for q in ("medium", "x_low")}


@pytest.mark.parametrize("quality", ["medium", "x_low"])
def test_injected_mixed_length_batch_matches_cpu(card_voices, quality):
    """Four rows of f = 1/2/4/8 with injected noise, one batch on the card
    against the same batch on the CPU: w_ceil equal, each row within 1e-4.
    The vocoder kernels run their per-row bounds at B=4."""
    import numpy as np

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime

    rows = [FIXTURE_PHONEME_IDS * f for f in (1, 2, 4, 8)]
    card = PiperRuntime(*card_voices[quality], device="cuda")
    cpu = PiperRuntime(*card_voices[quality], device="cpu")
    rng = np.random.default_rng(3)
    dp = rng.standard_normal((4, 2, len(rows[-1]))).astype(np.float32)
    mn = rng.standard_normal((4, card.hparams.inter_channels, 64)).astype(np.float32)
    kw = dict(noise_scale=None, length_scale=None, noise_w=None, speaker_ids=None,
              dp_noise=dp, main_noise=mn)
    counters = [R.resblock1_branch, R.resblock1_mrf, K1.conv1d_same]
    before = sum(fn.launches for fn in counters)
    got, _ = card._synthesize_batch_impl(rows, **kw)
    assert sum(fn.launches for fn in counters) > before
    want, _ = cpu._synthesize_batch_impl(rows, **kw)
    np.testing.assert_array_equal(card._durations(rows, dp_noise=dp)[1],
                                  cpu._durations(rows, dp_noise=dp)[1])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_pipeline_on_the_card_matches_synthesize(card_voices):
    """submit_batch equals synthesize_batch, and submit equals a fused
    synthesize, on the card (the same work, queued the same way)."""
    import numpy as np

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.pipeline import ServingPipeline
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions

    rt = PiperRuntime(*card_voices["medium"], RuntimeOptions(mode="fused"), device="cuda")
    batch = [FIXTURE_PHONEME_IDS * f for f in (8, 1, 2)]
    ref = [rt.synthesize_batch(batch, seed=s) for s in range(3)]
    single = rt.synthesize(FIXTURE_PHONEME_IDS, seed=5)
    with ServingPipeline(rt) as pipe:
        futs = [pipe.submit_batch(batch, seed=s) for s in range(3)]
        one = pipe.submit(FIXTURE_PHONEME_IDS, seed=5).result(timeout=300)
        got = [f.result(timeout=300) for f in futs]
    np.testing.assert_array_equal(one, single)
    for res, want in zip(got, ref):
        for g, w in zip(res, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tier", TIERS)
def test_speaker_mix_is_true_fp32_on_the_card(cuda, tier):
    """The 904 x 512 mix product runs with TF32 off under every tier's
    scope: one-hot rows equal the id lookup bit for bit, and a blend
    agrees with the CPU within 1e-6."""
    from dataclasses import replace

    from piper_tpu_torch.models.vits.hparams import PRESETS
    from piper_tpu_torch.models.vits.model import speaker_embedding

    hp = replace(PRESETS["medium"], n_speakers=904, gin_channels=512)
    gen = torch.Generator().manual_seed(9)
    emb = torch.randn(904, 512, generator=gen) * 0.1
    ids = torch.tensor([0, 451, 903, 17])
    mix = torch.zeros(4, 904)
    mix[0, 0], mix[0, 903], mix[1, 17], mix[1, 400] = 0.6, 0.4, 1.2, -0.2
    mix[2, 5] = mix[3, 6] = 1.0
    card = {"emb_g.weight": emb.to(cuda)}
    with tier_scope(tier, cuda):
        by_id = speaker_embedding(card, hp, ids.to(cuda))
        onehot = speaker_embedding(card, hp, torch.nn.functional.one_hot(ids, 904).float()
                                   .to(cuda))
        blend = speaker_embedding(card, hp, mix.to(cuda))
    assert torch.equal(by_id, onehot)
    want = speaker_embedding({"emb_g.weight": emb}, hp, mix)
    assert float((blend.cpu() - want).abs().max()) <= 1e-6


def test_a_bad_speaker_leaves_the_card_usable(tmp_path):
    """An out-of-range id or mix raises ValueError on the host; no
    device-side assert poisons the CUDA context, and the next request
    runs."""
    import numpy as np

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    voice = make_synthetic_voice(tmp_path, quality="test", seed=6, n_speakers=4,
                                 gin_channels=32)
    rt = PiperRuntime(*voice, device="cuda")
    before = rt.synthesize(FIXTURE_PHONEME_IDS, speaker_id=3, seed=1)
    for kw in (dict(speaker_id=4), dict(speaker_id=-1), dict(speaker_mix={4: 1.0})):
        with pytest.raises(ValueError, match="out of range"):
            rt.synthesize(FIXTURE_PHONEME_IDS, seed=1, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(rt.synthesize(FIXTURE_PHONEME_IDS, speaker_id=3, seed=1),
                                  before)


@pytest.mark.parametrize("quality", ["medium", "x_low"])
def test_fused_group_dispatch_does_not_synchronize(card_voices, quality):
    """dispatch_batch(fused=True, ...) queues encode, decode and the copy to
    the host with no host read: under torch.cuda's sync debug mode "error"
    any synchronizing call inside it would raise. Its rows equal the same
    group fetched again."""
    import numpy as np

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions

    rt = PiperRuntime(*card_voices[quality], RuntimeOptions(mode="fused"), device="cuda")
    rows = [FIXTURE_PHONEME_IDS * f for f in (2, 1, 2)]
    kw = dict(pad_rows_to=8, budget_frames=256, seed=3)
    want = rt.fetch_batch(*rt.dispatch_batch(rows, fused=True, **kw))  # first run
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs, meta = rt.dispatch_batch(rows, fused=True, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = rt.fetch_batch(outs, meta)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_close_releases_the_weights_card_memory(card_voices):
    """close() drops the runtime's weights: memory_allocated() falls by at
    least 90% of hbm_bytes() once the runtime has served a fused group."""
    import gc

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions

    rt = PiperRuntime(*card_voices["medium"], RuntimeOptions(mode="fused"), device="cuda")
    rt.fetch_batch(*rt.dispatch_batch([FIXTURE_PHONEME_IDS] * 2, fused=True, pad_rows_to=2))
    weights = rt.hbm_bytes()
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rt.close()
    gc.collect()
    after = torch.cuda.memory_allocated()
    assert rt.hbm_bytes() == 0 and weights > 0
    assert before - after >= 0.9 * weights, (before, after, weights)
    with pytest.raises(RuntimeError, match="closed"):
        rt.synthesize(FIXTURE_PHONEME_IDS)


def _stream_audio(chunks):
    sizes = [len(c.samples) for c in chunks]
    assert [c.start_sample_index for c in chunks] == [sum(sizes[:i]) for i in range(len(sizes))]
    assert [c.is_final for c in chunks] == [False] * (len(chunks) - 1) + [True]
    import numpy as np

    return np.concatenate([c.samples for c in chunks])


def _solo_stream(rt, ids, seed):
    return _stream_audio(list(rt.synthesize_stream_incremental(ids, seed=seed)))


@pytest.mark.parametrize("quality", ["medium", "x_low"])
def test_stream_tick_dispatch_does_not_synchronize(card_voices, quality):
    """StreamingServer driven tick by tick: the tick that dispatches two new
    streams' heads and two running streams' batched window (and waits for
    no copy, the previous tick's having been processed) runs under
    torch.cuda's sync debug mode "error", so no call inside it reads the
    card. Every stream then equals its solo incremental stream."""
    import numpy as np

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime
    from piper_tpu_torch.engine.stream_server import StreamingServer

    rt = PiperRuntime(*card_voices[quality], device="cuda")
    ids = FIXTURE_PHONEME_IDS * 4

    def run(seed0, checked):
        srv = StreamingServer(rt, emit_frames=64, start_worker=False)
        handles = [srv.submit(ids, seed=seed0 + i) for i in range(2)]
        srv.tick()  # two heads, nothing in flight before
        srv.tick()  # their copies waited for, windows not yet dispatched
        assert not srv._inflight and len(srv._active) == 2
        handles += [srv.submit(ids, seed=seed0 + i) for i in range(2, 4)]
        torch.cuda.synchronize()
        if checked:
            torch.cuda.set_sync_debug_mode("error")
        try:
            srv.tick()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        kinds = sorted(w[0] for w in srv._inflight)
        assert kinds == ["headb", "window"], kinds
        chunks = [[] for _ in handles]
        while srv.pending():
            srv.tick()
            for out, h in zip(chunks, handles):
                while not h._s.out.empty():
                    out.append(h._s.out.get_nowait())
        srv.shutdown()
        return [_stream_audio(c) for c in chunks]

    run(100, checked=False)  # first runs of the shapes
    got = run(200, checked=True)
    for i, audio in enumerate(got):
        want = _solo_stream(rt, ids, 200 + i)
        assert audio.shape == want.shape
        np.testing.assert_allclose(audio, want, atol=ATOL, rtol=0)


def test_concurrent_streams_on_the_card_match_solo(card_voices):
    """Four clients stream phrases of 2/4/8/16 x the fixture at once through
    one StreamingServer (its worker): each equals its solo incremental
    stream within 1e-4, the windows were batched, and the vocoder kernels
    ran on the card."""
    import threading

    import numpy as np

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime
    from piper_tpu_torch.engine.stream_server import StreamingServer

    rt = PiperRuntime(*card_voices["medium"], device="cuda")
    cases = [(FIXTURE_PHONEME_IDS * f, 300 + f) for f in (2, 4, 8, 16)]
    out, errors = {}, []
    srv = StreamingServer(rt, emit_frames=64)

    def client(i, ids, seed):
        try:
            out[i] = _stream_audio(list(srv.submit(ids, seed=seed)))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    before = R.resblock1_branch.launches
    threads = [threading.Thread(target=client, args=(i, *c)) for i, c in enumerate(cases)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    srv.shutdown()
    assert not errors, errors
    m = srv.metrics()
    assert m["window_rows"] > m["window_dispatches"]
    assert R.resblock1_branch.launches > before
    for i, (ids, seed) in enumerate(cases):
        want = _solo_stream(rt, ids, seed)
        assert out[i].shape == want.shape
        np.testing.assert_allclose(out[i], want, atol=ATOL, rtol=0)


def test_stream_server_shutdown_leaves_no_worker(card_voices):
    """shutdown() joins the server's worker: no piper-stream-server thread
    is alive after it, streams served or not."""
    import threading

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime
    from piper_tpu_torch.engine.stream_server import StreamingServer

    rt = PiperRuntime(*card_voices["x_low"], device="cuda")
    for streams in (0, 2):
        srv = StreamingServer(rt, emit_frames=64)
        for i in range(streams):
            assert list(srv.submit(FIXTURE_PHONEME_IDS * 2, seed=i))[-1].is_final
        srv.shutdown()
        assert not srv._worker.is_alive()
    assert not [t for t in threading.enumerate()
                if t.name == "piper-stream-server" and t.is_alive()]


def _bf16_case(kernel, gen, dev):
    """(bf16 inputs, kernel call, plain call, fp32-input kernel call) of one
    of K1-K3 at shapes of the main path (x_low's level-2 conv, medium's
    level 2 and 3), bounds on a short second row."""
    if kernel == "conv1d":
        c, k, d, n = 32, 7, 3, 8192
        args = ((torch.randn(2, c, n, generator=gen) * 0.5),
                torch.randn(c, c, k, generator=gen) * (c * k) ** -0.5,
                torch.randn(c, generator=gen) * 0.02)
        kw = dict(dilation=d, act_slope=0.1, bounds=torch.tensor([n, 5000], dtype=torch.int32,
                                                                   device=dev))
        return ([a.to(dev).bfloat16() for a in args], K1.conv1d_same, K1.conv1d_same_plain, kw)
    if kernel == "branch":
        c, k, n = 64, 11, 4096
        x = torch.randn(2, c, n, generator=gen) * 0.3
        args = [x, *_weights(gen, c, k, 3, "cpu")]
        kw = dict(kernel=k, dilations=(1, 3, 5),
                  bounds=torch.tensor([n, 3000], dtype=torch.int32, device=dev))
        return ([a.to(dev).bfloat16() for a in args], R.resblock1_branch,
                R.resblock1_branch_plain, kw)
    c, n = 32, 8192
    x = (torch.randn(2, c, n, generator=gen) * 0.3).to(dev).bfloat16()
    branches = [(*[w.to(dev).bfloat16() for w in _weights(gen, c, k, 3, "cpu")], k, (1, 3, 5))
                for k in (3, 7, 11)]
    kw = dict(bounds=torch.tensor([n, 6000], dtype=torch.int32, device=dev))
    return [x, branches], R.resblock1_mrf, R.resblock1_mrf_plain, kw


def _fp32(args):
    """The bf16 arguments as fp32 tensors holding the same values."""
    return [[(*[t.float() for t in br[:4]], *br[4:]) for br in a] if isinstance(a, list)
            else a.float() for a in args]


@pytest.mark.parametrize("kernel", ["conv1d", "branch", "mrf"])
def test_bf16_kernels_match_plain_and_the_fp32_input_kernel(cuda, kernel):
    """K1-K3 on bf16 activations at "default": the bf16 variant launches
    (counted), returns bf16, is bit-equal or within one bf16 ulp of the
    fp32-input "default" kernel on the same bf16 values with its output
    rounded to bf16 (the same products summed in the same order), and
    within the fp32 bar plus one ulp of its plain version (K1 1e-4, K2/K3
    5e-3: the plain version sums in another order, and the rounding to
    bf16 may then land one step apart)."""
    from piper_tpu_torch.ops.kernels.precision import bf16_ulp, bf16_ulps

    gen = torch.Generator().manual_seed(17)
    args, fn, plain, kw = _bf16_case(kernel, gen, cuda)
    before = fn.launches
    got = fn(*args, precision="default", **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and got.dtype == torch.bfloat16
    ref = fn(*_fp32(args), precision="default", **kw).to(torch.bfloat16)
    assert bf16_ulps(got, ref) <= 1.0
    if kernel == "conv1d":  # one conv, the same fp32 sum rounded once: bit-equal
        assert torch.equal(got, ref)
    want = plain(*args, precision="default", **kw)
    assert want.dtype == torch.bfloat16
    atol = K1_ATOL if kernel == "conv1d" else TIER_ATOL["default"]
    excess = (got.float() - want.float()).abs() - bf16_ulp(torch.maximum(got.float().abs(),
                                                                         want.float().abs()))
    assert float(excess.max()) <= atol


@pytest.mark.parametrize("kernel", ["conv1d", "branch", "mrf"])
@pytest.mark.parametrize("tier", ["highest", "high"])
def test_bf16_kernels_refuse_other_tiers_on_the_card(cuda, kernel, tier):
    gen = torch.Generator().manual_seed(3)
    args, fn, _, kw = _bf16_case(kernel, gen, cuda)
    before = fn.launches
    with pytest.raises(ValueError, match="'default' tier only"):
        fn(*args, precision=tier, **kw)
    assert fn.launches == before


# A voice whose ResBlock1 levels are C=48 and C=24 (the `test` voice's
# shape at upsample_initial_channel 96): widths the K2/K3 stage refuses at
# "high" and "default" (C=24 at every tier), which hifigan._level runs conv
# by conv through K1. In bf16 every conv's output and every residual sum is
# rounded to bf16 (2^-8 relative; the level activations reach ~4, an ulp
# of 2^-6), and the kernel and its plain version sum in other orders, so a
# rounding may land one ulp apart and the two levels carry it on: the bar
# is a few such ulps at the waveform, 5e-2; at "high" the lowered tiers'
# gate, 1e-3.
REFUSED_ATOL = {"high": 1e-3, "bfloat16": 5e-2}


@pytest.mark.parametrize("mode", ["high", "bfloat16"])
def test_refused_widths_run_k1_on_the_card(cuda, monkeypatch, mode):
    """The vocoder of the 48/24-channel voice on the card, at "high" and in
    the "bfloat16" mode (bf16 weights and activations, the kernels at
    "default"), masked with bounds: K1 launches once a conv (two convs at
    two dilations a level: 8), K2 and K3 never, and the waveform is finite
    and within REFUSED_ATOL of its plain version (the same vocoder with
    every kernel wrapper's plain version, on the card)."""
    from dataclasses import replace

    from piper_tpu_torch.models.vits import hifigan
    from piper_tpu_torch.models.vits.hparams import PRESETS
    from piper_tpu_torch.models.vits.params import params_to_torch
    from piper_tpu_torch.models.vits.synthetic import synthetic_params

    hp = replace(PRESETS["test"], upsample_initial_channel=96)
    dtype = torch.bfloat16 if mode == "bfloat16" else torch.float32
    params = params_to_torch(synthetic_params(hp, seed=21), cuda, dtype)
    gen = torch.Generator().manual_seed(21)
    frames = 64
    z = torch.randn(2, hp.inter_channels, frames, generator=gen).to(cuda, dtype)
    lengths = torch.tensor([frames, 41], dtype=torch.int32, device=cuda)
    mask = (torch.arange(frames, device=cuda)[None] < lengths[:, None]).to(dtype)[:, None]

    def run():
        return hifigan.hifigan_generator(z * mask, params, hp, t_mask=mask, t_bounds=lengths,
                                         level_precisions=None if mode == "bfloat16" else mode)

    counters = (K1.conv1d_same, R.resblock1_branch, R.resblock1_mrf)
    before = [fn.launches for fn in counters]
    got = run()
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [8, 0, 0]
    assert bool(torch.isfinite(got).all()) and got.dtype == dtype
    monkeypatch.setattr(K1, "conv1d_same", K1.conv1d_same_plain)
    monkeypatch.setattr(hifigan, "resblock1_branch", R.resblock1_branch_plain)
    monkeypatch.setattr(hifigan, "resblock1_mrf", R.resblock1_mrf_plain)
    want = run()
    assert _max_err(got.float(), want.float()) <= REFUSED_ATOL[mode]


def test_no_pallas_flag_launches_no_kernel_on_the_card(card_voices, monkeypatch):
    """PIPER_TPU_NO_PALLAS=1 (read when the runtime is made) is
    use_pallas=False: a synthesize of the medium voice (K2, K3) and of
    x_low (K1) launches none of K1-K3."""
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime

    monkeypatch.setenv("PIPER_TPU_NO_PALLAS", "1")
    counters = (K1.conv1d_same, R.resblock1_branch, R.resblock1_mrf)
    for quality in ("medium", "x_low"):
        rt = PiperRuntime(*card_voices[quality], device="cuda")
        before = [fn.launches for fn in counters]
        audio = torch.as_tensor(rt.synthesize(FIXTURE_PHONEME_IDS, seed=1))
        torch.cuda.synchronize()
        assert [fn.launches for fn in counters] == before, quality
        assert audio.numel() > 0 and bool(torch.isfinite(audio).all())


# -- the multi-slot layer (parallel/) on virtual slots of the card --------


def _mesh_case(card_voices, b=2, f=2):
    import numpy as np

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.models.vits.params import host_arrays_from_graph
    from piper_tpu_torch.onnx import load_model
    from piper_tpu_torch.engine.runtime import PiperRuntime

    model, config = card_voices["medium"]
    hp = PiperRuntime(model, config, device="cpu").hparams
    params = {k: torch.from_numpy(np.array(v, np.float32))
              for k, v in host_arrays_from_graph(load_model(model).graph).items()}
    ids = np.asarray([FIXTURE_PHONEME_IDS * f] * b, np.int64)
    return hp, params, ids, np.full((b,), ids.shape[1], np.int64)


def _slots(n, **kw):
    from piper_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, devices=["cuda:0"] * n, **kw)


def test_mesh_dp_and_sp_slots_launch_the_kernels(card_voices):
    """dp=2 and sp=2 on two virtual slots of the card: each slot launches
    K2 three times, K3 once and K1's wide design 36 times per call
    (medium), and the dp audio is the one-slot call's within 1e-4."""
    import numpy as np

    from piper_tpu_torch.parallel.serving import ShardedVits

    hp, params, ids, lengths = _mesh_case(card_voices)
    ref, _ = ShardedVits.create(_slots(1), params, hp).synthesize_batch(
        ids, lengths, max_frames=64, seed=3)
    want = {"resblock1_branch": 3, "resblock1_mrf": 1, "conv1d_same": 36}
    for shape, call in ((dict(), "synthesize_batch"), (dict(seq_parallel=2), "synthesize_long")):
        sv = ShardedVits.create(_slots(2, **shape), params, hp)
        kw = dict(max_frames=64, seed=3) if call == "synthesize_batch" else dict(span=32, seed=3)
        audio, _ = getattr(sv, call)(ids, lengths, **kw)
        assert [dict(c) for c in sv.mesh.slot_launches] == [want, want]
        assert np.isfinite(audio).all()
        if call == "synthesize_batch":
            assert np.abs(audio - ref).max() <= ATOL


def test_mesh_tp_and_pp_launch_no_kernel(card_voices):
    """tp=2 and pp=2 run PyTorch's convs only (the JAX rule) and match the
    one-slot call within 1e-4."""
    import numpy as np

    from piper_tpu_torch.parallel.serving import ShardedVits

    hp, params, ids, lengths = _mesh_case(card_voices)
    ref, _ = ShardedVits.create(_slots(1), params, hp).synthesize_batch(
        ids, lengths, max_frames=64, seed=3)
    for shape, call in ((dict(tensor_parallel=2), "synthesize_batch"),
                        (dict(pipeline_parallel=2), "synthesize_pipelined")):
        sv = ShardedVits.create(_slots(2, **shape), params, hp)
        before = (R.resblock1_branch.launches, R.resblock1_mrf.launches, K1.conv1d_same.launches)
        audio, _ = getattr(sv, call)(ids, lengths, max_frames=64, seed=3)
        assert (R.resblock1_branch.launches, R.resblock1_mrf.launches,
                K1.conv1d_same.launches) == before
        assert all(not c for c in sv.mesh.slot_launches)
        assert np.abs(audio - ref).max() <= ATOL


def test_mesh_runtime_on_the_card_matches_one_device(card_voices):
    """PiperRuntime(mesh=dp2) on two virtual slots: a 3-row batch (padded
    to 4, two rows a slot) against the one-device runtime within 1e-4."""
    import numpy as np

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIX
    from piper_tpu_torch.engine.runtime import PiperRuntime

    rt = PiperRuntime(*card_voices["medium"], mesh=_slots(2))
    one = PiperRuntime(*card_voices["medium"], device="cuda")
    batch = [FIX, FIX * 2, FIX * 4]
    for got, want in zip(rt.synthesize_batch(batch, seed=1), one.synthesize_batch(batch, seed=1)):
        assert got.shape == want.shape and np.abs(got - want).max() <= ATOL
    assert all(c["resblock1_mrf"] == 1 for c in rt.mesh.slot_launches)


# -- the seeded draw: JAX's threefry-2x32 normals (ops/kernels/prng.py) ----------

# The kernel's bits and uniforms equal the plain version's bit for bit; its
# normals differ only where CUDA's log1pf or a fused Horner step rounds
# otherwise than PyTorch's log1p and the plain version's once-rounded
# float64 step: an ulp or two of values up to ~5.5.
THREEFRY_ATOL = 2e-6


def _threefry_layouts(dev):
    """(seed, stream, rows, n, frames) of the three layouts at the main
    path's shapes: noise_probe's (192, 256) prior row (one seed) and (4,
    192, 256) per-row windows (per-row seeds and frames on the card), and
    per_frame_noise's (2, 192, 128) from frame -47 (one seed)."""
    from piper_tpu_torch.tools.noise_probe import draw_cases

    cases = draw_cases(torch, 256)
    return {"rows": cases["prior"], "per_row_frame": cases["stream_rows"],
            "per_frame": (7, 1, 2, 192, torch.arange(-47, 81, device=dev))}


@pytest.mark.parametrize("layout", ["rows", "per_frame", "per_row_frame"])
def test_threefry_kernel_matches_plain(cuda, layout):
    from piper_tpu_torch.ops.kernels import prng

    seed, stream, rows, n, frames = _threefry_layouts(cuda)[layout]
    for output in ("bits", "uniform", "normal"):
        before = prng.threefry_normal.launches
        got = prng.threefry_normal(seed, stream, rows, n, frames, device=cuda, output=output)
        torch.cuda.synchronize()
        assert prng.threefry_normal.launches == before + 1
        want = prng.threefry_normal_plain(seed, stream, rows, n, frames, device=cuda,
                                          output=output)
        assert got.shape == want.shape and got.device.type == "cuda"
        if output == "normal":
            assert float((got - want).abs().max()) <= THREEFRY_ATOL
        else:
            assert torch.equal(got, want), output
    cpu = prng.threefry_normal_plain(
        seed.cpu() if isinstance(seed, torch.Tensor) else seed, stream, rows, n,
        None if frames is None else frames.cpu())
    assert float((got.cpu() - cpu).abs().max()) <= THREEFRY_ATOL


def test_seeded_synthesis_on_the_card_matches_the_cpu(card_voices):
    """The same seed on the card and on the CPU: the durations equal and
    the waveform within the fp32 bar (both draw JAX's threefry noise)."""
    import numpy as np

    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.engine.runtime import PiperRuntime
    from piper_tpu_torch.ops.kernels import prng

    card = PiperRuntime(*card_voices["medium"], device="cuda")
    cpu = PiperRuntime(*card_voices["medium"], device="cpu")
    ids = FIXTURE_PHONEME_IDS * 2
    before = prng.threefry_normal.launches
    a = card.synthesize(ids, seed=2 ** 32 - 5)
    assert prng.threefry_normal.launches == before + 2  # the duration and prior draws
    b = cpu.synthesize(ids, seed=2 ** 32 - 5)
    np.testing.assert_array_equal(card._durations([ids], seed=2 ** 32 - 5)[1],
                                  cpu._durations([ids], seed=2 ** 32 - 5)[1])
    assert a.shape == b.shape and float(np.abs(a - b).max()) <= 1e-4
