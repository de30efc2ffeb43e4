"""K1's wide design (C = 128 to 256, `ops/kernels/conv.py`,
`csrc/conv1d_wide.cu`) where no card is needed: which convs the vocoder
sends through K1, the residual K1 adds in its epilogue, its argument
checks, its weight image, shared memory and configs, and the benchmark's
reader of its roofline share. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from piper_tpu_torch.models.vits import hifigan
from piper_tpu_torch.ops.kernels import conv as K1
from piper_tpu_torch.ops.kernels.precision import split_bf16, split_tf32

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("c_out,c_in,precision,dtype,device,takes", [
    (64, 64, "high", F32, "cpu", True),          # narrow: K1 everywhere (plain on the CPU)
    (32, 32, "bfloat16", BF16, "cuda", True),
    (120, 120, None, F32, "cuda", True),
    (128, 128, "high", F32, "cuda", True),       # wide: a high voice's level 1
    (256, 256, "high", F32, "cuda", True),       # level 0
    (256, 256, None, F32, "cuda", True),         # None is "highest"
    (256, 256, "highest", F32, "cuda", True),
    (192, 192, "high", F32, "cuda", True),
    (256, 256, "default", F32, "cuda", False),   # cuDNN on TF32 tensor cores
    (256, 256, "bfloat16", BF16, "cuda", False),
    (128, 128, "default", BF16, "cuda", False),
    (256, 256, "high", F32, "cpu", False),       # XLA's conv in the reference
    (128, 128, None, F32, "cpu", False),
    (512, 512, "high", F32, "cuda", False),      # past K1's widths
    (256, 128, "high", F32, "cuda", False),      # not square
    (1, 192, "high", F32, "cuda", False),
])
def test_k1_takes_square_convs_by_width_tier_dtype_and_device(c_out, c_in, precision, dtype,
                                                              device, takes):
    assert hifigan.k1_takes(c_out, c_in, precision, dtype, torch.device(device)) is takes


@pytest.mark.parametrize("precision,dtype", [("highest", F32), ("high", F32), ("default", F32),
                                             ("default", BF16)])
@pytest.mark.parametrize("bounds", [None, [[3, 90], [0, 41]]])
def test_plain_residual_is_bit_equal_to_adding_after(precision, dtype, bounds):
    rng = np.random.default_rng(7)
    x, res = (torch.from_numpy(rng.standard_normal((2, 24, 96)).astype(np.float32)).to(dtype)
              for _ in range(2))
    w = torch.from_numpy((rng.standard_normal((24, 24, 5)) * 0.1).astype(np.float32)).to(dtype)
    b = torch.from_numpy((rng.standard_normal(24) * 0.02).astype(np.float32)).to(dtype)
    kw = dict(dilation=3, act_slope=0.1, bounds=bounds, precision=precision)
    got = K1.conv1d_same_plain(x, w, b, residual=res, **kw)
    assert got.dtype == dtype and torch.equal(got, res + K1.conv1d_same_plain(x, w, b, **kw))
    # the CPU wrapper runs the plain version, residual and all, and counts no launch
    before = (K1.conv1d_same.launches, K1.conv1d_same.wide_launches)
    assert torch.equal(K1.conv1d_same(x, w, b, residual=res, **kw), got)
    assert (K1.conv1d_same.launches, K1.conv1d_same.wide_launches) == before


@pytest.mark.parametrize("c,tier,wide", [
    (120, 0, False), (127, 1, False),            # narrow at every tier
    (128, 0, True), (128, 1, True),               # "highest" and "high" from 128
    (128, 2, False),                              # "default" (and bf16) keeps the narrow design
    (129, 2, True), (256, 2, True),               # past it: the wide design, which refuses
    (200, 1, True), (256, 0, True),
])
def test_wide_design_by_width_and_tier(c, tier, wide):
    """Which design a CUDA tensor's conv launches: the wide one from 128
    channels at "highest" and "high", and past 128 at every tier; C=128 at
    "default" stays on the narrow design, which takes it."""
    assert K1.wide_design(c, tier) is wide


def test_wide_argument_checks():
    """At K1's widest: non-square weights, an even kernel, C past 256 and a
    residual of another shape are refused on every device."""
    x = torch.zeros(1, 256, 64)
    with pytest.raises(ValueError, match="square"):
        K1.conv1d_same(x, torch.zeros(256, 128, 3))
    with pytest.raises(ValueError, match="odd"):
        K1.conv1d_same(x, torch.zeros(256, 256, 4))
    with pytest.raises(ValueError, match="at most 256"):
        K1.conv1d_same(torch.zeros(1, 272, 64), torch.zeros(272, 272, 3))
    with pytest.raises(ValueError, match="residual"):
        K1.conv1d_same(x, torch.zeros(256, 256, 3), residual=torch.zeros(1, 256, 63))
    with pytest.raises(ValueError, match="dtype"):
        K1.conv1d_same(x, torch.zeros(256, 256, 3), residual=torch.zeros(1, 256, 64, dtype=BF16))


def _unswizzle(img: torch.Tensor, elem: int) -> torch.Tensor:
    """The wide image (n, q, k, 2, 128, kc) back to (2, C_out, C_in, k) by
    the card's 64-byte swizzle: row r's 16-byte group g holds group g ^ (r
    / 2 % 4) of the row."""
    n, q, k, p, nt, kc = img.shape
    per = 16 // elem
    r = torch.arange(nt)[:, None]
    pos = torch.arange(kc)[None, :]
    stored = ((pos // per) ^ (r // 2 % 4)) * per + pos % per  # where column pos lives
    rows = torch.gather(img, 5, stored.expand(img.shape))
    return rows.permute(3, 0, 4, 1, 5, 2).reshape(p, n * nt, q * kc, k)


@pytest.mark.parametrize("tier,c,k", [(1, 256, 3), (1, 200, 11), (0, 256, 7), (0, 128, 3),
                                      (1, 128, 5)])
def test_wide_image_is_the_tiers_split_in_the_swizzled_units(tier, c, k):
    """The image holds, per block of 128 output channels, per chunk of 64
    bytes of input channels and per tap, one 16 KB unit of both planes;
    unswizzled it is the tier's split of w zero-padded to a multiple of
    128."""
    rng = np.random.default_rng(c + k)
    w = torch.from_numpy(rng.standard_normal((c, c, k)).astype(np.float32))
    img = K1.wide_image(w, tier)
    cp, kc = -(-c // 128) * 128, 16 if tier == 0 else 32
    elem = 4 if tier == 0 else 2
    assert img.shape == (cp // 128, cp // kc, k, 2, 128, kc)
    assert img[0, 0, 0].numel() * elem == 16384
    padded = torch.nn.functional.pad(w, (0, 0, 0, cp - c, 0, cp - c))
    want = torch.stack(split_tf32(padded) if tier == 0 else split_bf16(padded))
    assert torch.equal(_unswizzle(img, elem).float(), want)


def test_wide_weight_image_is_laid_out_once_and_apart_from_the_narrow_one():
    w = torch.ones(128, 128, 3)
    img = K1.wide_weight_image(w, 1)
    assert K1.wide_weight_image(w, 1) is img
    narrow = K1.weight_image(w, 1)
    assert narrow is not img and narrow.shape == (1, 3, 2, 2, 128, 64)
    w.mul_(2)
    assert K1.wide_weight_image(w, 1) is not img


def test_wide_shared_memory_figures():
    """csrc/conv1d_wide.cuh::smem_bytes: 1024 to align the ring, then the
    ring's 16 KB slots, two window buffers (2 planes x 64 bytes x (W + 1)
    lanes) and two raw buffers (32 bf16-tier or 16 tf32-tier channels of
    fp32 rows of stage_stride(W) floats), or the output stage (128 rows of
    stage_stride(tile) floats) where larger, rounded to 128; then the
    slots' barriers."""
    # level 0's widest conv (k=11, d=5: pad 25), tile 256, 4 slots, "high"
    assert K1.wide_smem_bytes(256, 25, 4, 1) == (
        1024 + 4 * 16384 + 2 * 128 * 307 + 2 * 4 * 32 * 308 + 128) == 224128
    # "highest": half the raw channels
    assert K1.wide_smem_bytes(256, 25, 4, 0) == 224128 - 2 * 4 * 16 * 308 == 184704
    # k=3, d=1, tile 128, 2 slots: two blocks share an SM (2 x (101,248 + 1024) <= 233,472)
    assert K1.wide_smem_bytes(128, 1, 2, 1) == (
        1024 + 2 * 16384 + 2 * 128 * 131 + 2 * 128 * 132 + 128) == 101248
    # tile 64, pad 1, 2 slots: the output stage (128 x 68 floats) is not the larger
    assert K1.wide_smem_bytes(64, 1, 2, 1) == (
        1024 + 2 * 16384 + 2 * 128 * 67 + 2 * 128 * 68 + 128)


class _Props:
    shared_memory_per_block_optin = 232448
    multi_processor_count = 132


def test_wide_configs_fit_and_the_pick_at_the_batch_shapes(monkeypatch):
    """Every (tile, ring) listed fits in shared memory for every conv of a
    high voice's wide levels and x_low's level 0, at both tiers; at a
    128-row batch the pick takes tiles of 256 and 4 slots (3 where 4 do not
    fit beside x_low's widest window), as the H100 sweep ranked them; at
    one row, tiles of 64."""
    monkeypatch.setattr(K1, "_props", lambda device: _Props())
    for tier in (0, 1):
        for c in (128, 192, 256):
            for k, d in ((3, 1), (7, 3), (11, 5), (7, 12), (5, 6)):
                pad = (k - 1) // 2 * d
                x = torch.empty((4, c, 4096), device="meta")
                found = K1.wide_configs(x, k, pad, 4096, tier)
                assert found and all(t in (64, 128, 192, 256) and 2 <= r <= 4
                                     and K1.wide_smem_bytes(t, pad, r, tier) <= 232448
                                     for t, r in found), (tier, c, k, d)
                assert K1.pick_wide(x, k, pad, 4096, tier) in found

    def pick(b, c, n, k, d, tier=1, tile=4096):
        return K1.pick_wide(torch.empty((b, c, n), device="meta"), k, (k - 1) // 2 * d, tile,
                            tier)

    assert pick(128, 256, 2560, 3, 1) == (256, 4)
    assert pick(128, 256, 2560, 11, 5) == (256, 4)
    assert pick(128, 128, 20480, 11, 1) == (256, 4)
    assert pick(128, 128, 20480, 7, 12) == (256, 3)
    assert pick(128, 128, 20480, 7, 12, tier=0) == (256, 4)
    assert pick(1, 256, 800, 11, 5) == (64, 4)
    assert pick(128, 256, 2560, 11, 5, tile=100)[0] == 64  # a tile cap takes a tile under it


def _piper_high():
    from benchmark.core import spec as specs

    return specs.config("piper_high")


def test_wide_roofline_reader_on_a_synthetic_trace():
    """The reader's work is the ResBlock1 levels wider than 64 channels:
    at piper_high's widths level 0 (C=256, 8 samples a frame) and level 1
    (C=128, 64), 3 kernels x 3 dilations x 2 convs of 2 C^2 k a sample:
    132.1 and 264.2 MFLOP a frame. Its device time is the kernels whose
    symbol holds "conv1d_" alone; without one it reads nothing, and a
    ResBlock2 voice has no such work."""
    from benchmark.core import costs
    from benchmark.core import spec as specs
    from benchmark.core.window import Window

    config = _piper_high()
    hp = config["hparams"]
    frames = [[100, 200]]
    per_frame = sum(3 * 2 * 2.0 * c * c * k * n for c, n in ((256, 8), (128, 64))
                    for k in (3, 7, 11))
    assert per_frame == pytest.approx(132.1e6 + 264.2e6, rel=1e-3)
    reader = specs.reader("wide_resblock_roofline")
    flops, nbytes = reader.work(hp, frames)
    assert flops == pytest.approx(per_frame * 300)
    every, narrow = (costs.resblock1_work(hp, frames, max_width=m) for m in (512, 64))
    assert nbytes == pytest.approx(every[1] - narrow[1]) and nbytes > 0

    w = Window(t_open=0.0, t_close=2.0, frames=frames, phonemes=[[14, 28]],
               traced_frames=frames)
    trace = {"busy_s": 0.9, "window_s": 1.0, "kernel_s": {
        "void piper_k1w::conv1d_same_wide_kernel<1>(piper_k1w::Args)": 0.3,
        "void piper_k1::conv1d_same_kernel<(int)64, (int)1, float>(piper_k1::Args)": 0.1,
        "void piper_rb::resblock1_kernel<true, false, 1, float, 32>(x)": 0.5,
        "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw": 0.25,
        "void at::native::elementwise_kernel<128, 2>(x)": 0.2}}

    def read(name, t=trace, c=config):
        return specs.reader(name).read(specs.Context(config=c, mix={}, window=w, trace=t))

    want = 100 * costs.bound_s(flops, nbytes, "high") / 0.4
    assert read("wide_resblock_roofline") == pytest.approx(want)
    # K2/K3's share reads its own kernels only
    k23 = costs.resblock1_work(hp, frames)
    assert read("resblock_roofline") == pytest.approx(100 * costs.bound_s(*k23, "high") / 0.5)
    no_k1 = dict(trace, kernel_s={k: v for k, v in trace["kernel_s"].items() if "conv1d_" not in k})
    assert read("wide_resblock_roofline", no_k1) is None
    assert read("wide_resblock_roofline", None) is None
    resblock2 = dict(config, hparams=dict(hp, resblock="2"))
    assert reader.work(resblock2["hparams"], frames) == (0.0, 0.0)
    assert read("wide_resblock_roofline", trace, resblock2) is None


def test_a_cpu_decode_keeps_the_wide_levels_off_k1(monkeypatch):
    """On the CPU the wide levels stay PyTorch convs (the JAX reference's
    XLA convs): K1's plain version sees only the narrow levels' convs, each
    with the block's running sum as its residual."""
    from piper_tpu_torch.models.vits.hparams import PRESETS
    from piper_tpu_torch.models.vits.params import params_to_torch
    from piper_tpu_torch.models.vits.synthetic import synthetic_params

    hp = dataclasses.replace(PRESETS["test"], upsample_initial_channel=256)
    params = params_to_torch(synthetic_params(hp, seed=3), torch.device("cpu"), F32)
    seen = []
    plain = K1.conv1d_same_plain

    def spy(x, w, b=None, **kw):
        seen.append((x.shape[1], kw.get("residual") is not None))
        return plain(x, w, b, **kw)

    monkeypatch.setattr(K1, "conv1d_same", spy)
    z = torch.randn(1, hp.inter_channels, 12, generator=torch.Generator().manual_seed(3))
    mask = torch.ones(1, 1, 12)
    out = hifigan.hifigan_generator(z, params, hp, t_mask=mask, level_precisions="high")
    assert torch.isfinite(out).all()
    assert seen and max(c for c, _ in seen) < 128
    assert any(res for _, res in seen) and not all(res for _, res in seen)


def test_resblock_under_a_trace_records_each_conv_and_adds_the_same(monkeypatch):
    """While a per-layer trace collects, a ResBlock's convs add their
    output after the conv (so each is recorded), bit-equal to the sum the
    kernel forms in its epilogue."""
    from piper_tpu_torch.models.vits.params import Prefix
    from piper_tpu_torch.utils.debug_trace import collecting

    rng = np.random.default_rng(11)
    c, k, dils = 32, 3, (1, 3)
    params = {}
    for m in range(len(dils)):
        for conv in ("convs1", "convs2"):
            params[f"rb.{conv}.{m}.weight"] = torch.from_numpy(
                (rng.standard_normal((c, c, k)) * 0.1).astype(np.float32))
            params[f"rb.{conv}.{m}.bias"] = torch.from_numpy(
                (rng.standard_normal(c) * 0.02).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, c, 50)).astype(np.float32))
    plain = hifigan._resblock1(x, Prefix(params, "rb"), dils, precision="high")
    into = {}
    with collecting(into):
        traced = hifigan._resblock1(x, Prefix(params, "rb"), dils, precision="high")
    assert torch.equal(traced, plain)
    assert sorted(into) == [f"rb.{conv}.{m}" for conv in ("convs1", "convs2")
                            for m in range(len(dils))]
