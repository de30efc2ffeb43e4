"""The port's ops (piper_tpu_torch.ops.*) against their JAX twins.

Inputs come from numpy with a fixed seed and go through both functions;
outputs are compared as numpy. Tolerances: 1e-6 for elementwise ops and
exact for masks/index plumbing; 1e-5 for convs and the spline (float32
sums in another order); 2e-5 for attention (the module bar of
tests/test_vits_parity.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piper_tpu.engine import bucketing as jb
from piper_tpu.ops import attention as ja
from piper_tpu.ops import conv as jc
from piper_tpu.ops import masking as jm
from piper_tpu.ops import nn as jn
from piper_tpu.ops import spline as js
from piper_tpu_torch.engine import bucketing as tb
from piper_tpu_torch.ops import attention as ta
from piper_tpu_torch.ops import conv as tc
from piper_tpu_torch.ops import masking as tm
from piper_tpu_torch.ops import nn as tn
from piper_tpu_torch.ops import spline as ts


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got_t, want_j, atol):
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(want_j), atol=atol, rtol=0)


def T(a):
    return torch.tensor(np.asarray(a))


def test_layer_norm_channels():
    rng = np.random.default_rng(0)
    x, g, b = _rand(rng, 2, 16, 9), _rand(rng, 16), _rand(rng, 16)
    _close(tn.layer_norm_channels(T(x), T(g), T(b)),
           jn.layer_norm_channels(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)), 1e-5)


@pytest.mark.parametrize("name", ["gelu_exact", "leaky_relu"])
def test_elementwise(name):
    x = _rand(np.random.default_rng(1), 3, 7, 11, scale=3.0)
    _close(getattr(tn, name)(T(x)), getattr(jn, name)(jnp.asarray(x)), 1e-6)


def test_fused_add_tanh_sigmoid_multiply():
    rng = np.random.default_rng(2)
    a, b = _rand(rng, 2, 8, 5), _rand(rng, 2, 8, 5)
    _close(tn.fused_add_tanh_sigmoid_multiply(T(a), T(b), 4),
           jn.fused_add_tanh_sigmoid_multiply(jnp.asarray(a), jnp.asarray(b), 4), 1e-6)


def test_sequence_mask_and_generate_path():
    lengths = np.array([7, 3], np.int32)
    _close(tm.sequence_mask(T(lengths), 9), jm.sequence_mask(jnp.asarray(lengths), 9), 0)
    rng = np.random.default_rng(3)
    w_ceil = rng.integers(0, 4, size=(2, 7)).astype(np.float32)
    x_mask = np.asarray(jm.sequence_mask(jnp.asarray(lengths), 7))
    w_ceil = w_ceil * x_mask[:, 0]
    y_len = np.minimum(w_ceil.sum(-1), 20).astype(np.int32)
    y_mask = np.asarray(jm.sequence_mask(jnp.asarray(y_len), 20))
    _close(tm.generate_path(T(w_ceil), T(x_mask), T(y_mask)),
           jm.generate_path(jnp.asarray(w_ceil), jnp.asarray(x_mask), jnp.asarray(y_mask)), 0)


@pytest.mark.parametrize(
    "padding,dilation,groups,stride",
    [(0, 1, 1, 1), (2, 3, 1, 1), (3, 2, 1, 1), (1, 1, 4, 1), (1, 1, 1, 2)],
)
def test_conv1d(padding, dilation, groups, stride):
    rng = np.random.default_rng(4)
    x, w, b = _rand(rng, 2, 8, 30), _rand(rng, 6 * 2, 8 // groups, 3, scale=0.3), _rand(rng, 12)
    kw = dict(stride=stride, padding=padding, dilation=dilation, groups=groups)
    _close(tc.conv1d(T(x), T(w), T(b), **kw),
           jc.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw), 1e-5)


@pytest.mark.parametrize("k,d,groups", [(3, 1, 1), (5, 3, 1), (3, 9, 8)])
def test_conv1d_same(k, d, groups):
    rng = np.random.default_rng(5)
    x, w, b = _rand(rng, 2, 8, 40), _rand(rng, 8, 8 // groups, k, scale=0.3), _rand(rng, 8)
    _close(tc.conv1d_same(T(x), T(w), T(b), dilation=d, groups=groups),
           jc.conv1d_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          dilation=d, groups=groups), 1e-5)


@pytest.mark.parametrize("k,u", [(16, 8), (4, 2), (3, 1), (7, 3)])
def test_conv_transpose1d(k, u):
    rng = np.random.default_rng(6)
    x, w, b = _rand(rng, 2, 8, 13), _rand(rng, 8, 4, k, scale=0.3), _rand(rng, 4)
    pad = (k - u) // 2
    _close(tc.conv_transpose1d(T(x), T(w), T(b), stride=u, padding=pad),
           jc.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=u, padding=pad), 1e-5)


@pytest.mark.parametrize("length", [3, 5, 12])
def test_relative_position_helpers(length):
    """All three helpers, on both branches of get_relative_embeddings
    (length < window+1 slices, length > window+1 pads)."""
    rng = np.random.default_rng(7)
    emb = _rand(rng, 1, 9, 4)
    _close(ta.get_relative_embeddings(T(emb), length, 4),
           ja.get_relative_embeddings(jnp.asarray(emb), length, 4), 0)
    rel = _rand(rng, 2, 2, length, 2 * length - 1)
    _close(ta.relative_to_absolute(T(rel)), ja.relative_to_absolute(jnp.asarray(rel)), 0)
    ab = _rand(rng, 2, 2, length, length)
    _close(ta.absolute_to_relative(T(ab)), ja.absolute_to_relative(jnp.asarray(ab)), 0)


@pytest.mark.parametrize("t,valid", [(12, [12, 9]), (3, [3, 2])])
def test_multi_head_attention(t, valid):
    """t=3 < window+1 is the short-sequence branch."""
    rng = np.random.default_rng(8)
    c, heads = 16, 2
    q, k, v = (_rand(rng, 2, c, t) for _ in range(3))
    ek, ev = _rand(rng, 1, 9, c // heads, scale=0.3), _rand(rng, 1, 9, c // heads, scale=0.3)
    mask = np.asarray(jm.sequence_mask(jnp.asarray(np.array(valid)), t))
    attn_mask = mask[:, :, None, :] * mask[:, :, :, None]
    got = ta.multi_head_attention(T(q), T(k), T(v), n_heads=heads, attn_mask=T(attn_mask),
                                  emb_rel_k=T(ek), emb_rel_v=T(ev), window_size=4)
    want = ja.multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   n_heads=heads, attn_mask=jnp.asarray(attn_mask),
                                   emb_rel_k=jnp.asarray(ek), emb_rel_v=jnp.asarray(ev),
                                   window_size=4)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_rational_quadratic_spline_inverse(scale):
    """Inside the interval and on both identity tails (|x| > tail_bound)."""
    rng = np.random.default_rng(9)
    nb = 10
    x = _rand(rng, 2, 1, 30, scale=scale)
    x[0, 0, :3] = [-7.0, 6.5, 5.0]
    uw, uh, ud = _rand(rng, 2, 1, 30, nb), _rand(rng, 2, 1, 30, nb), _rand(rng, 2, 1, 30, nb - 1)
    got = ts.rational_quadratic_spline_inverse(T(x), T(uw), T(uh), T(ud), tail_bound=5.0)
    want, _ = js.rational_quadratic_spline(jnp.asarray(x), jnp.asarray(uw), jnp.asarray(uh),
                                           jnp.asarray(ud), inverse=True, tail_bound=5.0)
    _close(got, want, 1e-5)


def test_bucketing_matches_reference():
    assert tb.DEFAULT_PHONEME_BUCKETS == jb.DEFAULT_PHONEME_BUCKETS
    assert tb.DEFAULT_FRAME_BUCKETS == jb.DEFAULT_FRAME_BUCKETS
    for v in (1, 16, 17, 300, 4096):
        assert tb.bucket_for(v, tb.DEFAULT_PHONEME_BUCKETS) == jb.bucket_for(
            v, jb.DEFAULT_PHONEME_BUCKETS)
    with pytest.raises(tb.BucketOverflowError):
        tb.bucket_for(4097, tb.DEFAULT_PHONEME_BUCKETS)
    np.testing.assert_array_equal(tb.pad_to([3, 1, 2], 8), jb.pad_to([3, 1, 2], 8))
