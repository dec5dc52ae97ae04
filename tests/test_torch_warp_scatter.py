"""The scatter rule of the warp kernel (vsc_tpu_torch/csrc/warp.cu), as a
numpy model, against the gather warp bit for bit: the port's plain version
(vsc_tpu_torch/ops/warp.py, which the kernel is held to on the card) and
the JAX package's (vsc_tpu/ops/warp.py). Each source goes to its floor
target x = src + k (key z) and, when frac > 0.3, its ceil target x = src +
k + 1 (key 2 + z), where x - src lies in the eye's window; the 64-bit word
(orderable(key) << 32) | src is reduced with a max; the winner's class,
weight and colors are recomputed from its source. Seeded depths: smooth,
flat (every source ties), steps (ties across shifts and classes), -0.0,
NaN, +-inf and depth outside [0, 1], at whole and fractional
max_disparity. This shows the rule is right before the card runs it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsc_tpu.ops.warp import forward_warp_stereo as jax_warp
from vsc_tpu_torch.ops.warp import forward_warp_stereo as port_warp


def _word(key, src):
    """(orderable(key) << 32) | src, -0.0 first made +0.0."""
    key = np.where(key == 0, np.float32(0), key).astype(np.float32)
    u = key.view(np.uint32)
    u = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return (u.astype(np.uint64) << np.uint64(32)) | src.astype(np.uint64)


def _disp(z, maxd, sign):
    d = (z * np.float32(maxd)) * np.float32(sign)
    k = np.floor(d)
    return k, d - k


def scatter_warp(image, depth, max_disparity):
    """numpy model of the kernel: (left, left_mask, right, right_mask) as
    forward_warp_stereo returns them."""
    B, H, W, _ = image.shape
    D = int(np.floor(max_disparity)) + 1
    z = depth.astype(np.float32)
    b, y, src = np.meshgrid(np.arange(B), np.arange(H), np.arange(W),
                            indexing="ij")
    out = []
    with np.errstate(invalid="ignore"):
        for sign, lo, hi in ((1, 0, D + 1), (-1, -D, 1)):
            k, frac = _disp(z, max_disparity, sign)
            words = np.zeros((B, H, W), np.uint64)
            for ok, shift, key in (
                    ((k >= lo) & (k <= hi), 0, z),
                    ((frac > np.float32(0.3)) & (k >= lo - 1)
                     & (k <= hi - 1), 1, np.float32(2) + z)):
                x = src + np.where(ok, k, 0).astype(np.int64) + shift
                ok = ok & (x >= 0) & (x < W)
                np.maximum.at(words, (b[ok], y[ok], x[ok]),
                              _word(key, src)[ok])
            has = words != 0
            wsrc = (words & np.uint64(0xFFFFFFFF)).astype(np.int64)
            kw, fw = _disp(np.take_along_axis(z, wsrc, axis=2),
                           max_disparity, sign)
            ceil_class = (src - wsrc) == kw.astype(np.int64) + 1
            wgt = np.where(ceil_class, fw, np.float32(1) - fw)
            mask = has & (wgt > np.float32(0.1))
            img = np.take_along_axis(image, wsrc[..., None], axis=2)
            out += [np.where(has[..., None], img, 0).astype(np.float32),
                    mask.astype(np.float32)]
    return tuple(out)


def _depth(case, shape, seed):
    rng = np.random.default_rng(seed)
    B, H, W = shape
    if case == "smooth":
        xx = np.linspace(0.0, 6.0, W, dtype=np.float32)
        d = 0.5 + 0.4 * np.sin(xx)[None, None] + 0.01 * rng.random(shape)
    elif case == "flat":
        d = np.full(shape, 0.5)
    elif case == "steps":
        d = np.floor(rng.random(shape) * 4) / 4
    else:
        d = rng.random(shape) * 1.6 - 0.3
        flat = d.reshape(-1)
        flat[::7] = -0.0
        flat[3::11] = 0.0
        flat[5::13] = np.nan
        flat[1::17] = np.inf
        flat[2::19] = -np.inf
    return np.ascontiguousarray(d, dtype=np.float32)


@pytest.mark.parametrize("case", ["smooth", "flat", "steps", "specials"])
@pytest.mark.parametrize("max_disparity", [6.0, 7.3, 12.0])
def test_scatter_rule_equals_gather(case, max_disparity):
    shape = (2, 5, 97)
    depth = _depth(case, shape, 3)
    image = np.random.default_rng(4).uniform(
        -20.0, 280.0, shape + (3,)).astype(np.float32)
    got = scatter_warp(image, depth, max_disparity)
    want = port_warp(torch.from_numpy(image), torch.from_numpy(depth),
                     max_disparity)
    ref = jax_warp(jnp.asarray(image), jnp.asarray(depth), max_disparity)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(g, np.asarray(r))


def test_scatter_tie_goes_to_the_largest_source():
    # two sources whose floor targets meet with one key: the gather's first
    # shift in scan order is the largest source, in both eyes
    depth = np.full((1, 1, 12), 0.0, np.float32)
    depth[0, 0, 3] = 0.5          # left eye: lands on x = 3 + 2 = 5
    depth[0, 0, 5] = 0.0          # lands on x = 5 with key 0 < 0.5
    depth[0, 0, 4] = 0.25         # lands on x = 4 + 1 = 5, key 0.25
    image = np.arange(36, dtype=np.float32).reshape(1, 1, 12, 3)
    got = scatter_warp(image, depth, 4.0)
    want = port_warp(torch.from_numpy(image), torch.from_numpy(depth), 4.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    flat = np.zeros((1, 1, 12), np.float32)
    got = scatter_warp(image, flat, 4.0)
    want = port_warp(torch.from_numpy(image), torch.from_numpy(flat), 4.0)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[0][0, 0, 5], image[0, 0, 5])


@pytest.mark.parametrize("max_disparity", [0.2, 0.3, 0.45])
def test_scatter_minus_zero_ties_plus_zero(max_disparity):
    # the one way keys -0.0 and +0.0 meet at one target: in the right eye a
    # source at depth -2 sends its ceil candidate (key 2 + -2 = +0.0) to
    # x = src + 1, where the next source, at depth -0.0, sends its floor
    # candidate (key -0.0). The gather ties them (+0.0 > -0.0 is false) and
    # keeps the larger source; ordered bits without the canonical +0.0
    # would pick the other.
    depth = np.zeros((1, 2, 16), np.float32)     # each source on itself
    depth[:, :, 6] = -2.0
    depth[:, :, 7] = -0.0
    image = np.arange(96, dtype=np.float32).reshape(1, 2, 16, 3)
    got = scatter_warp(image, depth, max_disparity)
    want = port_warp(torch.from_numpy(image), torch.from_numpy(depth),
                     max_disparity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    np.testing.assert_array_equal(got[2][0, :, 7], image[0, :, 7])
