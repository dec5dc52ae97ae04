"""The port's plain-PyTorch ops (vsc_tpu_torch.ops) against the JAX
package's (vsc_tpu.ops) on the same numpy inputs, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsc_tpu.config import StereoParams
from vsc_tpu.ops import filters as jf
from vsc_tpu.ops import inpaint as jinp
from vsc_tpu.ops import stereo as jst
from vsc_tpu.ops.resize import resize as j_resize
from vsc_tpu.ops.warp import forward_warp_stereo as j_warp
from vsc_tpu_torch.ops import filters as tf
from vsc_tpu_torch.ops import inpaint as tinp
from vsc_tpu_torch.ops import stereo as tst
from vsc_tpu_torch.ops.resize import resize as t_resize
from vsc_tpu_torch.ops.warp import forward_warp_stereo as t_warp

ATOL = 1e-4  # tests/test_blur_pallas.py's bound for the filters


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("method,shape,out_hw,channel_last", [
    ("lanczos4", (2, 20, 48, 3), (20, 61), True),    # pre-stretch
    ("lanczos4", (2, 20, 48), (20, 61), False),
    ("bilinear", (2, 30, 40, 3), (64, 64), True),    # model-size resize
    ("bilinear", (2, 64, 64), (30, 40), False),      # resize back
    ("bilinear", (2, 12, 16), (36, 48), False),      # integer upsample
    ("area", (2, 36, 48, 3), (12, 16), True),        # integer downscale
    ("area", (2, 37, 50), (12, 16), False),          # ragged windows
])
def test_resize_matches_jax(method, shape, out_hw, channel_last):
    x = np.random.default_rng(0).random(shape).astype(np.float32) * 255
    got = t_resize(_t(x), *out_hw, method, channel_last=channel_last).numpy()
    want = np.asarray(j_resize(jnp.asarray(x), *out_hw, method,
                               channel_last=channel_last))
    np.testing.assert_allclose(got, want, atol=ATOL * 255, rtol=1e-6)


@pytest.mark.parametrize("ksize,sigma,gamma,channel_last", [
    (31, 20.0, 0.2, False),     # depth edge softening + gamma
    (31, 20.0, None, False),
    (5, 1.0, None, True),       # unsharp's blur
])
def test_gaussian_blur_matches_jax(ksize, sigma, gamma, channel_last):
    rng = np.random.default_rng(1)
    shape = (2, 24, 80, 3) if channel_last else (2, 24, 80)
    x = rng.random(shape).astype(np.float32)
    got = tf.gaussian_blur(_t(x), ksize, sigma, channel_last, gamma).numpy()
    want = np.asarray(jf.gaussian_blur(jnp.asarray(x), ksize, sigma,
                                       channel_last, gamma))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_blur_reflects_short_axes_like_jnp_pad():
    # a 31-tap window on a 9-row plane reflects more than once
    x = np.random.default_rng(2).random((1, 9, 40)).astype(np.float32)
    got = tf.gaussian_blur(_t(x), 31, 20.0).numpy()
    want = np.asarray(jf.gaussian_blur(jnp.asarray(x), 31, 20.0))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("d,sigma_space", [(5, 25.0), (9, 50.0)])
def test_bilateral_matches_jax(d, sigma_space):
    x = np.random.default_rng(3).integers(0, 256, (2, 20, 36, 3)).astype(
        np.float32)
    got = tf.bilateral_filter(_t(x), d, 30.0, sigma_space).numpy()
    want = np.asarray(jf.bilateral_filter(jnp.asarray(x), d, 30.0,
                                          sigma_space))
    np.testing.assert_allclose(got, want, atol=ATOL * 255, rtol=1e-5)


def test_dilate_and_unsharp_match_jax():
    rng = np.random.default_rng(4)
    m = (rng.random((2, 17, 23)) > 0.9).astype(np.float32)
    np.testing.assert_array_equal(tf.dilate3x3(_t(m)).numpy(),
                                  np.asarray(jf.dilate3x3(jnp.asarray(m))))
    img = rng.integers(0, 256, (2, 17, 23, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tf.unsharp_mask(_t(img), 14.0).numpy(),
        np.asarray(jf.unsharp_mask(jnp.asarray(img), 14.0)), atol=ATOL * 255)


@pytest.mark.parametrize("max_disp", [4.0, 9.7])
def test_warp_matches_jax(max_disp):
    rng = np.random.default_rng(5)
    img = rng.random((2, 24, 96, 3)).astype(np.float32) * 255
    depth = rng.random((2, 24, 96)).astype(np.float32)
    depth = (depth + np.roll(depth, 1, 1) + np.roll(depth, 1, 2)) / 3.0
    got = t_warp(_t(img), _t(depth), max_disp)
    want = j_warp(jnp.asarray(img), jnp.asarray(depth), max_disp)
    for name, g, w in zip(("L", "Lm", "R", "Rm"), got, want):
        g, w = g.numpy(), np.asarray(w)
        if name.endswith("m"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_array_equal(
                np.floor(np.clip(g, 0, 255)), np.floor(np.clip(w, 0, 255)),
                err_msg=name)


def test_pyramid_fill_matches_jax():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (2, 37, 70, 3)).astype(np.float32)
    valid = (rng.random((2, 37, 70, 1)) > 0.2).astype(np.float32)
    for kw in ({"coarse_factor": 4, "return_coarse": True}, {}):
        got = tinp._pyramid_fill(_t(img), _t(valid), **kw).numpy()
        want = np.asarray(jinp._pyramid_fill(jnp.asarray(img),
                                             jnp.asarray(valid), **kw))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)


def test_pyramid_inpaint_matches_jax():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (1, 30, 50, 3)).astype(np.float32)
    hole = (rng.random((1, 30, 50)) > 0.85).astype(np.float32)
    got = tinp.pyramid_inpaint(_t(img), _t(hole)).numpy()
    want = np.asarray(jinp.pyramid_inpaint(jnp.asarray(img),
                                           jnp.asarray(hole)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("params", [
    StereoParams(super_sampling=1.0),
    StereoParams(max_disparity=12.0, convergence=7.0, super_sampling=2.0),
    StereoParams(max_disparity=3.0, convergence=-25.0, super_sampling=3.0),
])
def test_geometry_matches_jax(params):
    for h, w in ((1080, 1920), (72, 128)):
        assert tst.sbs_shapes(h, w, params) == jst.sbs_shapes(h, w, params)
        assert tst._crop_offsets(h, w, params) == jst._crop_offsets(h, w,
                                                                     params)


def test_normalize_and_quantize_match_jax():
    d = np.random.default_rng(8).random((3, 5, 7)).astype(np.float32) * 300
    d[1] = 4.0   # flat frame -> zeros
    np.testing.assert_allclose(tst._normalize_depth(_t(d)).numpy(),
                               np.asarray(jst._normalize_depth(
                                   jnp.asarray(d))), atol=1e-6)
    np.testing.assert_array_equal(
        tst._quantize_like(_t(d), 255.0).numpy(),
        np.asarray(jst._quantize_like(jnp.asarray(d), 255.0)))


def test_super_sampling_on_a_device_raises():
    """Off the CPU the super-sampled path launches its kernels or raises: a
    tensor that is neither on the CPU nor on a card is refused by the
    upsample wrapper, not computed plainly."""
    from vsc_tpu_torch.ops import _cuda
    rgb = torch.zeros((1, 8, 16, 3), dtype=torch.uint8, device="meta")
    depth = torch.zeros((1, 8, 16), dtype=torch.uint8, device="meta")
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="upsample: expected CUDA tensors"):
        tst.generate_sbs(rgb, depth, StereoParams(super_sampling=3.0))
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("hw,params", [
    ((1080, 1920), StereoParams()),
    ((72, 128), StereoParams(max_disparity=50 * 128 / 1920,
                             convergence=-10 * 128 / 1920)),
    ((24, 48), StereoParams(max_disparity=6.0, convergence=-2.0,
                            super_sampling=2.0)),
    ((5, 200), StereoParams(super_sampling=3.0, artifact_smoothing=3.0)),
    ((40, 64), StereoParams(super_sampling=2.5)),
])
def test_planar_u8_gate_matches_jax(hw, params):
    s = tst.sbs_shapes(*hw, params)
    assert (tst._planar_u8_geometry_ok(s, params)
            == jst._planar_u8_geometry_ok(s, params))


def test_super_sampling_runs_plain_on_cpu():
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (1, 12, 24, 3)).astype(np.uint8)
    depth = rng.integers(0, 256, (1, 12, 24)).astype(np.uint8)
    out = tst.generate_sbs(_t(rgb), _t(depth),
                           StereoParams(max_disparity=2.0, convergence=0.0,
                                        super_sampling=2.0, edge_softness=1.0))
    assert out.shape == (1, 12, 48, 3) and out.dtype == torch.uint8
