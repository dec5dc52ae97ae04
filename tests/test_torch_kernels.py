"""Each CUDA kernel's plain PyTorch version (what the port runs on CPU
tensors) against the JAX Pallas kernel it replaces, run in interpret mode
on the CPU as the JAX package's own tests run it. The kernels themselves
are compared with these plain versions on the card by chip_smoke.py and by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsc_tpu_torch.ops import _cuda
from vsc_tpu_torch.ops.attention_cuda import (qkv_attention,
                                              short_seq_attention)
from vsc_tpu_torch.ops.deconv_cuda import deconv2x2
from vsc_tpu_torch.ops.blur_cuda import gaussian_blur_planes
from vsc_tpu_torch.ops.finish_cuda import (sharpen_downscale,
                                           sharpen_downscale_planar)
from vsc_tpu_torch.ops.pool_cuda import avgpool2, avgpool2_eye4, avgpool4_eye4
from vsc_tpu_torch.ops.postprocess_cuda import postprocess_eye
from vsc_tpu_torch.ops.pyramid_cuda import pyramid_fill_below
from vsc_tpu_torch.ops.upsample_cuda import upsample_bilinear_int
from vsc_tpu_torch.ops.warp_cuda import forward_warp_eyes, forward_warp_eyes_planar


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("ksize,sigma,gamma", [(31, 20.0, 0.2), (5, 1.0, None)])
def test_blur_plain_matches_pallas(ksize, sigma, gamma):
    from vsc_tpu.ops.blur_pallas import gaussian_blur_pallas
    x = np.random.default_rng(0).random((3, 40, 150)).astype(np.float32)
    got = gaussian_blur_planes(_t(x), ksize, sigma, gamma=gamma).numpy()
    want = np.asarray(gaussian_blur_pallas(jnp.asarray(x), ksize, sigma,
                                           gamma=gamma))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("max_disp", [4.0, 9.7])
def test_warp_plain_matches_pallas(max_disp):
    from vsc_tpu.ops.warp_pallas import forward_warp_stereo_pallas
    rng = np.random.default_rng(1)
    img = np.floor(rng.random((2, 24, 96, 3)) * 256).astype(np.float32)
    depth = rng.random((2, 24, 96)).astype(np.float32)
    depth = (depth + np.roll(depth, 1, 1) + np.roll(depth, 1, 2)) / 3.0
    eye_l, eye_r = forward_warp_eyes(_t(img), _t(depth), max_disp)
    l, lm, r, rm = (np.asarray(a) for a in forward_warp_stereo_pallas(
        jnp.asarray(img), jnp.asarray(depth), max_disp))
    for eye, (c, m) in zip((eye_l, eye_r), ((l, lm), (r, rm))):
        want = np.concatenate([np.moveaxis(c, -1, 0), m[None]]).astype(
            np.uint8)
        np.testing.assert_array_equal(eye.numpy(), want)


def _pp_inputs(b, h, w, seed, hole_frac=0.06):
    rng = np.random.default_rng(seed)
    img = (rng.random((b, h, w, 3)) * 255).astype(np.float32)
    valid = (rng.random((b, h, w)) > hole_frac).astype(np.float32)
    return img * valid[..., None], valid


@pytest.mark.parametrize("b,h,w,seed,smoothing", [
    (1, 48, 640, 0, 0.0),
    (1, 48, 640, 0, 1.0),
    (2, 37, 300, 3, 0.0),     # ragged: not a multiple of the block
    (2, 37, 300, 3, 1.0),
])
def test_postprocess_plain_matches_pallas(b, h, w, seed, smoothing):
    from vsc_tpu.ops.inpaint import _pyramid_fill
    from vsc_tpu.ops.postprocess_pallas import postprocess_eye_pallas
    img, valid = _pp_inputs(b, h, w, seed)
    u8 = np.floor(np.clip(img, 0, 255))
    smooth_q = np.asarray(_pyramid_fill(jnp.asarray(u8),
                                        jnp.asarray(valid)[..., None],
                                        coarse_factor=4, return_coarse=True))
    want = np.asarray(postprocess_eye_pallas(
        jnp.asarray(img), jnp.asarray(valid), jnp.asarray(smooth_q),
        smoothing))
    eye4 = np.concatenate([np.moveaxis(u8, -1, 0), valid[None]]).astype(
        np.uint8)
    got = postprocess_eye(_t(eye4), _t(np.moveaxis(smooth_q, -1, 0)),
                          smoothing).numpy()
    diff = np.abs(np.moveaxis(got, 0, -1).astype(np.float32) - want)
    # test_postprocess_pallas.py's bound: <= 1 code, on < 0.1% of the
    # interior; the port follows the kernel's border rule too, so the
    # whole frame is held to the same bound
    assert diff.max() <= 1.0, diff.max()
    assert (diff > 0).mean() < 0.001, (diff > 0).mean()


@pytest.mark.parametrize("B,T,H,Dh", [(2, 37, 4, 64), (1, 577, 16, 64)])
def test_attention_plain_matches_pallas(B, T, H, Dh):
    from vsc_tpu.ops.attention_pallas import qkv_short_seq_attention
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(0, 1, (B, T, H, Dh)).astype(np.float32)
               for _ in range(3))
    scale = 1.0 / np.sqrt(Dh)
    D = H * Dh
    # JAX: per-head interleaved [q_h | k_h | v_h]; port: plain [q | k | v]
    inter = np.stack([q, k, v], axis=3).reshape(B, T, 3 * D)
    plain = np.concatenate([x.reshape(B, T, D) for x in (q, k, v)], -1)
    want = np.asarray(qkv_short_seq_attention(jnp.asarray(inter), H, scale))
    got = qkv_attention(_t(plain), H, scale).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("call", [
    lambda m: gaussian_blur_planes(torch.zeros((1, 8, 8), device=m), 5, 1.0),
    lambda m: forward_warp_eyes(torch.zeros((1, 4, 8, 3), device=m),
                                torch.zeros((1, 4, 8), device=m), 2.0),
    lambda m: postprocess_eye(torch.zeros((4, 1, 8, 8), dtype=torch.uint8,
                                          device=m),
                              torch.zeros((3, 1, 2, 2), device=m), 1.0),
    lambda m: qkv_attention(torch.zeros((1, 5, 192), dtype=torch.bfloat16,
                                        device=m), 1, 0.125),
    lambda m: upsample_bilinear_int(torch.zeros((2, 4, 6), device=m), 3),
    lambda m: upsample_bilinear_int(torch.zeros((2, 4, 6), device=m), 2,
                                    quantize_u8=True),
    lambda m: avgpool2_eye4(torch.zeros((4, 1, 8, 8), dtype=torch.uint8,
                                        device=m)),
    lambda m: avgpool4_eye4(torch.zeros((4, 1, 8, 8), dtype=torch.uint8,
                                        device=m)),
    lambda m: avgpool2(torch.zeros((4, 8, 8), device=m)),
    lambda m: pyramid_fill_below(torch.zeros((4, 2, 5, 7), device=m)),
    lambda m: sharpen_downscale_planar(
        torch.zeros((3, 2, 9, 390), dtype=torch.uint8, device=m), 3, 14.0, 3,
        128, 384, (0, 6)),
    lambda m: sharpen_downscale(torch.zeros((1, 9, 390, 3), device=m), 3,
                                14.0, 3, 130),
    lambda m: forward_warp_eyes_planar(
        torch.zeros((1, 3, 4, 8), dtype=torch.uint8, device=m),
        torch.zeros((1, 4, 8), device=m), 2.0),
    lambda m: short_seq_attention(*torch.zeros(
        (1, 5, 3, 2, 16), device=m).unbind(2), 0.25),
    lambda m: deconv2x2(torch.zeros((1, 8, 8, 128), device=m).permute(
        0, 3, 1, 2), torch.zeros((128, 128, 2, 2), device=m)),
    lambda m: deconv2x2(torch.zeros((1, 128, 8, 8), device=m),
                        torch.zeros((128, 128, 2, 2), device=m),
                        torch.zeros((128,), device=m)),
])
def test_wrappers_never_fall_back_off_cpu(call):
    """Off the CPU a wrapper launches its kernel or raises: a tensor that is
    neither on the CPU nor on a card is refused, not computed plainly."""
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        call("meta")
    assert _cuda.LAUNCHES == before
