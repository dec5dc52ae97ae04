"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, at small and ragged shapes. Needs an NVIDIA card (skips without one)
and neither jax nor the repository's conftest, so on the card's machine:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vsc_tpu_torch.config import StereoParams
from vsc_tpu_torch.ops import _cuda
from vsc_tpu_torch.ops.attention_cuda import qkv_attention, qkv_attention_plain
from vsc_tpu_torch.ops.blur_cuda import (gaussian_blur_planes,
                                         gaussian_blur_planes_plain)
from vsc_tpu_torch.ops.finish_cuda import (sharpen_downscale,
                                           sharpen_downscale_planar,
                                           sharpen_downscale_plain)
from vsc_tpu_torch.ops.inpaint import _pyramid_fill
from vsc_tpu_torch.ops.pool_cuda import (avgpool2, avgpool2_eye4,
                                         avgpool2_plain, avgpool4_eye4,
                                         avgpool_eye4_plain)
from vsc_tpu_torch.ops.postprocess_cuda import (postprocess_eye,
                                                postprocess_eye_plain)
from vsc_tpu_torch.ops.pyramid_cuda import (pyramid_fill_below,
                                            pyramid_fill_below_plain)
from vsc_tpu_torch.ops.stereo import generate_sbs
from vsc_tpu_torch.ops.upsample_cuda import (upsample_bilinear_int,
                                             upsample_bilinear_int_plain)
from vsc_tpu_torch.ops.warp_cuda import (forward_warp_eyes,
                                         forward_warp_eyes_plain,
                                         forward_warp_eyes_planar,
                                         forward_warp_eyes_planar_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed, dev):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev)


@pytest.mark.parametrize("shape,k,sigma,gamma", [
    ((2, 50, 130), 31, 20.0, 0.2),
    ((3, 9, 40), 31, 20.0, None),     # reflects more than once
    ((6, 37, 70), 5, 1.0, None),      # unsharp's blur
])
def test_blur_kernel_matches_plain(dev, shape, k, sigma, gamma):
    x = _rand(shape, 0, dev)
    before = _cuda.LAUNCHES["blur"]
    got = gaussian_blur_planes(x, k, sigma, gamma)
    assert _cuda.LAUNCHES["blur"] == before + 1
    torch.testing.assert_close(got, gaussian_blur_planes_plain(
        x, k, sigma, gamma), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,max_disp,flat", [
    ((2, 20, 90), 7.3, False),
    ((1, 13, 64), 5.0, False),
    ((2, 16, 80), 6.0, True),          # flat depth: every shift ties
])
def test_warp_kernel_is_exact(dev, shape, max_disp, flat):
    img = torch.floor(_rand(shape + (3,), 1, dev) * 256)
    depth = torch.full(shape, 0.5, device=dev) if flat else _rand(shape, 2,
                                                                  dev)
    for a, b in zip(forward_warp_eyes(img, depth, max_disp),
                    forward_warp_eyes_plain(img, depth, max_disp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("b,h,w,smoothing,holes", [
    (1, 48, 640, 0.0, 0.06),
    (1, 48, 640, 1.0, 0.06),
    (2, 37, 300, 1.0, 0.06),
    (1, 40, 96, 2.5, 0.35),            # wide bilateral, large holes
])
def test_postprocess_kernel_matches_plain(dev, b, h, w, smoothing, holes):
    img = torch.floor(_rand((b, h, w, 3), 3, dev) * 256)
    valid = (_rand((b, h, w), 4, dev) > holes).float()
    img = img * valid[..., None]
    eye4 = torch.cat([img.permute(3, 0, 1, 2), valid[None]]).to(torch.uint8)
    smooth_q = _pyramid_fill(img, valid[..., None], coarse_factor=4,
                             return_coarse=True).permute(3, 0, 1, 2)
    smooth_q = smooth_q.contiguous()
    got = postprocess_eye(eye4, smooth_q, smoothing).int()
    want = postprocess_eye_plain(eye4, smooth_q, smoothing).int()
    diff = (got - want).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) < 1e-3


@pytest.mark.parametrize("N,T,H", [(3, 77, 2), (2, 577, 16), (1, 1, 1)])
def test_attention_kernel_matches_plain(dev, N, T, H):
    g = torch.Generator(dev).manual_seed(5)
    qkv = torch.randn((N, T, 3 * H * 64), generator=g, device=dev).to(
        torch.bfloat16)
    scale = 0.125
    got = qkv_attention(qkv, H, scale).float()
    want = qkv_attention_plain(qkv, H, scale).float()
    # bf16 output (~0.07 in size here) and p rounded to bf16, which can flip
    # with the f32 summation order; read on an H100 at [72, 577, 3072]:
    # max 1.95e-3, mean 1.8e-7. Builds of the kernel that drop the last key
    # or leave the padded keys unmasked read, on the shapes below, max
    # 2.7e-2 to 3.3 and mean 1.4e-3 to 0.89 (NaN where T = 1): both bounds
    # reject them.
    diff = (got - want).abs()
    assert float(diff.max()) <= 8e-3
    assert float(diff.mean()) <= 1e-5


@pytest.mark.parametrize("f,shape", [(2, (3, 13, 37)), (3, (2, 20, 301)),
                                     (4, (1, 7, 150)), (3, (1, 1, 5))])
@pytest.mark.parametrize("quantize_u8", [False, True])
def test_upsample_kernel_is_exact(dev, f, shape, quantize_u8):
    x = _rand(shape, 7, dev)
    x = torch.floor(x * 256) if quantize_u8 else x
    before = _cuda.LAUNCHES["upsample"]
    got = upsample_bilinear_int(x, f, quantize_u8)
    assert _cuda.LAUNCHES["upsample"] == before + 1
    assert torch.equal(got, upsample_bilinear_int_plain(x, f, quantize_u8))


def _eye4(b, h, w, seed, dev):
    rgb = torch.floor(_rand((3, b, h, w), seed, dev) * 256)
    valid = (_rand((b, h, w), seed + 1, dev) > 0.3).float()
    return torch.cat([rgb * valid, valid[None]]).to(torch.uint8)


@pytest.mark.parametrize("f,shape", [(2, (2, 34, 50)), (2, (1, 6, 2)),
                                     (4, (2, 36, 52)), (4, (1, 4, 8))])
def test_eye4_pool_kernel_is_exact(dev, f, shape):
    eye4 = _eye4(*shape, 8, dev)
    got = (avgpool2_eye4 if f == 2 else avgpool4_eye4)(eye4)
    assert torch.equal(got, avgpool_eye4_plain(eye4, f))


@pytest.mark.parametrize("shape", [(4, 18, 26), (16, 2, 6), (3, 40, 302)])
def test_avgpool2_kernel_is_exact(dev, shape):
    x = _rand(shape, 9, dev) * 255
    assert torch.equal(avgpool2(x), avgpool2_plain(x))


@pytest.mark.parametrize("b,h,w", [(2, 13, 27), (1, 1, 9), (2, 7, 1),
                                   (1, 1, 1), (4, 203, 381)])
def test_pyramid_kernel_is_exact(dev, b, h, w):
    valid = _rand((b, h, w), 10, dev)
    valid = torch.where(valid < 0.4, torch.zeros_like(valid), valid)
    valid[:, : h // 2, : w // 3] = 0.0
    img = _rand((3, b, h, w), 11, dev) * 255 * valid
    q = torch.cat([img, valid[None]]).contiguous()
    assert torch.equal(pyramid_fill_below(q), pyramid_fill_below_plain(q))


@pytest.mark.parametrize("ratio,h,w,offsets", [
    (3, 30, 420, (30, 6)), (2, 22, 300, (0, 0)), (4, 12, 540, (4, 17)),
    (3, 9, 129, (0, 0))])
def test_finish_kernel_is_exact(dev, ratio, h, w, offsets):
    crop_w = w - max(offsets)
    x = torch.floor(_rand((3, 4, h, w), 12, dev) * 256).to(torch.uint8)
    oh, ow = h // ratio, crop_w // ratio
    got = sharpen_downscale_planar(x, ratio, 14.0, oh, ow, crop_w, offsets)
    want = sharpen_downscale_plain(x, ratio, 14.0, oh, ow, crop_w, offsets)
    assert torch.equal(got, want)
    img = torch.movedim(x[..., :crop_w], 0, -1).float()
    got32 = sharpen_downscale(img, ratio, 14.0, oh, ow)
    want32 = sharpen_downscale(img.cpu(), ratio, 14.0, oh, ow)
    assert torch.equal(got32.cpu(), want32)


@pytest.mark.parametrize("shape,max_disp", [((2, 20, 90), 7.3),
                                            ((1, 13, 64), 5.0)])
def test_planar_warp_kernel_is_exact(dev, shape, max_disp):
    B, H, W = shape
    img = torch.floor(_rand((B, 3, H, W), 13, dev) * 256).to(torch.uint8)
    depth = _rand(shape, 14, dev)
    for a, b in zip(forward_warp_eyes_planar(img, depth, max_disp),
                    forward_warp_eyes_planar_plain(img, depth, max_disp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("super_sampling", [1.0, 2.0, 3.0])
def test_sbs_on_card_matches_cpu_plain(dev, super_sampling):
    g = torch.Generator().manual_seed(6)
    rgb = (torch.rand((2, 72, 128, 3), generator=g) * 255).to(torch.uint8)
    depth = (torch.rand((2, 72, 128), generator=g) * 255).to(torch.uint8)
    params = StereoParams(max_disparity=4.0, convergence=-1.0,
                          super_sampling=super_sampling)
    ref = generate_sbs(rgb, depth, params).int()
    got = generate_sbs(rgb.to(dev), depth.to(dev), params).cpu().int()
    diff = (got - ref).abs().float()
    assert float(diff.mean()) < 0.05 and int(diff.max()) <= 16


@pytest.mark.parametrize("b,h,w,smoothing,pool", [
    (2, 40, 260, 1.0, True), (1, 48, 250, 1.0, True),   # W/2 odd
    (2, 36, 134, 2.5, True), (1, 12, 6, 3.9, False),    # radius 7, tiny
])
def test_bilateral_kernel_matches_plain(dev, b, h, w, smoothing, pool):
    from vsc_tpu_torch.ops.bilateral_cuda import (bilateral_pool_planar,
                                                  bilateral_pool_plain)
    eye4 = _eye4(b, h, w, 15, dev)
    before = _cuda.LAUNCHES["bilateral"]
    filt, q = bilateral_pool_planar(eye4, smoothing, pool)
    assert _cuda.LAUNCHES["bilateral"] == before + 1
    filt_p, q_p = bilateral_pool_plain(eye4, smoothing, pool)
    diff = (filt[:3].int() - filt_p[:3].int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) < 1e-3
    assert torch.equal(filt[3], eye4[3])
    assert (q is None) == (not pool)
    if pool:
        assert torch.equal(q, q_p)


@pytest.mark.parametrize("smoothing", [1.0, 2.5])
def test_split_postprocess_equals_fused_on_card(dev, smoothing):
    from vsc_tpu_torch.ops.bilateral_cuda import bilateral_pool_planar
    from vsc_tpu_torch.ops.inpaint import _pyramid_fill_planar_coarse
    eye4 = _eye4(2, 40, 260, 16, dev)
    eye4[3, :, :, :3] = 0        # holes along the left and right borders
    eye4[3, :, :, -3:] = 0
    eye4[:3] *= eye4[3][None]
    smooth_q = _pyramid_fill_planar_coarse(eye4)
    filt, quarter = bilateral_pool_planar(eye4, smoothing)
    assert torch.equal(_pyramid_fill_planar_coarse(None, quarter4=quarter),
                       smooth_q)
    assert torch.equal(postprocess_eye(filt, smooth_q, 0.0),
                       postprocess_eye(eye4, smooth_q, smoothing))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,o,bias", [
    (2, 128, 8, 16, 128, False), (1, 256, 16, 8, 128, True),   # C != O
    (1, 128, 24, 24, 256, False), (3, 32, 5, 4, 64, True),     # ragged P
])
def test_deconv_kernel_matches_plain(dev, dtype, n, c, h, w, o, bias):
    from vsc_tpu_torch.ops.deconv_cuda import deconv2x2, deconv2x2_plain
    g = torch.Generator(dev).manual_seed(17)
    x = torch.randn((n, c, h, w), generator=g, device=dev).to(dtype)
    wt = (0.1 * torch.randn((c, o, 2, 2), generator=g, device=dev)).to(dtype)
    b = (0.1 * torch.randn((o,), generator=g, device=dev)).to(
        dtype) if bias else None
    before = _cuda.LAUNCHES["deconv"]
    got = deconv2x2(x, wt, b)
    assert _cuda.LAUNCHES["deconv"] == before + 1
    want = deconv2x2_plain(x, wt, b)
    # f32: sums of <= 256 products in another order; bf16: the same sum
    # rounded once to bf16 (8 bits): one step of the output's bf16 grid
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(
        rtol=8e-3, atol=1e-3)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,Dh", [(2, 37, 4, 16), (1, 77, 2, 80),
                                      (1, 129, 2, 128), (3, 64, 3, 32),
                                      (1, 1, 1, 48)])
def test_split_attention_kernel_matches_plain(dev, dtype, B, T, H, Dh):
    from vsc_tpu_torch.ops.attention_cuda import (short_seq_attention,
                                                  short_seq_attention_plain)
    g = torch.Generator(dev).manual_seed(18)
    qkv = torch.randn((B, T, 3 * H * Dh), generator=g, device=dev).to(dtype)
    q, k, v = qkv.view(B, T, 3, H, Dh).unbind(2)
    scale = Dh ** -0.5
    before = _cuda.LAUNCHES["attention_split"]
    got = short_seq_attention(q, k, v, scale).float()
    assert _cuda.LAUNCHES["attention_split"] == before + 1
    want = short_seq_attention_plain(q, k, v, scale).float()
    diff = (got - want).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 2e-5
    else:    # the qkv kernel's bounds (test_attention_kernel_matches_plain)
        assert float(diff.max()) <= 8e-3
        assert float(diff.mean()) <= 1e-5
