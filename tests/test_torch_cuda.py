"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, at small and ragged shapes. Needs an NVIDIA card (skips without one)
and neither jax nor the repository's conftest, so on the card's machine:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vsc_tpu.config import StereoParams
from vsc_tpu_torch.ops import _cuda
from vsc_tpu_torch.ops.attention_cuda import qkv_attention, qkv_attention_plain
from vsc_tpu_torch.ops.blur_cuda import (gaussian_blur_planes,
                                         gaussian_blur_planes_plain)
from vsc_tpu_torch.ops.inpaint import _pyramid_fill
from vsc_tpu_torch.ops.postprocess_cuda import (postprocess_eye,
                                                postprocess_eye_plain)
from vsc_tpu_torch.ops.stereo import generate_sbs
from vsc_tpu_torch.ops.warp_cuda import (forward_warp_eyes,
                                         forward_warp_eyes_plain)

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


def test_sbs_on_card_matches_cpu_plain(dev):
    g = torch.Generator().manual_seed(6)
    rgb = (torch.rand((2, 72, 128, 3), generator=g) * 255).to(torch.uint8)
    depth = (torch.rand((2, 72, 128), generator=g) * 255).to(torch.uint8)
    params = StereoParams(max_disparity=4.0, convergence=-1.0,
                          super_sampling=1.0)
    ref = generate_sbs(rgb, depth, params).int()
    got = generate_sbs(rgb.to(dev), depth.to(dev), params).cpu().int()
    diff = (got - ref).abs().float()
    assert float(diff.mean()) < 0.05 and int(diff.max()) <= 16
    with pytest.raises(NotImplementedError):
        generate_sbs(rgb.to(dev), depth.to(dev),
                     StereoParams(super_sampling=2.0))
