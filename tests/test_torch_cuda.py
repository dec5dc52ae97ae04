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
from vsc_tpu_torch.ops.postprocess_cuda import (TILE_H, TILE_W,
                                                bilateral_plain, hole_tiles,
                                                postprocess_eye,
                                                postprocess_eye_plain)
from vsc_tpu_torch.ops.pyramid_cuda import (pyramid_fill_below,
                                            pyramid_fill_below_plain)
from vsc_tpu_torch.ops.stereo import generate_sbs
from vsc_tpu_torch.ops.upsample_cuda import (upsample_bilinear_int,
                                             upsample_bilinear_int_plain)
from vsc_tpu_torch.ops.warp_cuda import (forward_warp_eyes,
                                         forward_warp_eyes_plain,
                                         forward_warp_eyes_planar,
                                         forward_warp_eyes_planar_plain,
                                         forward_warp_pair_planar)

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


@pytest.mark.parametrize("k", range(5, 32, 2))
def test_blur_kernel_every_tap_count(dev, k):
    # every instance of the kernel (one a tap count), on a plane of interior
    # and border tiles in both directions (tiles of 32 x 224): the same
    # products and sums in the same order, so the same bits; with the gamma
    # (powf against torch's pow) within the kernel's bound
    x = _rand((2, 101, 700), 40 + k, dev)
    got = gaussian_blur_planes(x, k, k / 6.0)
    assert torch.equal(got, gaussian_blur_planes_plain(x, k, k / 6.0))
    torch.testing.assert_close(
        gaussian_blur_planes(x, k, k / 6.0, 0.2),
        gaussian_blur_planes_plain(x, k, k / 6.0, 0.2), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,max_disp,flat", [
    ((2, 20, 90), 7.3, False),
    ((1, 13, 64), 5.0, False),
    ((2, 16, 80), 6.0, True),          # flat depth: every shift ties
    ((2, 6, 6090), 50.0, True),        # two row segments, ties across them
    ((1, 5, 11847), 50.0, True),       # the 4K pair's width: three segments
    ((1, 7, 9000), 33.5, False),
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


def _pp_case(eye4, smoothing, dev):
    """The kernel against the plain version on eye4 [4, B, H, W] u8 (colors
    zeroed where not valid, as the warp leaves them), one launch counted."""
    eye4 = eye4.to(dev)
    eye4[:3] *= (eye4[3] > 0)[None]
    img = torch.movedim(eye4[:3], 0, -1).float()
    valid = eye4[3].float()
    smooth_q = _pyramid_fill(img, valid[..., None], coarse_factor=4,
                             return_coarse=True).permute(3, 0, 1, 2)
    smooth_q = smooth_q.contiguous()
    before = _cuda.LAUNCHES["postprocess"]
    got = postprocess_eye(eye4, smooth_q, smoothing)
    assert _cuda.LAUNCHES["postprocess"] == before + 1
    want = postprocess_eye_plain(eye4, smooth_q, smoothing)
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) < 1e-3
    return eye4, got


def _pp_frame(b, h, w, seed, dev):
    rgb = torch.floor(_rand((3, b, h, w), seed, dev) * 256)
    return torch.cat([rgb, torch.ones((1, b, h, w), device=dev)]).to(
        torch.uint8)


@pytest.mark.parametrize("smoothing", [0.0, 1.0, 4.0])
def test_postprocess_kernel_without_holes_is_the_bilateral(dev, smoothing):
    eye4 = _pp_frame(2, 2 * TILE_H + 5, 3 * TILE_W - 7, 20, dev)
    assert not bool(hole_tiles(eye4[3]).any())      # every tile: fast path
    eye4, got = _pp_case(eye4, smoothing, dev)
    want = eye4[:3].float()
    if smoothing > 0:
        want = bilateral_plain(want, smoothing)
    assert torch.equal(got, want.to(torch.uint8))


@pytest.mark.parametrize("smoothing", [0.0, 1.0, 4.0])
@pytest.mark.parametrize("layout", ["clustered", "tile_edges", "all_holes"])
def test_postprocess_kernel_hole_layouts(dev, smoothing, layout):
    B, H, W = 2, 3 * TILE_H + 11, 4 * TILE_W + 3   # not multiples of a tile
    eye4 = _pp_frame(B, H, W, 21, dev)
    valid = eye4[3]
    if layout == "clustered":
        # two blobs of holes, a near-vertical streak; most tiles stay clean
        spots = _rand((B, H, W), 22, dev) > 0.6
        valid[:, 10:40, 20:31] = 0
        valid[:, TILE_H + 3:2 * TILE_H, 2 * TILE_W + 1:2 * TILE_W + 3] = 0
        valid[:, 60:90, 70:76] *= spots[:, 60:90, 70:76] == 0
    elif layout == "tile_edges":
        # on the image's first and last rows and columns and on both sides
        # of tile borders
        valid[:, 0, ::3] = 0
        valid[:, H - 1, 1::4] = 0
        valid[:, ::5, 0] = 0
        valid[:, 2::3, W - 1] = 0
        valid[:, TILE_H - 1:TILE_H + 1, 5:9] = 0
        valid[:, 2 * TILE_H, 40:44] = 0
        valid[:, 30:36, TILE_W - 1] = 0
        valid[:, 70:75, 2 * TILE_W] = 0
    else:
        valid.zero_()
    tiles = hole_tiles(valid)
    if layout == "all_holes":
        assert bool(tiles.all())
    else:
        assert bool(tiles.any()) and not bool(tiles.all())
    _pp_case(eye4, smoothing, dev)


def test_postprocess_kernel_writes_every_pixel_of_every_launch(dev):
    """The output comes from torch.empty, so a pixel a launch fails to
    write keeps what the card's memory held. With the free blocks of the
    output's size filled with another byte before each of 1000 launches on
    a pair whose every tile takes the hole path, each launch equals the
    first, which equals the plain version. (The hole-pixel list's counter
    was once reset with no barrier before other warps added to it, so a
    late reset could drop a hole pixel from the polish: its output was
    never written, a few launches in a few hundred.)"""
    eye4 = _pp_frame(4, 1080, 2048, 25, dev)
    eye4[3] = (_rand((4, 1080, 2048), 26, dev) > 0.3).to(torch.uint8)
    assert bool(hole_tiles(eye4[3]).all())
    eye4, want = _pp_case(eye4, 1.0, dev)
    smooth_q = _pyramid_fill(torch.movedim(eye4[:3], 0, -1).float(),
                             eye4[3].float()[..., None], coarse_factor=4,
                             return_coarse=True).permute(3, 0, 1, 2)
    smooth_q = smooth_q.contiguous()
    bad = 0
    for i in range(1000):
        junk = [torch.full_like(want, 1 + i % 254) for _ in range(4)]
        del junk
        got = postprocess_eye(eye4, smooth_q, 1.0)
        bad += not torch.equal(got, want)
        del got
    assert bad == 0, f"{bad} of 1000 launches left pixels unwritten"


@pytest.mark.parametrize("b,h,w,smoothing", [
    (1, 7, 5, 1.0), (1, 1, 40, 4.0), (2, 50, 1, 0.0),   # smaller than a tile
    (1, TILE_H + 1, TILE_W + 1, 4.0),                   # one-pixel tiles
])
def test_postprocess_kernel_ragged_tiles(dev, b, h, w, smoothing):
    eye4 = _pp_frame(b, h, w, 23, dev)
    eye4[3] = (_rand((b, h, w), 24, dev) > 0.2).to(torch.uint8)
    _pp_case(eye4, smoothing, dev)


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


def _attention_check(qkv, H, scale):
    before = _cuda.LAUNCHES["attention"]
    got = qkv_attention(qkv, H, scale).float()
    assert _cuda.LAUNCHES["attention"] == before + 1
    want = qkv_attention_plain(qkv, H, scale).float()
    # the bounds of test_attention_kernel_matches_plain
    diff = (got - want).abs()
    assert float(diff.max()) <= 8e-3
    assert float(diff.mean()) <= 1e-5
    return got


@pytest.mark.parametrize("T", [1, 63, 64, 65, 129, 577])
@pytest.mark.parametrize("N,H", [(72, 16), (3, 1), (5, 7)])
def test_attention_kernel_token_counts(dev, T, N, H):
    g = torch.Generator(dev).manual_seed(30 + T)
    qkv = torch.randn((N, T, 3 * H * 64), generator=g, device=dev).to(
        torch.bfloat16)
    _attention_check(qkv, H, 0.125)


@pytest.mark.parametrize("T", [65, 577])
def test_attention_kernel_large_logits(dev, T):
    # logits ~30x larger (std ~30): a max taken over part of a row makes
    # exp() overflow to inf and the output NaN. Near-ties put p near 1,
    # where one step of bf16's grid is 2^-8: p at another f32 exponent
    # (the products sum in another order) can round to the next step and
    # move an output by up to 2^-8 x |v|; and the outputs, v-sized here
    # (up to ~4), can round one step of their own grid (8e-3 of the value)
    # the other way.
    g = torch.Generator(dev).manual_seed(31)
    qkv = torch.randn((4, T, 3 * 2 * 64), generator=g, device=dev)
    qkv[..., :2 * 2 * 64] *= 30 ** 0.5
    qkv = qkv.to(torch.bfloat16)
    before = _cuda.LAUNCHES["attention"]
    got = qkv_attention(qkv, 2, 0.125).float()
    assert _cuda.LAUNCHES["attention"] == before + 1
    want = qkv_attention_plain(qkv, 2, 0.125).float()
    assert bool(torch.isfinite(got).all())
    vmax = float(qkv[..., 2 * 2 * 64:].float().abs().max())
    torch.testing.assert_close(got, want, rtol=8e-3, atol=2 ** -8 * vmax)
    assert float((got - want).abs().mean()) <= 1e-3


@pytest.mark.parametrize("T", [64, 161, 577])
def test_attention_kernel_dominant_key(dev, T):
    # one key per sample takes (nearly) all the mass: the output is its v
    N, H = 3, 2
    g = torch.Generator(dev).manual_seed(32)
    qkv = 0.1 * torch.randn((N, T, 3 * H * 64), generator=g, device=dev)
    D = H * 64
    qkv[..., :D] = 1.0
    keys = [T - 1, 0, T // 2]                        # the last key, the first
    for n, j in enumerate(keys):
        qkv[n, j, D:2 * D] = 2.0
    qkv = qkv.to(torch.bfloat16)
    got = _attention_check(qkv, H, 0.125)
    for n, j in enumerate(keys):
        torch.testing.assert_close(got[n], qkv[n, j, 2 * D:].float()[
            None].expand(T, D), atol=1e-2, rtol=0)


@pytest.mark.parametrize("f,shape", [
    (2, (3, 13, 37)), (3, (2, 20, 301)), (4, (1, 7, 150)), (3, (1, 1, 5)),
    # every factor, at rows that end inside a warp's 128 columns and are not
    # multiples of 4 or 16 in or out, on strips of rows with a ragged end
    *[(f, (2, 9, 203)) for f in range(2, 9)],
    *[(f, (1, 5, 131)) for f in range(2, 9)],
    (3, (1, 4, 2030)), (3, (1, 3, 3949)),      # 1080p and 4K rows
    (3, (2, 20, 128)), (5, (1, 2, 1))])
@pytest.mark.parametrize("quantize_u8", [False, True])
def test_upsample_kernel_is_exact(dev, f, shape, quantize_u8):
    x = _rand(shape, 7, dev)
    x = torch.floor(x * 256) if quantize_u8 else x
    before = _cuda.LAUNCHES["upsample"]
    got = upsample_bilinear_int(x, f, quantize_u8)
    assert _cuda.LAUNCHES["upsample"] == before + 1
    assert torch.equal(got, upsample_bilinear_int_plain(x, f, quantize_u8))


def _saturating(kind, shape, dev):
    """All 0, all 255, or a 0/255 checkerboard over the last two axes."""
    if kind == "zeros":
        return torch.zeros(shape, device=dev)
    if kind == "full":
        return torch.full(shape, 255.0, device=dev)
    h, w = shape[-2:]
    board = (torch.arange(h, device=dev)[:, None]
             + torch.arange(w, device=dev)[None]) % 2
    return (255.0 * board).expand(shape).contiguous()


@pytest.mark.parametrize("kind", ["zeros", "full", "checker"])
@pytest.mark.parametrize("f", [2, 3, 8])
def test_upsample_kernel_saturating_inputs(dev, kind, f):
    x = _saturating(kind, (2, 11, 203), dev)
    for quantize_u8 in (False, True):
        before = _cuda.LAUNCHES["upsample"]
        got = upsample_bilinear_int(x, f, quantize_u8)
        assert _cuda.LAUNCHES["upsample"] == before + 1
        assert torch.equal(got, upsample_bilinear_int_plain(x, f,
                                                            quantize_u8))


@pytest.mark.parametrize("quantize_u8", [False, True])
def test_upsample_kernel_default_shapes(dev, quantize_u8):
    # the defaults' 1080p batch of 2: six RGB planes to u8, two depth planes
    # to f32, each [1080, 2030] -> [3240, 6090]
    shape = (6, 1080, 2030) if quantize_u8 else (2, 1080, 2030)
    x = _rand(shape, 17, dev)
    x = torch.floor(x * 256) if quantize_u8 else x
    before = _cuda.LAUNCHES["upsample"]
    got = upsample_bilinear_int(x, 3, quantize_u8)
    assert _cuda.LAUNCHES["upsample"] == before + 1
    assert torch.equal(got, upsample_bilinear_int_plain(x, 3, quantize_u8))


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


def _pyramid_check(q):
    """One counted launch, bit-identical to the plain ladder (the torch
    ladder with no handoff, _push_pull_hw(kmax=1))."""
    before = _cuda.LAUNCHES["pyramid"]
    got = pyramid_fill_below(q)
    assert _cuda.LAUNCHES["pyramid"] == before + 1
    assert torch.equal(got, pyramid_fill_below_plain(q))


def _pyramid_quarter(b, h, w, seed, dev, holes="mixed"):
    valid = _rand((b, h, w), seed, dev)
    valid = torch.where(valid < 0.4, torch.zeros_like(valid), valid)
    valid[:, : h // 2, : w // 3] = 0.0
    if holes == "all":
        valid.zero_()
    elif holes == "none":
        valid = 0.5 + 0.5 * _rand((b, h, w), seed + 2, dev)
    img = _rand((3, b, h, w), seed + 1, dev) * 255 * valid
    return torch.cat([img, valid[None]]).contiguous()


# small shapes; the quarter of the default path (1080p, super_sampling 3,
# batch 2) and of a 2160 x 3840 frame; odd at each of the first three
# levels (41 -> 21 -> 11, 169 -> 85 -> 43; 105 -> 53 -> 27, 329 -> 165 ->
# 83); a region's edge; the level two pools below the default quarter
@pytest.mark.parametrize("b,h,w", [(2, 13, 27), (1, 1, 9), (2, 7, 1),
                                   (1, 1, 1), (4, 203, 381),
                                   (4, 810, 1523), (2, 1620, 2962),
                                   (2, 41, 169), (1, 105, 329),
                                   (3, 64, 33), (1, 33, 64)])
def test_pyramid_kernel_is_exact(dev, b, h, w):
    _pyramid_check(_pyramid_quarter(b, h, w, 10, dev))


@pytest.mark.parametrize("holes", ["all", "none"])
@pytest.mark.parametrize("b,h,w", [(2, 13, 27), (1, 1, 1), (4, 810, 1523),
                                   (2, 41, 169)])
def test_pyramid_kernel_hole_free_and_all_hole(dev, b, h, w, holes):
    _pyramid_check(_pyramid_quarter(b, h, w, 12, dev, holes))


def test_pyramid_kernel_frames_differ(dev):
    """Each frame's ladder is its own: an all-hole frame beside a hole-free
    one and a mixed one."""
    q = torch.cat([_pyramid_quarter(1, 203, 381, 14, dev, holes)
                   for holes in ("all", "none", "mixed")], dim=1)
    _pyramid_check(q.contiguous())


def _finish_check(x, ratio, strength, oh, ow, crop_w, offsets):
    before = _cuda.LAUNCHES["finish"]
    got = sharpen_downscale_planar(x, ratio, strength, oh, ow, crop_w,
                                   offsets)
    assert _cuda.LAUNCHES["finish"] == before + 1
    want = sharpen_downscale_plain(x, ratio, strength, oh, ow, crop_w,
                                   offsets)
    assert torch.equal(got, want)


@pytest.mark.parametrize("ratio,h,w,offsets", [
    (3, 30, 420, (30, 6)), (2, 22, 300, (0, 0)), (4, 12, 540, (4, 17)),
    (3, 9, 129, (0, 0)),
    # every ratio, odd and unequal offsets, rows of odd widths
    *[(r, 4 * r + 3, 140 * r + 13, (7, 2)) for r in range(1, 9)],
    (2, 70, 301, (3, 9)), (3, 69, 6090, (165, 1)),
    # a tile whose rows all lie inside the plane (16 output rows a tile)
    (1, 140, 140, (3, 1)), (2, 200, 301, (3, 9)), (3, 300, 421, (30, 7)),
    (1, 5, 130, (1, 0))])                      # the smallest crop: 5 x 129
def test_finish_kernel_is_exact(dev, ratio, h, w, offsets):
    crop_w = w - max(offsets)
    x = torch.floor(_rand((3, 4, h, w), 12, dev) * 256).to(torch.uint8)
    oh, ow = h // ratio, crop_w // ratio
    _finish_check(x, ratio, 14.0, oh, ow, crop_w, offsets)
    img = torch.movedim(x[..., :crop_w], 0, -1).float()
    before = _cuda.LAUNCHES["finish"]
    got32 = sharpen_downscale(img, ratio, 14.0, oh, ow)
    assert _cuda.LAUNCHES["finish"] == before + 1
    want32 = sharpen_downscale(img.cpu(), ratio, 14.0, oh, ow)
    assert torch.equal(got32.cpu(), want32)


@pytest.mark.parametrize("ratio", [2, 3, 4])
def test_finish_kernel_ragged_tiles(dev, ratio):
    # a box grid that ends inside a tile in both axes (tiles of 16 rows and
    # 64 columns of outputs) and leaves crop rows and columns unused
    h, w, offsets = 35 * ratio + 2, 130 * ratio + 9, (5, 0)
    x = torch.floor(_rand((3, 2, h, w), 13, dev) * 256).to(torch.uint8)
    crop_w = w - 5
    _finish_check(x, ratio, 14.0, 33, 129, crop_w, offsets)


@pytest.mark.parametrize("kind", ["zeros", "full", "checker"])
@pytest.mark.parametrize("ratio", [1, 3, 5])
def test_finish_kernel_saturating_inputs(dev, kind, ratio):
    h, w, offsets = 11 * ratio + 1, 133 * ratio + 5, (5, 2)
    x = _saturating(kind, (3, 4, h, w), dev).to(torch.uint8)
    crop_w = w - 5
    _finish_check(x, ratio, 14.0, h // ratio, crop_w // ratio, crop_w,
                  offsets)


def test_finish_kernel_default_shapes(dev):
    # the defaults' 1080p pair: [3, 4, 3240, 6090], each eye at its offset
    p = StereoParams()
    from vsc_tpu_torch.ops.stereo import _crop_offsets
    lo, ro, crop_w = _crop_offsets(1080, 1920, p)
    x = torch.floor(_rand((3, 4, 3240, 6090), 14, dev) * 256).to(
        torch.uint8)
    _finish_check(x, 3, float(p.sharpen), 1080, 1920, crop_w, (lo, ro))


@pytest.mark.parametrize("shape,max_disp", [((2, 20, 90), 7.3),
                                            ((1, 13, 64), 5.0)])
def test_planar_warp_kernel_is_exact(dev, shape, max_disp):
    B, H, W = shape
    img = torch.floor(_rand((B, 3, H, W), 13, dev) * 256).to(torch.uint8)
    depth = _rand(shape, 14, dev)
    for a, b in zip(forward_warp_eyes_planar(img, depth, max_disp),
                    forward_warp_eyes_planar_plain(img, depth, max_disp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("max_disp", [0.2, 0.45])
def test_warp_kernel_minus_zero_ties_plus_zero(dev, max_disp):
    # tests/test_torch_warp_scatter.py::test_scatter_minus_zero_ties_plus_
    # zero on the card: keys +0.0 and -0.0 meet at one target in the right
    # eye, and the larger source must win
    depth = torch.zeros((1, 2, 16), device=dev)
    depth[:, :, 6] = -2.0
    depth[:, :, 7] = -0.0
    img = torch.floor(_rand((1, 2, 16, 3), 15, dev) * 256)
    got = forward_warp_eyes(img, depth, max_disp)
    want = forward_warp_eyes_plain(img, depth, max_disp)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[1][:3, 0, :, 7], img[0, :, 7].T.to(torch.uint8))


@pytest.mark.parametrize("case", ["smooth", "flat", "steps", "specials"])
@pytest.mark.parametrize("B,H,W,max_disp", [(1, 2160, 3840, 50.0),
                                            (2, 9, 6090, 50.0),
                                            (1, 4, 333, 12.0)])
def test_warp_pair_kernel_is_exact(dev, case, B, H, W, max_disp):
    """The in-place pair entry against the plain version's two eyes: flat
    depth (every source ties with its neighbours), depth in steps of a few
    codes (ties between classes and across shifts), and -0.0, NaN, inf and
    depth outside [0, 1]."""
    g = torch.Generator(dev).manual_seed(70)
    img = torch.randint(0, 256, (B, 3, H, W), generator=g, device=dev,
                        dtype=torch.uint8)
    if case == "smooth":
        xx = torch.linspace(0, 6.0, W, device=dev)
        depth = (0.5 + 0.4 * torch.sin(xx))[None, None].expand(B, H, W) \
            + 0.01 * torch.rand((B, H, W), generator=g, device=dev)
    elif case == "flat":
        depth = torch.full((B, H, W), 0.5, device=dev)
    elif case == "steps":
        depth = torch.floor(torch.rand((B, H, W), generator=g, device=dev)
                            * 4) / 4
    else:
        depth = torch.rand((B, H, W), generator=g, device=dev) * 1.6 - 0.3
        flat = depth.view(-1)
        flat[::7] = -0.0
        flat[3::11] = 0.0
        flat[5::13] = float("nan")
        flat[1::17] = float("inf")
        flat[2::19] = -float("inf")
    depth = depth.contiguous()
    before = _cuda.LAUNCHES["warp"]
    pair = forward_warp_pair_planar(img, depth, max_disp)
    assert _cuda.LAUNCHES["warp"] == before + 1
    assert tuple(pair.shape) == (4, 2 * B, H, W)
    if H * W > 1_000_000:          # the plain version a row band at a time
        for y in range(0, H, 270):
            sl = slice(y, y + 270)
            want = forward_warp_eyes_planar_plain(
                img[:, :, sl].contiguous(), depth[:, sl].contiguous(),
                max_disp)
            assert torch.equal(pair[:, :B, sl], want[0])
            assert torch.equal(pair[:, B:, sl], want[1])
    else:
        want = forward_warp_eyes_planar_plain(img, depth, max_disp)
        assert torch.equal(pair, torch.cat(want, dim=1))


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


def test_sbs_4k_batch_of_4_equals_its_frames_one_at_a_time(dev):
    """2160 x 3840 at StereoParams() and the CLIs' batch of 4: the [4, 8,
    6480, 11847] u8 pair holds 2,456,593,920 elements, so the right eyes'
    valid planes lie past element 2^31. Each frame of the batch must equal
    that frame converted alone; every SBS kernel of the 4K path launches
    once a call."""
    B, H, W = 4, 2160, 3840
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    base = 0.5 + 0.4 * torch.sin(xx / 97.0) * torch.cos(yy / 53.0)
    rgb = torch.stack([torch.stack([base, 1.0 - base, 0.3 + 0.5 * base], -1)
                       .roll(700 * i, dims=1) for i in range(B)])
    rgb = ((rgb + 0.05 * _rand((B, H, W, 3), 7, dev)).clamp(0, 1)
           * 255).to(torch.uint8)
    near = 0.5 + 0.45 * torch.sin(xx / 311.0 + yy / 173.0)
    depth = torch.stack([(near.roll(-900 * i, dims=1) * 255).to(torch.uint8)
                         for i in range(B)])
    kernels = ("blur", "warp", "postprocess", "upsample", "pyramid",
               "finish")
    before = dict(_cuda.LAUNCHES)
    batch = generate_sbs(rgb, depth, StereoParams())
    assert {k: _cuda.LAUNCHES[k] - before[k] for k in kernels} == {
        "blur": 1, "warp": 1, "postprocess": 1, "upsample": 2, "pyramid": 1,
        "finish": 1}
    assert batch.shape == (B, H, 2 * W, 3)
    for i in reversed(range(B)):
        assert torch.equal(generate_sbs(rgb[i:i + 1], depth[i:i + 1],
                                        StereoParams()), batch[i:i + 1]), i


def _bilateral_check(eye4, smoothing, pool=True):
    """One counted launch; the filtered colors within 1 code of the plain
    version on < 0.1 % of pixels; the valid plane and the quarter exact."""
    from vsc_tpu_torch.ops.bilateral_cuda import (bilateral_pool_planar,
                                                  bilateral_pool_plain)
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


@pytest.mark.parametrize("b,h,w,smoothing,pool", [
    (2, 40, 260, 1.0, True), (1, 48, 250, 1.0, True),   # W/2 odd
    (2, 36, 134, 2.5, True), (1, 12, 6, 3.9, False),    # radius 7, tiny
])
def test_bilateral_kernel_matches_plain(dev, b, h, w, smoothing, pool):
    _bilateral_check(_eye4(b, h, w, 15, dev), smoothing, pool)


def _smooth_eye4(b, h, w, seed, dev, holes=0.3):
    """Scene-like colors (so the color weights span their range), holes."""
    yy = torch.arange(h, device=dev)[:, None].float()
    xx = torch.arange(w, device=dev)[None, :].float()
    base = 128 + 100 * torch.sin(xx / 9.0) * torch.cos(yy / 13.0)
    rgb = base + 12 * torch.randn((3, b, h, w), device=dev,
                                  generator=torch.Generator(dev).manual_seed(
                                      seed))
    valid = (_rand((b, h, w), seed + 1, dev) > holes).float()
    rgb = torch.floor(rgb.clamp(0, 255)) * valid
    return torch.cat([rgb, valid[None]]).to(torch.uint8)


# every radius the wrapper reaches (smoothing > 0: diameter >= 5, so 2-7)
@pytest.mark.parametrize("radius,smoothing", [(2, 1.25), (3, 1.5), (4, 2.0),
                                              (5, 2.5), (6, 3.0), (7, 3.5)])
def test_bilateral_kernel_every_radius(dev, radius, smoothing):
    from vsc_tpu_torch.ops.postprocess_cuda import bilateral_geometry
    assert bilateral_geometry(smoothing)[0] == radius
    _bilateral_check(_smooth_eye4(2, 44, 198, radius, dev), smoothing)


@pytest.mark.parametrize("radius", [0, 1, 8])
def test_bilateral_kernel_refuses_other_radii(dev, radius):
    """Radii 0 and 1 are not reached (smoothing > 0 gives radius >= 2)
    and 8 is past the kernel's instances: the C entry refuses each."""
    import ctypes
    eye4 = _eye4(1, 8, 8, 3, dev)
    out = torch.empty_like(eye4)
    w = np.ones(256, dtype=np.float32)
    code = _cuda.library().vsc_bilateral_pool(
        eye4.data_ptr(), out.data_ptr(), None,
        w.ctypes.data_as(ctypes.c_void_p), -0.001, 1, 8, 8, radius,
        _cuda.stream_ptr(dev))
    assert code != 0


# B = 1-4; H not a multiple of the tile's 32 rows; W/2 odd (250, 6090);
# the phase-2 pair's geometry ([4, 4, 3240, 6090]) at a reduced height
@pytest.mark.parametrize("b,h,w", [(1, 36, 250), (2, 100, 130), (3, 68, 64),
                                   (4, 4, 70), (4, 40, 6090), (2, 68, 6090)])
def test_bilateral_kernel_geometries(dev, b, h, w):
    _bilateral_check(_smooth_eye4(b, h, w, b + h, dev), 1.0)


@pytest.mark.parametrize("layout", ["border holes", "hole heavy"])
@pytest.mark.parametrize("smoothing", [1.0, 2.5])
def test_split_postprocess_equals_fused_on_card(dev, smoothing, layout):
    from vsc_tpu_torch.ops.bilateral_cuda import bilateral_pool_planar
    from vsc_tpu_torch.ops.inpaint import _pyramid_fill_planar_coarse
    if layout == "border holes":
        eye4 = _eye4(2, 40, 260, 16, dev)
        eye4[3, :, :, :3] = 0    # holes along the left and right borders
        eye4[3, :, :, -3:] = 0
    else:
        # 60 % holes plus wide disocclusions: most tiles take the
        # postprocess's hole path
        eye4 = _smooth_eye4(2, 72, 262, 17, dev, holes=0.6)
        eye4[3, :, 10:50, 30:90] = 0
        eye4[3, 1, :, 150:200] = 0
    eye4[:3] *= eye4[3][None]
    smooth_q = _pyramid_fill_planar_coarse(eye4)
    filt, quarter = bilateral_pool_planar(eye4, smoothing)
    assert torch.equal(_pyramid_fill_planar_coarse(None, quarter4=quarter),
                       smooth_q)
    assert torch.equal(postprocess_eye(filt, smooth_q, 0.0),
                       postprocess_eye(eye4, smooth_q, smoothing))


def _deconv_case(dev, dtype, n, c, h, w, o, bias, seed, tol,
                 tokens=False):
    """The kernel on a channels-last x against the plain version: the
    launch counted, the values within tol (atol, rtol), the output in the
    memory format conv_transpose2d returns for that x. ``tokens``: x is a
    token sequence less its first token, as a map (images one token
    apart, as DepthPro's upsample_lowres reads them)."""
    from vsc_tpu_torch.ops.deconv_cuda import deconv2x2, deconv2x2_plain
    g = torch.Generator(dev).manual_seed(seed)
    if tokens:
        x = torch.randn((n, 1 + h * w, c), generator=g, device=dev).to(
            dtype)[:, 1:].reshape(n, h, w, c).permute(0, 3, 1, 2)
    else:
        x = torch.randn((n, h, w, c), generator=g, device=dev).to(
            dtype).permute(0, 3, 1, 2)                  # NHWC memory
    wt = (torch.randn((c, o, 2, 2), generator=g, device=dev)
          / (4 * c) ** 0.5).to(dtype)
    b = (0.1 * torch.randn((o,), generator=g, device=dev)).to(
        dtype) if bias else None
    before = _cuda.LAUNCHES["deconv"]
    got = deconv2x2(x, wt, b)
    assert _cuda.LAUNCHES["deconv"] == before + 1
    want = deconv2x2_plain(x, wt, b)
    ref = torch.nn.functional.conv_transpose2d(x, wt, b, stride=2)
    for t in (got, want, ref):
        assert t.is_contiguous(memory_format=torch.channels_last)
    atol, rtol = tol
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    return x, wt, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,o,bias", [
    (2, 128, 8, 16, 128, False), (1, 256, 16, 8, 128, True),   # C != O
    (1, 128, 24, 24, 256, False), (3, 32, 5, 4, 64, True),     # ragged P
    (1, 72, 3, 7, 192, True),                                  # ragged K
])
def test_deconv_kernel_matches_plain(dev, dtype, n, c, h, w, o, bias):
    # f32: sums of <= 256 products in another order; bf16: the same sum
    # rounded once to bf16 (8 bits): one step of the output's bf16 grid
    tol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-3, 8e-3)
    _deconv_case(dev, dtype, n, c, h, w, o, bias, 17, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,g,bias", [(2, 24, True), (3, 8, False)])
def test_deconv_kernel_reads_a_token_slice(dev, dtype, n, g, bias):
    # upsample_lowres at batch 2: the image tokens less the cls token
    from chip_smoke import DECONV_BF16_TOL, DECONV_F32_TOL
    tol = DECONV_F32_TOL if dtype == torch.float32 else DECONV_BF16_TOL
    _deconv_case(dev, dtype, n, 1024 if g == 24 else 128, g, g, 128, bias,
                 60 + g, tol, tokens=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", range(9))
def test_deconv_kernel_depthpro_sites(dev, dtype, site):
    """Every DepthPro site shape of chip_smoke.DECONV_SITES at batch 1,
    with chip_smoke's bounds; an NCHW input is refused."""
    from chip_smoke import DECONV_BF16_TOL, DECONV_F32_TOL, DECONV_SITES
    from vsc_tpu_torch.ops.deconv_cuda import deconv2x2
    S, C, O, bias, _ = DECONV_SITES[site]
    tol = DECONV_F32_TOL if dtype == torch.float32 else DECONV_BF16_TOL
    x, wt, b = _deconv_case(dev, dtype, 1, C, S, S, O, bias, 40 + site, tol)
    with pytest.raises(ValueError, match="channels-last"):
        deconv2x2(x.contiguous(), wt, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("T", [1, 37, 64, 65, 577, 640])
def test_split_attention_kernel_token_counts(dev, dtype, Dh, T):
    from vsc_tpu_torch.ops.attention_cuda import (SPLIT_HEAD_DIMS,
                                                  SPLIT_RESIDENT_T)
    assert Dh in SPLIT_HEAD_DIMS and T <= SPLIT_RESIDENT_T
    B, H = (2, 3) if T < 577 else (1, 2)
    g = torch.Generator(dev).manual_seed(50 + T + Dh)
    qkv = torch.randn((B, T, 3 * H * Dh), generator=g, device=dev).to(dtype)
    _split_check(qkv, H, Dh, Dh ** -0.5)


def _split_check(qkv, H, Dh, scale, large=False):
    """The split kernel on q, k, v views of qkv against the plain version,
    one launch counted; the bounds of test_split_attention_kernel_matches_
    plain, or with ``large`` those of test_attention_kernel_large_logits."""
    from vsc_tpu_torch.ops.attention_cuda import (short_seq_attention,
                                                  short_seq_attention_plain)
    B, T, _ = qkv.shape
    q, k, v = qkv.view(B, T, 3, H, Dh).unbind(2)
    before = _cuda.LAUNCHES["attention_split"]
    got = short_seq_attention(q, k, v, scale).float()
    assert _cuda.LAUNCHES["attention_split"] == before + 1
    want = short_seq_attention_plain(q, k, v, scale).float()
    assert bool(torch.isfinite(got).all())
    diff = (got - want).abs()
    if qkv.dtype == torch.float32:
        assert float(diff.max()) <= 2e-5 * (30 if large else 1)
    elif large:
        vmax = float(v.float().abs().max())
        torch.testing.assert_close(got, want, rtol=8e-3, atol=2 ** -8 * vmax)
        assert float(diff.mean()) <= 1e-3
    else:
        assert float(diff.max()) <= 8e-3
        assert float(diff.mean()) <= 1e-5
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [65, 577])
def test_split_attention_kernel_large_logits(dev, dtype, T):
    # test_attention_kernel_large_logits on the split kernel: logits ~30x
    # larger, so a max over part of a row overflows exp() (f32: the
    # outputs' error grows with the logits' size, 30x the usual bound)
    g = torch.Generator(dev).manual_seed(33)
    qkv = torch.randn((4, T, 3 * 2 * 64), generator=g, device=dev)
    qkv[..., :2 * 2 * 64] *= 30 ** 0.5
    _split_check(qkv.to(dtype), 2, 64, 0.125, large=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [64, 161, 577])
def test_split_attention_kernel_dominant_key(dev, dtype, T):
    # one key per sample takes (nearly) all the mass: the output is its v
    N, H, Dh = 3, 2, 64
    g = torch.Generator(dev).manual_seed(34)
    qkv = 0.1 * torch.randn((N, T, 3 * H * Dh), generator=g, device=dev)
    D = H * Dh
    qkv[..., :D] = 1.0
    keys = [T - 1, 0, T // 2]                        # the last key, the first
    for n, j in enumerate(keys):
        qkv[n, j, D:2 * D] = 2.0
    qkv = qkv.to(dtype)
    got = _split_check(qkv, H, Dh, 0.125)
    for n, j in enumerate(keys):
        torch.testing.assert_close(got[n], qkv[n, j, 2 * D:].float().view(
            H, Dh)[None].expand(T, H, Dh), atol=1e-2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_attention_kernel_runs_one_past_the_resident_cap(dev, dtype):
    # the kernel's old cap + 1 runs, on the two-pass route
    from vsc_tpu_torch.ops.attention_cuda import SPLIT_RESIDENT_T
    T = SPLIT_RESIDENT_T + 1
    g = torch.Generator(dev).manual_seed(60)
    qkv = torch.randn((2, T, 3 * 2 * 64), generator=g, device=dev).to(dtype)
    before = _cuda.ROUTE_LAUNCHES["split_two_pass"]
    _split_check(qkv, 2, 64, 0.125)
    assert _cuda.ROUTE_LAUNCHES["split_two_pass"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [16, 64, 128])
@pytest.mark.parametrize("T", [1025, 1601, 4097])
def test_split_attention_kernel_two_pass_token_counts(dev, dtype, Dh, T):
    # the token counts of inputs 2048, 2560 and 4096 (tiles of 512, 640 and
    # 1024): the two-pass route against the plain version
    g = torch.Generator(dev).manual_seed(61 + T + Dh)
    qkv = torch.randn((1, T, 3 * 2 * Dh), generator=g, device=dev).to(dtype)
    before = _cuda.ROUTE_LAUNCHES["split_two_pass"]
    _split_check(qkv, 2, Dh, Dh ** -0.5)
    assert _cuda.ROUTE_LAUNCHES["split_two_pass"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [16, 64, 128])
@pytest.mark.parametrize("T", [1, 37, 65, 577, 640])
def test_split_attention_two_pass_route_equals_resident(dev, dtype, Dh, T,
                                                        monkeypatch):
    # where both routes run, they give the same bits: the second pass
    # recomputes the first's logits exactly, and each thread sums its p in
    # the resident route's order (the resident route's key range set to 0
    # sends every T to the two-pass route)
    from vsc_tpu_torch.ops import attention_cuda
    g = torch.Generator(dev).manual_seed(62 + T + Dh)
    qkv = torch.randn((2, T, 3 * 3 * Dh), generator=g, device=dev).to(dtype)
    q, k, v = qkv.view(2, T, 3, 3, Dh).unbind(2)
    before = dict(_cuda.ROUTE_LAUNCHES)
    resident = attention_cuda.short_seq_attention(q, k, v, Dh ** -0.5)
    monkeypatch.setattr(attention_cuda, "SPLIT_RESIDENT_T", 0)
    two_pass = attention_cuda.short_seq_attention(q, k, v, Dh ** -0.5)
    assert _cuda.ROUTE_LAUNCHES["split"] == before["split"] + 1
    assert _cuda.ROUTE_LAUNCHES["split_two_pass"] == \
        before["split_two_pass"] + 1
    assert torch.equal(two_pass, resident)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_attention_two_pass_large_logits(dev, dtype):
    # test_split_attention_kernel_large_logits at input 2048's 1025 tokens
    g = torch.Generator(dev).manual_seed(63)
    qkv = torch.randn((2, 1025, 3 * 2 * 64), generator=g, device=dev)
    qkv[..., :2 * 2 * 64] *= 30 ** 0.5
    _split_check(qkv.to(dtype), 2, 64, 0.125, large=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_attention_two_pass_dominant_key(dev, dtype):
    # test_split_attention_kernel_dominant_key at 1025 tokens
    N, T, H, Dh = 3, 1025, 2, 64
    g = torch.Generator(dev).manual_seed(64)
    qkv = 0.1 * torch.randn((N, T, 3 * H * Dh), generator=g, device=dev)
    D = H * Dh
    qkv[..., :D] = 1.0
    keys = [T - 1, 0, T // 2]
    for n, j in enumerate(keys):
        qkv[n, j, D:2 * D] = 2.0
    qkv = qkv.to(dtype)
    got = _split_check(qkv, H, Dh, 0.125)
    for n, j in enumerate(keys):
        torch.testing.assert_close(got[n], qkv[n, j, 2 * D:].float().view(
            H, Dh)[None].expand(T, H, Dh), atol=1e-2, rtol=0)


@pytest.mark.parametrize("N,T,H", [(3, 641, 2), (2, 1025, 16), (1, 1601, 3),
                                   (1, 4097, 1)])
def test_attention_kernel_beyond_its_tokens(dev, N, T, H):
    # qkv_attention past its own kernel's 640 keys: the flash kernel on the
    # same qkv, the qkv and split kernels not launched; against the plain
    # version in the flash kernel's order (flash_attention_plain), with the
    # qkv kernel's bounds
    from vsc_tpu_torch.ops.attention_cuda import flash_attention_plain
    g = torch.Generator(dev).manual_seed(65 + T)
    qkv = torch.randn((N, T, 3 * H * 64), generator=g, device=dev).to(
        torch.bfloat16)
    before = dict(_cuda.LAUNCHES), dict(_cuda.ROUTE_LAUNCHES)
    got = qkv_attention(qkv, H, 0.125).float()
    assert _cuda.LAUNCHES["attention"] == before[0]["attention"]
    assert _cuda.LAUNCHES["attention_split"] == before[0]["attention_split"]
    assert _cuda.LAUNCHES["attention_flash"] == \
        before[0]["attention_flash"] + 1
    assert _cuda.ROUTE_LAUNCHES["flash"] == before[1]["flash"] + 1
    want = flash_attention_plain(qkv, H, 0.125).float()
    diff = (got - want).abs()
    assert float(diff.max()) <= 8e-3
    assert float(diff.mean()) <= 1e-5


def test_attention_kernel_beyond_its_tokens_large_logits(dev):
    # test_attention_kernel_large_logits at 1025 tokens, on the flash
    # kernel: a tile's max below the row's later max must rescale, not
    # overflow
    from vsc_tpu_torch.ops.attention_cuda import flash_attention_plain
    g = torch.Generator(dev).manual_seed(66)
    qkv = torch.randn((4, 1025, 3 * 2 * 64), generator=g, device=dev)
    qkv[..., :2 * 2 * 64] *= 30 ** 0.5
    qkv = qkv.to(torch.bfloat16)
    got = qkv_attention(qkv, 2, 0.125).float()
    want = flash_attention_plain(qkv, 2, 0.125).float()
    assert bool(torch.isfinite(got).all())
    vmax = float(qkv[..., 2 * 2 * 64:].float().abs().max())
    torch.testing.assert_close(got, want, rtol=8e-3, atol=2 ** -8 * vmax)
    assert float((got - want).abs().mean()) <= 1e-3


def test_attention_kernel_beyond_its_tokens_dominant_key(dev):
    # test_attention_kernel_dominant_key at 1025 tokens, on the flash kernel
    # (the dominant key in the last, the first and a middle tile)
    from vsc_tpu_torch.ops.attention_cuda import flash_attention_plain
    N, T, H = 3, 1025, 2
    g = torch.Generator(dev).manual_seed(67)
    qkv = 0.1 * torch.randn((N, T, 3 * H * 64), generator=g, device=dev)
    D = H * 64
    qkv[..., :D] = 1.0
    keys = [T - 1, 0, T // 2]
    for n, j in enumerate(keys):
        qkv[n, j, D:2 * D] = 2.0
    qkv = qkv.to(torch.bfloat16)
    got = qkv_attention(qkv, H, 0.125).float()
    want = flash_attention_plain(qkv, H, 0.125).float()
    diff = (got - want).abs()
    assert float(diff.max()) <= 8e-3 and float(diff.mean()) <= 1e-5
    for n, j in enumerate(keys):
        torch.testing.assert_close(got[n], qkv[n, j, 2 * D:].float()[
            None].expand(T, D), atol=1e-2, rtol=0)


@pytest.mark.parametrize("N,T,H", [(2, 641, 2), (1, 768, 3), (3, 1000, 1),
                                   (2, 2443, 4), (1, 1, 1), (2, 191, 2),
                                   (1, 385, 2)])
def test_flash_attention_kernel_matches_plain(dev, N, T, H):
    # ragged tails of the key tiles (128) and of the query blocks (192),
    # one token, and Depth Anything V2's 2,443, called directly
    from vsc_tpu_torch.ops.attention_cuda import (flash_attention,
                                                  flash_attention_plain)
    g = torch.Generator(dev).manual_seed(70 + T)
    qkv = torch.randn((N, T, 3 * H * 64), generator=g, device=dev).to(
        torch.bfloat16)
    before = _cuda.ROUTE_LAUNCHES["flash"]
    got = flash_attention(qkv, H, 0.125)
    assert _cuda.ROUTE_LAUNCHES["flash"] == before + 1
    assert got.shape == (N, T, H * 64) and got.dtype == torch.bfloat16
    diff = (got.float() - flash_attention_plain(qkv, H, 0.125).float()).abs()
    assert float(diff.max()) <= 8e-3
    assert float(diff.mean()) <= 1e-5


def test_flash_attention_at_depth_anythings_shape(dev):
    # [8, 2443, 16, 64]: a batch of 8 1080p frames at 518 x 924 through one
    # ViT-L/14 block, against the full-row plain version
    # (short_seq_attention_plain, p rounded at the final max): bf16's
    # rounding of p at the running max moves the output by about 2^-9 of
    # the v values over sqrt(T) keys, below one bf16 step of the output
    # on average: max 8e-3 (the qkv kernel's bound), mean 1e-4
    from vsc_tpu_torch.ops.attention_cuda import (flash_attention,
                                                  flash_attention_plain,
                                                  short_seq_attention_plain)
    N, T, H = 8, 2443, 16
    g = torch.Generator(dev).manual_seed(77)
    qkv = torch.randn((N, T, 3 * H * 64), generator=g, device=dev).to(
        torch.bfloat16)
    got = flash_attention(qkv, H, 0.125).float()
    q, k, v = qkv.view(N, T, 3, H, 64).unbind(2)
    want = short_seq_attention_plain(q, k, v, 0.125).float().view(N, T, -1)
    diff = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert float(diff.max()) <= 8e-3
    assert float(diff.mean()) <= 1e-4
    same = (got - flash_attention_plain(qkv, H, 0.125).float()).abs()
    assert float(same.max()) <= 8e-3 and float(same.mean()) <= 1e-5


def test_depth_anything_on_the_card(dev, monkeypatch):
    # a small Depth Anything V2 at head dim 64 with 677 tokens (52 x 52
    # input, patch 2): bf16 runs every block's attention on the flash
    # kernel; float32 on the split kernel, within 1 code of the plain
    # reference (tests/plain_depth_anything_v2.py) on the card
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import plain_depth_anything_v2 as ref
    from vsc_tpu_torch.models.depth_anything import DepthAnythingV2Config
    from vsc_tpu_torch.models.vit import ViTConfig
    from vsc_tpu_torch.pipeline import depth_map_generator as tdepth
    cfg = DepthAnythingV2Config(
        encoder=ViTConfig(img_size=12, patch_size=2, embed_dim=128, depth=4,
                          num_heads=2, layerscale_init=1.0),
        hook_block_ids=(0, 1, 2, 3), features=16,
        out_channels=(8, 16, 32, 32), input_size=52)
    rcfg = ref.DAv2Cfg(patch_size=2, pos_grid=6, embed_dim=128, depth=4,
                       num_heads=2, hooks=(0, 1, 2, 3), features=16,
                       out_channels=(8, 16, 32, 32), input_size=52)
    with torch.device("meta"):
        rmodel = ref.DepthAnythingV2(rcfg)
    path = Path(__import__("tempfile").mkdtemp()) / "dav2.pth"
    torch.save(ref.init_seeded(rmodel, 5), path)
    model = ref.load_official(path, rcfg, dev)
    g = torch.Generator(dev).manual_seed(78)
    frames = torch.randint(0, 256, (2, 54, 54, 3), generator=g, device=dev,
                           dtype=torch.uint8)
    want = ref.depth_u8(model, frames)
    monkeypatch.setenv(tdepth.DTYPE_ENV, "float32")
    fn = tdepth.build_depth_fn("depth-anything-v2", 52, 54, 54, False,
                               checkpoint=str(path), device=dev,
                               model_cfg=cfg)
    assert int((fn(frames).int() - want.int()).abs().max()) <= 1
    monkeypatch.setenv(tdepth.DTYPE_ENV, "bfloat16")
    fn = tdepth.build_depth_fn("depth-anything-v2", 52, 54, 54, False,
                               checkpoint=str(path), device=dev,
                               model_cfg=cfg)
    before = dict(_cuda.ROUTE_LAUNCHES), dict(_cuda.LAUNCHES)
    got = fn(frames)
    torch.cuda.synchronize()
    assert _cuda.ROUTE_LAUNCHES["flash"] == before[0]["flash"] + 4
    assert _cuda.LAUNCHES["attention"] == before[1]["attention"]
    assert _cuda.LAUNCHES["attention_split"] == before[1]["attention_split"]
    assert got.dtype == torch.uint8 and got.shape == (2, 54, 54)
    assert int(got.max()) == 255 and int(got.min()) == 0
    # a parallel/mesh data mesh of this one card: the same depth
    from vsc_tpu_torch.parallel.auto import gather, shard_batch
    from vsc_tpu_torch.parallel.mesh import Sharded, make_mesh
    mesh = make_mesh(data=1, devices=[dev])
    fn_mesh = tdepth.build_depth_fn("depth-anything-v2", 52, 54, 54, False,
                                    checkpoint=str(path), mesh=mesh,
                                    model_cfg=cfg)
    batch = shard_batch(frames.cpu().numpy(), dev, mesh)
    batch = batch if isinstance(batch, Sharded) else Sharded((batch,), mesh)
    assert torch.equal(gather(fn_mesh(batch)), got.cpu())


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


def _step_workflow(tmp_path, n, h=108, w=192, save_16bit=False):
    """A workflow made by the port's workflow_init with n seeded frames
    (no media engine: the frames are written as the extractor names
    them)."""
    from vsc_tpu_torch.config import load_config, save_config
    from vsc_tpu_torch.io.image import write_rgb
    from vsc_tpu_torch.pipeline import workflow_init
    video = tmp_path / "input.mkv"
    video.touch()
    wf = tmp_path / "workflow"
    assert workflow_init.main(["--input-video", str(video),
                               "--workflow-dir", str(wf)]) == 0
    config = load_config(wf)
    config["depth"]["save_16bit"] = save_16bit
    save_config(wf, config)
    rng = np.random.default_rng(19)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(1, n + 1):
        base = 127 + 100 * np.sin(xx / (9.0 + i)) * np.cos(yy / 7.0)
        rgb = np.stack([base, 0.7 * base + 40, 255 - base], -1)
        rgb = np.clip(rgb + rng.normal(0, 6, rgb.shape), 0, 255)
        frames.append(rgb.astype(np.uint8))
        assert write_rgb(wf / "frames" / f"frame_{i:06d}.png", frames[-1])
    return wf, np.stack(frames)


def _padded_batches(x, batch):
    for i in range(0, len(x), batch):
        b = x[i:i + batch]
        yield np.concatenate([b] + [b[-1:]] * (batch - len(b)))


@pytest.mark.parametrize("save_16bit", [False, True])
def test_depth_step_on_card_equals_build_depth_fn(dev, tmp_path, monkeypatch,
                                                  save_16bit):
    """The depth step CLI on the card (small DepthPro from seed 0, bf16, a
    ragged last batch): its files equal build_depth_fn on the same padded
    batches bit for bit."""
    import functools
    from vsc_tpu_torch.io.image import read_depth
    from vsc_tpu_torch.models import DepthProConfig, ViTConfig
    from vsc_tpu_torch.models import bootstrap
    from vsc_tpu_torch.pipeline import depth_map_generator as step
    cfg = DepthProConfig(
        encoder=ViTConfig(img_size=32, patch_size=4, embed_dim=128, depth=4,
                          num_heads=2),
        img_size=128, tile_size=32, hook_block_ids=(0, 2),
        decoder_features=16, dims_encoder=(16, 24, 32, 32),
        use_fov_head=False)
    monkeypatch.setattr(bootstrap, "resolve_checkpoint", lambda: None)
    monkeypatch.setattr(step, "build_depth_fn", functools.partial(
        step.build_depth_fn, model_cfg=cfg))
    wf, frames = _step_workflow(tmp_path, 5, save_16bit=save_16bit)
    before = _cuda.LAUNCHES["attention"]
    assert step.main([str(wf), "--model", "depthpro", "--batch-size", "4",
                      "--no-interactive"]) == 0
    assert _cuda.LAUNCHES["attention"] > before
    fn = step.build_depth_fn("depthpro", 128, 108, 192, save_16bit,
                             device=dev)
    want = np.concatenate([fn(torch.from_numpy(b).to(dev)).cpu().numpy()
                           for b in _padded_batches(frames, 4)])[:5]
    ext = "tif" if save_16bit else "png"
    got = np.stack([read_depth(wf / "depth_maps" / f"depth_frame_{i:06d}.{ext}")
                    for i in range(1, 6)])
    assert got.dtype == (np.uint16 if save_16bit else np.uint8)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("depth_dtype", [np.uint8, np.uint16])
def test_sbs_step_on_card_equals_generate_sbs(dev, tmp_path, depth_dtype):
    """The SBS step CLI on the card at the StereoParams() defaults
    (super_sampling 3, the planar-u8 branch; a ragged last batch): its
    PNGs equal generate_sbs on the same padded batches bit for bit, and
    every default-path SBS kernel launched."""
    from vsc_tpu_torch.io.image import read_rgb, write_quantized_depth
    from vsc_tpu_torch.pipeline import sbs_generator
    wf, frames = _step_workflow(tmp_path, 5)
    top = np.iinfo(depth_dtype).max
    yy, xx = np.mgrid[0:108, 0:192]
    depth = []
    for i in range(5):
        d = 0.5 + 0.3 * np.sin(xx / (13.0 + i)) + 0.2 * (yy > 50)
        depth.append(np.round(d / d.max() * top).astype(depth_dtype))
        ext = "tif" if depth_dtype == np.uint16 else "png"
        assert write_quantized_depth(
            depth[-1], wf / "depth_maps" / f"depth_frame_{i + 1:06d}.{ext}")
    depth = np.stack(depth)
    _cuda.reset_launches()
    assert sbs_generator.main([str(wf), "--batch-size", "4",
                               "--no-interactive"]) == 0
    assert all(_cuda.LAUNCHES[k] > 0 for k in (
        "blur", "warp", "postprocess", "upsample", "pool", "pyramid",
        "finish")), _cuda.LAUNCHES
    want = np.concatenate([
        generate_sbs(torch.from_numpy(r).to(dev), torch.from_numpy(d).to(dev),
                     StereoParams()).cpu().numpy()
        for r, d in zip(_padded_batches(frames, 4),
                        _padded_batches(depth, 4))])[:5]
    got = np.stack([read_rgb(wf / "sbs" / f"sbs_{i:06d}.png")
                    for i in range(1, 6)])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_fov_head_kernel_route_equals_plain(dev, monkeypatch, dtype):
    """A small DepthPro with the FOV head (head dim 64) on the card: each
    attention of its three ViTs, the FOV encoder's included, launches the
    kernel of its route (the qkv kernel in bf16, the split kernel in
    float32), and its outputs agree with the same model on the plain
    attention: in float32 fov_deg within 1e-3 degrees and the depth maps
    within test_torch_checkpoints.BOUND; in bf16 the kernel route is as
    close to the float32 model as the plain route is, give or take one
    bf16 rounding of the output (the head rounds its ~50 degrees to bf16's
    grid of 0.25 there)."""
    import copy
    from vsc_tpu_torch.models import (DepthPro, DepthProConfig, ViTConfig,
                                      init_flax_like, vit)
    from vsc_tpu_torch.ops.attention_cuda import short_seq_attention_plain
    cfg = DepthProConfig(
        encoder=ViTConfig(img_size=32, patch_size=4, embed_dim=128, depth=2,
                          num_heads=2),
        img_size=128, tile_size=32, hook_block_ids=(0, 1),
        decoder_features=16, dims_encoder=(16, 24, 32, 32))
    with dev:
        model = DepthPro(cfg).eval()
    g = torch.Generator(dev).manual_seed(0)
    init_flax_like(model, g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gamma"):      # make the attention show
                p.uniform_(0.5, 1.5, generator=g)
        model.fov.head[4].weight.mul_(50.0)  # a spread of degrees
        model.fov.head[4].bias.add_(50.0)
    x = _rand((4, 128, 128, 3), 7, dev) * 2 - 1

    def run(m, plain=False):
        with monkeypatch.context() as mp:
            if plain:
                mp.setattr(vit, "qkv_attention", qkv_attention_plain)
                mp.setattr(vit, "short_seq_attention",
                           short_seq_attention_plain)
            with torch.no_grad():
                return m(x)

    f32 = run(model, plain=True)
    m = copy.deepcopy(model).to(dtype)
    _cuda.reset_launches()
    got = run(m)
    torch.cuda.synchronize()
    route = "attention" if dtype == torch.bfloat16 else "attention_split"
    assert _cuda.LAUNCHES[route] == 3 * cfg.encoder.depth, _cuda.LAUNCHES
    want = run(m, plain=True)
    assert bool(torch.isfinite(got["fov_deg"]).all())
    assert float(f32["fov_deg"].max() - f32["fov_deg"].min()) > 1.0
    if dtype == torch.float32:
        torch.testing.assert_close(got["fov_deg"], want["fov_deg"],
                                   atol=1e-3, rtol=0)
        for k in ("canonical_inverse_depth", "inverse_depth"):
            torch.testing.assert_close(got[k], want[k], atol=5e-3,
                                       rtol=1e-3)
        return
    for k in ("fov_deg", "inverse_depth"):
        top = float(f32[k].abs().max())
        ulp = torch.finfo(torch.bfloat16).eps * 2.0 ** np.floor(np.log2(top))
        kernel = float((got[k] - f32[k]).abs().max())
        plain = float((want[k] - f32[k]).abs().max())
        assert kernel <= plain + ulp, (k, kernel, plain, ulp)


# ---- the postprocess's tile counters and the spans on the card
# (utils/profiling: on while a torch.profiler session is open)

def _pp_hole_pair(layout, dev):
    B, H, W = 2, 5 * TILE_H + 11, 7 * TILE_W + 3
    eye4 = _pp_frame(B, H, W, 31, dev)
    if layout == "scattered":
        eye4[3] = (_rand((B, H, W), 32, dev) > 0.002).to(torch.uint8)
    elif layout == "clustered":
        eye4[3, :, 10:70, 20:26] = 0
        eye4[3, 1, 3 * TILE_H:3 * TILE_H + 2, :] = 0
    elif layout == "all_holes":
        eye4[3] = 0
    eye4[:3] *= (eye4[3] > 0)[None]
    img = torch.movedim(eye4[:3], 0, -1).float()
    smooth_q = _pyramid_fill(img, eye4[3].float()[..., None], coarse_factor=4,
                             return_coarse=True).permute(3, 0, 1, 2)
    return eye4, smooth_q.contiguous()


@pytest.mark.parametrize("layout", ["none", "scattered", "clustered",
                                    "all_holes"])
def test_postprocess_counts_its_tiles_and_hole_tiles(dev, layout):
    """While tracing, postprocess.hole_tiles and postprocess.fast_tiles
    count exactly the hole tiles (``hole_tiles``) and the other tiles of
    each launch, and the output is byte-equal to an untraced launch's."""
    from torch.profiler import ProfilerActivity, profile

    from vsc_tpu_torch.utils import profiling
    eye4, smooth_q = _pp_hole_pair(layout, dev)
    tiles = hole_tiles(eye4[3])
    _cuda.reset_launches()
    want = postprocess_eye(eye4, smooth_q, 1.0)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        got = [postprocess_eye(eye4, smooth_q, 1.0) for _ in range(3)]
    holes = int(tiles.sum())
    assert profiling.counters() == {
        "postprocess.hole_tiles": 3 * holes,
        "postprocess.fast_tiles": 3 * (tiles.numel() - holes)}
    for g in got:
        assert torch.equal(g, want)
    _cuda.reset_launches()
    assert profiling.counters() == {}


def test_postprocess_gets_a_null_counter_pointer_untraced(dev, monkeypatch):
    """Untraced (the benchmark's --trace 0), the kernel is handed a null
    counter pointer and no span is recorded; traced, a device pointer."""
    from torch.profiler import ProfilerActivity, profile

    from vsc_tpu_torch.utils import profiling
    lib = _cuda.library()
    seen = []

    class Spy:
        def vsc_postprocess(self, *args):
            seen.append(args[-2])
            return lib.vsc_postprocess(*args)
    monkeypatch.setattr(_cuda, "library", lambda: Spy())
    eye4, smooth_q = _pp_hole_pair("clustered", dev)
    profiling.reset()
    postprocess_eye(eye4, smooth_q, 1.0)
    with profile(activities=[ProfilerActivity.CPU]):
        postprocess_eye(eye4, smooth_q, 1.0)
    postprocess_eye(eye4, smooth_q, 1.0)
    assert seen[0] is None and seen[2] is None
    assert isinstance(seen[1], int) and seen[1] != 0
    assert profiling.spans() == []


def test_a_profiled_render_step_leaves_no_device_event_of_the_program(dev):
    """One step as the convert cells run it (copy in, depth, SBS, copy
    out on the dispatch thread) under the profiler, reduced as the
    benchmark reduces it: the program's marks are host events only, every
    span is recorded, the device spans carry event times, and the depth's
    encoder and decoder lie inside it."""
    import dataclasses
    import sys
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile, record_function

    from vsc_tpu_torch.models import DepthProConfig
    from vsc_tpu_torch.parallel import health
    from vsc_tpu_torch.parallel.auto import gather, shard_batch
    from vsc_tpu_torch.pipeline import depth_map_generator
    from vsc_tpu_torch.pipeline.stream_convert import render_sbs
    from vsc_tpu_torch.utils import profiling
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))
    from lib import trace as bench_trace

    cfg = dataclasses.replace(DepthProConfig.tiny(), use_fov_head=False,
                              use_fov_encoder=False)
    depth_fn = depth_map_generator.build_depth_fn(
        "depthpro", 64, 72, 128, False, device=dev, model_cfg=cfg)
    frames = np.random.default_rng(3).integers(0, 256, (2, 72, 128, 3),
                                               dtype=np.uint8)

    def step():
        return gather(render_sbs(shard_batch(frames, dev), depth_fn,
                                 StereoParams())).numpy()
    want = health.run_with_deadline(step, 300)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with record_function(bench_trace.STEP):
                got = health.run_with_deadline(step, 300)
        torch.cuda.synchronize()
    assert np.array_equal(got, want)
    red = bench_trace.reduce_profile(prof)
    assert red["steps"] == 3 and red["device"]
    assert not [n for _, _, n in red["device"] if n.startswith("vsc.")]
    assert [n for _, _, n in red["host"] if n == "vsc.dispatch"] == \
        3 * ["vsc.dispatch"]
    s = profiling.spans()
    names = [x["name"] for x in s]
    for n in ("dispatch", "transfer.copy_in", "depth", "depth.encoder",
              "depth.decoder", "sbs", "transfer.drain", "transfer.copy_out"):
        assert names.count(n) == 3, (n, names)
    for x in s:
        device = x["name"] in ("depth", "depth.encoder", "depth.decoder",
                               "sbs")
        assert (x["device_ms"] is not None) == device, x
        if device:
            assert x["device_ms"] > 0
    depth = sum(x["device_ms"] for x in s if x["name"] == "depth")
    parts = sum(x["device_ms"] for x in s
                if x["name"] in ("depth.encoder", "depth.decoder"))
    assert 0 < parts < depth


# ---- the copy out (parallel/auto.gather): into page-locked memory from
# PyTorch's caching pinned allocator, owned by the caller

def _gather_case(case, dev):
    """A device result and what gather must give back for it."""
    from vsc_tpu_torch.parallel.mesh import Sharded, make_mesh
    x = _rand((8, 36, 70, 3), 91, dev)
    if case == "u8":
        x = (x * 255).to(torch.uint8)
    elif case == "u16":
        x = (x * 65535).to(torch.int32).to(torch.uint16)
    elif case == "bf16":
        x = x.to(torch.bfloat16)
    elif case == "strided":
        x = x.transpose(1, 2)               # not contiguous on the card
    elif case == "sharded":
        x = (x * 255).to(torch.uint8)
        mesh = make_mesh(2, 1, devices=[dev, dev])
        return Sharded(tuple(x.chunk(2)), mesh), x
    return x, x


def _bytes(t):
    return t.contiguous().view(torch.uint8).cpu()


@pytest.mark.parametrize("case", ["u8", "u16", "f32", "bf16", "strided",
                                  "sharded"])
def test_gather_is_pinned_and_byte_equal(dev, case):
    from vsc_tpu_torch.parallel.auto import gather
    result, want = _gather_case(case, dev)
    got = gather(result)
    assert got.device.type == "cpu" and got.is_pinned()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_contiguous()
    assert torch.equal(_bytes(got), _bytes(want))


def test_a_held_gather_result_keeps_its_bytes(dev):
    """A result the caller holds is its own: later gathers of other data
    (of the same size, which the allocator would hand the block of a
    dropped result) leave it as it was."""
    from vsc_tpu_torch.parallel.auto import gather
    x = (_rand((4, 64, 96, 3), 92, dev) * 255).to(torch.uint8)
    held = gather(x)
    view = held.numpy()
    want = x.cpu()
    for k in range(3):
        gather(x ^ (k + 1))
        gather((255 - x) if k % 2 else x.flip(0))
    x.zero_()
    torch.cuda.synchronize()
    assert torch.equal(held, want)
    assert np.array_equal(view, want.numpy())


def test_dropped_gather_results_reuse_pinned_blocks(dev):
    """After one warm-up call, 20 gathers whose results are dropped grow
    the pinned allocator by no block."""
    from vsc_tpu_torch.parallel.auto import gather
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        pytest.skip("this torch has no torch.cuda.host_memory_stats")
    x = (_rand((8, 54, 96, 3), 93, dev) * 255).to(torch.uint8)
    gather(x)
    before = stats()["num_host_alloc"]
    for _ in range(20):
        gather(x)
    assert stats()["num_host_alloc"] == before


def test_gather_counts_its_pinned_copies_while_tracing(dev):
    """While tracing, transfer.pinned_out counts each gather of a device
    result and transfer.pinned_out_bytes sums their bytes; untraced
    gathers count nothing."""
    from torch.profiler import ProfilerActivity, profile

    from vsc_tpu_torch.parallel.auto import gather
    from vsc_tpu_torch.utils import profiling
    results = [_gather_case(c, dev)[0] for c in ("u8", "f32", "sharded")]
    _cuda.reset_launches()
    for r in results:
        gather(r)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        got = [gather(r) for r in results + results[:1]]
    c = profiling.counters()
    assert c["transfer.pinned_out"] == 4
    assert c["transfer.pinned_out_bytes"] == sum(g.nbytes for g in got)
    if hasattr(torch.cuda, "host_memory_stats"):
        assert 0 <= c["transfer.host_alloc"] <= 4
    else:
        assert "transfer.host_alloc" not in c
    _cuda.reset_launches()
    assert profiling.counters() == {}
