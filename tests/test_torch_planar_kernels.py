"""The plain versions of the planar-u8 stereo branch's kernels (upsample,
pools, pyramid, finish, planar warp) against the JAX Pallas kernels they
replace, run in interpret mode on the CPU as the JAX package's own tests
run them. The kernels are compared with these plain versions on the card
by chip_smoke.py and tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsc_tpu_torch.ops import inpaint as tinp
from vsc_tpu_torch.ops.finish_cuda import (sharpen_downscale,
                                           sharpen_downscale_planar)
from vsc_tpu_torch.ops.pool_cuda import avgpool2, avgpool2_eye4, avgpool4_eye4
from vsc_tpu_torch.ops.pyramid_cuda import pyramid_fill_below
from vsc_tpu_torch.ops.upsample_cuda import upsample_bilinear_int
from vsc_tpu_torch.ops.warp_cuda import forward_warp_eyes_planar


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eye4(b, h, w, seed, holes=0.3):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (3, b, h, w))
    valid = (rng.random((b, h, w)) > holes).astype(np.int64)
    return np.concatenate([rgb * valid, valid[None]]).astype(np.uint8)


@pytest.mark.parametrize("f,shape", [
    (2, (3, 13, 37)), (3, (2, 20, 45)), (4, (1, 7, 150)), (3, (1, 1, 5)),
    # factors up to 8, rows whose widths are not multiples of 4 or 16 in or
    # out (the 1080p and 4K rows among them)
    (5, (1, 9, 131)), (6, (2, 4, 33)), (7, (1, 5, 257)), (8, (1, 3, 129)),
    (3, (1, 3, 2030)), (3, (1, 2, 3949))])
@pytest.mark.parametrize("quantize_u8", [False, True])
def test_upsample_plain_matches_pallas(f, shape, quantize_u8):
    from vsc_tpu.ops.upsample_pallas import upsample_bilinear_int_pallas
    rng = np.random.default_rng(f)
    if quantize_u8:   # the RGB planes: integers in [0, 255]
        x = rng.integers(0, 256, shape).astype(np.float32)
    else:             # the depth plane
        x = rng.random(shape).astype(np.float32)
    got = upsample_bilinear_int(_t(x), f, quantize_u8=quantize_u8).numpy()
    want = np.asarray(upsample_bilinear_int_pallas(jnp.asarray(x), f,
                                                   quantize_u8=quantize_u8))
    assert got.dtype == want.dtype and got.shape == want.shape
    if quantize_u8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("entry,shape", [
    ("avgpool2_eye4", (2, 34, 50)),
    ("avgpool2_eye4", (1, 6, 2)),
    ("avgpool4_eye4", (2, 36, 52)),
    ("avgpool4_eye4", (1, 4, 8)),
])
def test_eye4_pools_match_pallas(entry, shape):
    from vsc_tpu.ops import pool_pallas
    eye4 = _eye4(*shape, seed=len(entry) + shape[1])
    got = {"avgpool2_eye4": avgpool2_eye4,
           "avgpool4_eye4": avgpool4_eye4}[entry](_t(eye4)).numpy()
    want = np.asarray(getattr(pool_pallas, entry)(jnp.asarray(eye4)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(4, 18, 26), (16, 2, 6)])
def test_avgpool2_matches_pallas(shape):
    from vsc_tpu.ops.pool_pallas import avgpool2 as j_avgpool2
    x = np.random.default_rng(3).random(shape).astype(np.float32) * 255
    got = avgpool2(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_avgpool2(jnp.asarray(x))))


def _quarter_window_rule(eye4):
    """The quarter pool's index rule, as csrc/pool.cu applies it: output
    (y, x) sums rows min(2 min(2y + a, h1 - 1) + b, H - 1), a, b in {0, 1},
    h1 = ceil(H / 2), and the columns alike, of (rgb * valid, valid) in
    integers, then scales by 1/16."""
    def index(n):
        h1 = (n + 1) // 2
        q = np.arange((h1 + 1) // 2)[:, None]
        a, b = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
        return np.minimum(2 * np.minimum(2 * q + a, h1 - 1) + b, n - 1)
    x = eye4.astype(np.int64)
    x = np.concatenate([x[:3] * x[3][None], x[3][None]])
    iy, ix = index(eye4.shape[2]), index(eye4.shape[3])
    win = x[:, :, iy][:, :, :, :, ix]           # [4, B, qh, 4, qw, 4]
    return (win.sum(axis=(3, 5)) * 0.0625).astype(np.float32)


# odd, even and mixed sides; strips of the 4K and 1080p pairs (W' 11847
# and 6090, rows a multiple of 4 as 6480 and 3240 are)
QUARTER_SHAPES = [(1, 5, 7), (2, 6, 10), (2, 8, 11), (1, 7, 12), (1, 1, 1),
                  (1, 1, 9), (2, 9, 1), (2, 36, 52), (2, 34, 50),
                  (2, 12, 11847), (2, 12, 6090)]


@pytest.mark.parametrize("b,h,w", QUARTER_SHAPES)
def test_quarter_pool_plain_is_the_pyramid_fill_prepass(b, h, w):
    """The quarter stack (avgpool4_eye4's plain version, at any H and W) is
    _pyramid_fill's two edge-padded 2x2 levels of (img * valid, valid),
    the kernel's window rule gives the same bits, and the planar coarse
    fill is _pyramid_fill(coarse_factor=4, return_coarse=True)."""
    eye4 = _eye4(b, h, w, seed=h * w + b)
    got = avgpool4_eye4(_t(eye4))
    img = _t(np.moveaxis(eye4[:3], 0, -1).astype(np.float32))
    valid = _t(eye4[3][..., None].astype(np.float32))
    x, m = img * valid, valid
    for _ in range(2):
        x, m = tinp._avgpool2(x), tinp._avgpool2(m)
    want = torch.cat([x.permute(3, 0, 1, 2), m.permute(3, 0, 1, 2)])
    assert got.shape == (4, b, -(-h // 4), -(-w // 4))
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), _quarter_window_rule(eye4))
    coarse = tinp._pyramid_fill(img, valid, coarse_factor=4,
                                return_coarse=True).permute(3, 0, 1, 2)
    assert torch.equal(tinp._pyramid_fill_planar_coarse(_t(eye4)), coarse)


def test_quarter_window_rule_on_any_bytes():
    """The window rule holds for any valid byte, not only 0 and 1 (the
    kernel's integer sums reach 16 * 255 * 255)."""
    rng = np.random.default_rng(5)
    eye4 = rng.integers(0, 256, (4, 2, 13, 37), dtype=np.uint8)
    eye4[:, :, 0, :3] = 255
    assert np.array_equal(avgpool4_eye4(_t(eye4)).numpy(),
                          _quarter_window_rule(eye4))


@pytest.mark.parametrize("call,match", [
    (lambda: avgpool4_eye4(torch.zeros((3, 1, 8, 8), dtype=torch.uint8)),
     r"\[4, B, H, W\]"),
    (lambda: avgpool4_eye4(torch.zeros((4, 8, 8), dtype=torch.uint8)),
     r"\[4, B, H, W\]"),
    (lambda: avgpool4_eye4(torch.zeros((4, 1, 0, 8), dtype=torch.uint8)),
     r"\[4, B, H, W\]"),
    (lambda: avgpool4_eye4(torch.zeros((4, 1, 8, 8))), "need uint8"),
    (lambda: avgpool2_eye4(torch.zeros((4, 1, 8, 8), dtype=torch.int16)),
     "need uint8"),
    (lambda: avgpool2_eye4(torch.zeros((4, 1, 6, 7), dtype=torch.uint8)),
     "need even H, W"),
])
def test_eye4_pool_wrappers_refuse_bad_input(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def _quarter(b, h, w, seed):
    """A pooled (img * valid x3, valid) stack with empty regions."""
    rng = np.random.default_rng(seed)
    valid = rng.random((b, h, w)).astype(np.float32)
    valid[valid < 0.4] = 0.0
    valid[:, : h // 2, : w // 3] = 0.0          # a hole the ladder must fill
    img = rng.random((3, b, h, w)).astype(np.float32) * 255 * valid
    return np.concatenate([img, valid[None]])


@pytest.mark.parametrize("b,h,w", [(2, 13, 27), (1, 1, 9), (2, 7, 1),
                                   (1, 1, 1), (2, 51, 96)])
def test_pyramid_plain_matches_pallas(b, h, w):
    from vsc_tpu.ops.pyramid_pallas import pyramid_fill_below as j_pyr
    q = _quarter(b, h, w, seed=h * w)
    got = pyramid_fill_below(_t(q)).numpy()
    want = np.asarray(j_pyr(jnp.asarray(q)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kmax", ["1", "3", "16", "384"])
@pytest.mark.parametrize("h,w", [(72, 136), (72, 134), (71, 133), (72, 135)])
def test_planar_coarse_fill_matches_jax(monkeypatch, h, w, kmax):
    """The port's one quarter pool and the ladder, which the port hands
    whole to its pyramid, against the JAX package's prepass routes (4x4
    kernel; 2x2 + 2x2 kernels; jnp glue at an odd side, as at 4K's W'
    11847), its jnp levels above its handoff and pyramid kernel below it,
    wherever the handoff lies (1 and 3 leave the JAX kernel only the last
    levels, 16 puts jnp levels above it here, 384 is above the quarter)."""
    from vsc_tpu.ops.inpaint import _pyramid_fill_planar_coarse
    monkeypatch.setenv("VSC_TPU_SBS", "planar")
    monkeypatch.setenv("VSC_TPU_PYR_KMAX", kmax)
    eye4 = _eye4(2, h, w, seed=h + w)
    eye4[:, :, 10:40, 20:70] = 0                  # a wide disocclusion
    got = tinp._pyramid_fill_planar_coarse(_t(eye4)).numpy()
    want = np.asarray(_pyramid_fill_planar_coarse(jnp.asarray(eye4)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _pp_out(b, h, w, seed):
    """Postprocess-like u8 planes: smooth content plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 128 + 90 * np.sin(xx / 11.0) * np.cos(yy / 5.0)
    x = base[None, None] + rng.normal(0, 12, (3, b, h, w))
    return np.clip(x, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("ratio,h,w,strength", [(3, 30, 390, 14.0),
                                                (2, 22, 300, 14.0),
                                                (4, 12, 520, 5.0),
                                                (3, 9, 129, 0.0)])
def test_finish_plain_matches_pallas(ratio, h, w, strength):
    from vsc_tpu.ops.finish_pallas import sharpen_downscale_planar as j_fin
    x = _pp_out(2, h, w, seed=ratio)
    oh, ow = h // ratio, w // ratio
    got = sharpen_downscale_planar(_t(x), ratio, strength, oh, ow).numpy()
    want = np.asarray(j_fin(jnp.asarray(x), ratio, strength, oh, ow))
    diff = np.abs(got.astype(int) - want.astype(int))
    # the JAX kernel sums the box by matmul (its own order), so a value on
    # an integer can floor either way: <= 1 code on < 0.1 % of pixels
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(),
                                                          (diff > 0).mean())


def test_finish_crops_each_eye_at_its_offset():
    """The pair form reads the uncropped planes at (lo, ro); JAX crops
    first."""
    from vsc_tpu.ops.finish_pallas import sharpen_downscale_planar as j_fin
    x = _pp_out(4, 24, 420, seed=5)
    lo, ro, crop_w = 30, 6, 390
    got = sharpen_downscale_planar(_t(x), 3, 14.0, 8, 130, crop_w,
                                   (lo, ro)).numpy()
    cropped = np.concatenate([x[:, :2, :, lo:lo + crop_w],
                              x[:, 2:, :, ro:ro + crop_w]], axis=1)
    want = np.asarray(j_fin(jnp.asarray(cropped), 3, 14.0, 8, 130))
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("offsets", [(7, 2), (1, 10)])
@pytest.mark.parametrize("ratio,h,w", [(2, 22, 301), (3, 31, 421),
                                       (4, 17, 555)])
def test_finish_odd_unequal_offsets_match_pallas(ratio, h, w, offsets):
    """Each eye at its own odd or even offset, rows of odd widths, a box
    grid that leaves crop rows and columns over; JAX crops first."""
    from vsc_tpu.ops.finish_pallas import sharpen_downscale_planar as j_fin
    x = _pp_out(4, h, w, seed=ratio + offsets[0])
    lo, ro = offsets
    crop_w = w - max(lo, ro)
    oh, ow = h // ratio, crop_w // ratio
    got = sharpen_downscale_planar(_t(x), ratio, 14.0, oh, ow, crop_w,
                                   (lo, ro)).numpy()
    cropped = np.concatenate([x[:, :2, :, lo:lo + crop_w],
                              x[:, 2:, :, ro:ro + crop_w]], axis=1)
    want = np.asarray(j_fin(jnp.asarray(cropped), ratio, 14.0, oh, ow))
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(),
                                                          (diff > 0).mean())


@pytest.mark.parametrize("h,w", [(27, 300), (12, 96)])
def test_finish_f32_entry_matches_pallas(h, w):
    """The compat branch's entry; 12 x 96 takes the JAX glue (W < 129)."""
    from vsc_tpu.ops.finish_pallas import sharpen_downscale as j_fin
    img = np.moveaxis(_pp_out(2, h, w, seed=w), 0, -1).astype(np.float32)
    got = sharpen_downscale(_t(img), 3, 14.0, h // 3, w // 3).numpy()
    want = np.asarray(j_fin(jnp.asarray(img), 3, 14.0, h // 3, w // 3))
    assert got.shape == want.shape == (2, h // 3, w // 3, 3)
    np.testing.assert_allclose(got, want, atol=1e-2)


@pytest.mark.parametrize("max_disp", [4.0, 9.7])
def test_planar_warp_plain_matches_pallas(max_disp):
    from vsc_tpu.ops.warp_pallas import forward_warp_stereo_pallas_planar_u8
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (2, 3, 24, 96)).astype(np.uint8)
    depth = rng.random((2, 24, 96)).astype(np.float32)
    depth = (depth + np.roll(depth, 1, 1) + np.roll(depth, 1, 2)) / 3.0
    got = forward_warp_eyes_planar(_t(img), _t(depth), max_disp)
    want = forward_warp_stereo_pallas_planar_u8(jnp.asarray(img),
                                                jnp.asarray(depth), max_disp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
