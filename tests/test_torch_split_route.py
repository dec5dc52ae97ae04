"""The split-bilateral route of the port (``VSC_TPU_PP_SPLIT=1``) on the CPU:
the bilateral + pool kernel's plain version against the JAX package's
``bilateral_pool_planar`` (interpret mode), the split route's SBS against
the port's default route (exact) and against the JAX package's own split
route on the hardware SSIM gate's four sets at 72 x 128 (where only
conv+25_ss3 has the even up-res width the route's guard asks for) and at
72 x 120 (where default and noise_depth have it too)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle
from vsc_tpu.config import StereoParams as JParams
from vsc_tpu_torch.config import StereoParams
from vsc_tpu_torch.ops import stereo as tst
from vsc_tpu_torch.ops.bilateral_cuda import (bilateral_pool_planar,
                                              bilateral_pool_supported,
                                              quarter_pool_plain)
from vsc_tpu_torch.ops.inpaint import _avgpool2_hw

H = 72


def _eye4(b=2, h=40, w=260, seed=0, hole_frac=0.06):
    """tests/test_bilateral_pallas.py's content: smooth colors, noise, warp
    holes with zero color, frames that differ."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 127 + 90 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
    img = np.stack([base, base * 0.6 + 30, 255 - base])
    img = np.clip(img + rng.normal(0, 12, (3, h, w)), 0, 255)
    valid = rng.random((h, w)) > hole_frac
    img = img * valid
    eye = np.concatenate([img, valid[None]], 0).astype(np.uint8)
    out = np.broadcast_to(eye[:, None], (4, b, h, w)).copy()
    out[:, 1] = np.roll(out[:, 1], 7, axis=-1)
    return out


@pytest.mark.parametrize("smoothing,h,w", [(1.0, 40, 260), (2.5, 40, 260),
                                           (1.0, 48, 250)])
def test_bilateral_pool_matches_jax_kernel(smoothing, h, w):
    from vsc_tpu.ops.bilateral_pallas import bilateral_pool_planar as jbp
    eye4 = _eye4(h=h, w=w)
    assert bilateral_pool_supported(h, w, smoothing)
    jf, jq = jbp(jnp.asarray(eye4), smoothing)
    got_f, got_q = bilateral_pool_planar(torch.from_numpy(eye4), smoothing)
    # same weight laws; the JAX kernel pairs symmetric taps (another
    # accumulation order): <= 1 code on < 0.1 % of the pixels
    diff = np.abs(got_f[:3].numpy().astype(int)
                  - np.asarray(jf)[:3].astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()
    np.testing.assert_array_equal(got_f[3].numpy(), eye4[3])
    # the quarter stack: exact, also at W/2 = 125 (odd, mid-level edge pad)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(jq))


def test_quarter_equals_the_pool_ladder():
    eye4 = torch.from_numpy(_eye4(h=48, w=250))
    msk = eye4[3].float()
    lvl = _avgpool2_hw(torch.cat([eye4[:3].float() * msk, msk[None]]))
    lvl = torch.cat([lvl, lvl[..., -1:]], dim=-1)   # W/2 odd
    assert torch.equal(quarter_pool_plain(eye4), _avgpool2_hw(lvl))
    filt, q = bilateral_pool_planar(eye4, 1.0, pool=False)
    assert q is None and filt.shape == eye4.shape


def test_supported_guard_is_the_jax_guard():
    from vsc_tpu.ops.bilateral_pallas import bilateral_pool_supported as jg
    for h, w, s in [(3240, 6090, 1.0), (40, 260, 0.0), (42, 260, 1.0),
                    (40, 259, 1.0), (8, 260, 2.5), (40, 128, 1.0),
                    (216, 426, 1.0)]:
        assert bilateral_pool_supported(h, w, s) == jg(h, w, s), (h, w, s)


@pytest.mark.parametrize("smoothing", [1.0, 2.5])
def test_split_postprocess_equals_fused_at_the_borders(smoothing):
    """Holes along every border: the fused postprocess's margin (the
    bilateral of the image pixel each margin pixel reflects) and the split
    route's (the reflected filtered image) must agree exactly."""
    from vsc_tpu_torch.ops.inpaint import _pyramid_fill_planar_coarse
    from vsc_tpu_torch.ops.postprocess_cuda import postprocess_eye
    eye4 = _eye4(h=40, w=260, hole_frac=0.3)
    for sl in (np.s_[..., :3], np.s_[..., -3:], np.s_[..., :3, :],
               np.s_[..., -3:, :]):
        eye4[3][sl] = 0
    eye4[:3] *= eye4[3][None]
    pair = torch.from_numpy(eye4)
    smooth_q = _pyramid_fill_planar_coarse(pair)
    filt, quarter = bilateral_pool_planar(pair, smoothing)
    assert torch.equal(_pyramid_fill_planar_coarse(None, quarter4=quarter),
                       smooth_q)
    assert torch.equal(postprocess_eye(filt, smooth_q, 0.0),
                       postprocess_eye(pair, smooth_q, smoothing))


@pytest.mark.parametrize("seed", [24, 37, 38])
def test_margin_is_the_reflected_filtered_image(seed):
    """The fused postprocess's stage 1 over the margin equals the split
    route's (the filtered image, reflected). Filtering around each margin
    pixel on the reflected raw image sums the same taps in mirrored order,
    which on these seeds rounds one margin value differently."""
    from vsc_tpu_torch.ops.postprocess_cuda import (bilateral_geometry,
                                                    margin_chans)
    rng = np.random.default_rng(seed)
    rgb = np.floor(rng.random((3, 4, 40, 260)) * 256)
    eye4 = torch.from_numpy(np.concatenate(
        [rgb, np.ones((1, 4, 40, 260))]).astype(np.uint8))
    filt, _ = bilateral_pool_planar(eye4, 1.0, pool=False)
    rb, _ = bilateral_geometry(1.0)
    fused = margin_chans(eye4, 1.0)[..., rb:-rb, rb:-rb]
    assert torch.equal(fused, margin_chans(filt, 0.0))


def _content(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.5 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    rgb = np.stack([base, 0.7 * base + 0.2, 1.0 - base], -1) * 255
    rgb[h // 4:h // 2, w // 4:w // 2] = 235.0
    rgb = np.clip(rgb + rng.normal(0, 6, rgb.shape), 0, 255).astype(np.uint8)
    depth = np.clip(0.5 + 0.4 * np.sin(xx / 17.0) + 0.2 * (xx > w // 2)
                    + rng.normal(0, 0.02, (h, w)), 0, 1)
    noise = rng.integers(0, 256, (h, w)).astype(np.uint8)
    return (np.stack([rgb, rgb[:, ::-1]]),
            np.stack([(depth * 255).astype(np.uint8)] * 2),
            np.stack([noise, noise[::-1]]))


# the hardware SSIM gate's sets (scripts/check_hw_ssim.py), disparity and
# convergence at 1920 columns: lo < ro, lo > ro, the compat branch (no split
# route there), all-holes depth
GATE = {
    "default": (dict(max_disparity=50, convergence=-10), "smooth"),
    "conv+25_ss3": (dict(max_disparity=50, convergence=25), "smooth"),
    "conv+10_ss1": (dict(max_disparity=50, convergence=10,
                         super_sampling=1.0), "smooth"),
    "noise_depth": (dict(max_disparity=50, convergence=-10), "noise"),
}


def _inputs(name, w):
    """The set's params scaled from 1920 to w columns, and its frames."""
    kw, kind = GATE[name]
    kw = dict(kw, max_disparity=kw["max_disparity"] * w / 1920,
              convergence=kw["convergence"] * w / 1920)
    rgb, depth, noise = _content(H, w, seed=len(name))
    return kw, rgb, (noise if kind == "noise" else depth)


def _takes_split(w, params):
    s = tst.sbs_shapes(H, w, params)
    return (params.super_sampling > 1 and bilateral_pool_supported(
        s["up_h"], s["up_w"], params.artifact_smoothing))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name,w,smoothing", [
    ("default", 120, 1.0), ("conv+25_ss3", 128, 1.0),
    ("noise_depth", 120, 1.0), ("default", 120, 2.5)])
def test_split_route_equals_default_route(monkeypatch, name, w, smoothing):
    kw, rgb, depth = _inputs(name, w)
    params = StereoParams(artifact_smoothing=smoothing, **kw)
    assert _takes_split(w, params)
    monkeypatch.setenv("VSC_TPU_PP_SPLIT", "0")
    fused = tst.generate_sbs(_t(rgb), _t(depth), params)
    monkeypatch.setenv("VSC_TPU_PP_SPLIT", "1")
    split = tst.generate_sbs(_t(rgb), _t(depth), params)
    monkeypatch.setenv("VSC_TPU_BF_POOL", "0")
    split_pools = tst.generate_sbs(_t(rgb), _t(depth), params)
    assert torch.equal(split, fused)
    assert torch.equal(split_pools, fused)


@pytest.mark.parametrize("name,w", [(n, 128) for n in GATE]
                         + [("default", 120), ("noise_depth", 120)])
def test_split_route_matches_jax_split_route(monkeypatch, name, w):
    from vsc_tpu.ops import stereo
    kw, rgb, depth = _inputs(name, w)
    assert _takes_split(w, StereoParams(**kw)) == (
        name == "conv+25_ss3" or w == 120)
    monkeypatch.setenv("VSC_TPU_PP_SPLIT", "1")
    got = tst.generate_sbs(_t(rgb), _t(depth), StereoParams(**kw)).numpy()
    for knob in ("VSC_TPU_BLUR", "VSC_TPU_WARP", "VSC_TPU_POSTPROCESS"):
        monkeypatch.setenv(knob, "pallas")
    monkeypatch.setenv("VSC_TPU_SBS", "planar")
    stereo._generate_sbs_impl.clear_cache()
    try:
        want = np.asarray(stereo.generate_sbs(rgb, depth, JParams(**kw)))
    finally:
        stereo._generate_sbs_impl.clear_cache()
    assert got.shape == want.shape == (2, H, 2 * w, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert int(diff.max()) <= 1, diff.max()
    for i in range(2):
        for eye in (slice(0, w), slice(w, 2 * w)):
            s = oracle.ssim(got[i, :, eye], want[i, :, eye])
            assert s >= 0.99, (i, eye, s)
