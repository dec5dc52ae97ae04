"""The port at 2160 x 3840 against the JAX package, on the CPU.

- The 4K geometry (``sbs_shapes``, the crop offsets, the planar-u8 gate and
  the split route's refusal of W' = 11847) is the same in both packages.
- A 4K-geometry strip: one [1, 32, 3840] frame at ``StereoParams()``, whose
  columns give 4K's shapes (W' 11847, crop 11520), through the port's
  ``generate_sbs`` (every kernel's plain version) and JAX's with its
  planar-u8 Pallas kernels in interpret mode, under the gates of
  ``tests/test_torch_planar_sbs.py``.
- ``build_depth_fn`` with the stub model at out 2160 x 3840 (the 2.5x
  bilinear downscale to 1536 and the resize back), u8 and u16, within 1
  code.
- One whole 2160 x 3840 frame through both packages' ``generate_sbs``,
  marked ``slow``: the two packages take ~15 minutes and ~22 GB of memory
  on an 8-core CPU, so tier-1 (``-m 'not slow'``) leaves it out. Run it by hand with
  ``python -m pytest tests/test_torch_4k.py -m slow``.

The content is the scene plane of ``scripts/profile_sbs_4k.py`` (bench.py's
scene), copied here.
"""

import numpy as np
import pytest
import torch

from test_torch_planar_sbs import _check, _jax_sbs
from vsc_tpu.config import StereoParams as JaxParams
from vsc_tpu_torch.config.stereo_params import StereoParams
from vsc_tpu_torch.ops import stereo as tst

H4K, W4K = 2160, 3840
STRIP_ROWS = 32
STRIP_Y0 = 120     # the strip crosses the scene's block edge at row 135


def _scene(y0, rows, w, seed=0):
    """Rows [y0, y0 + rows) of the 4K scene of scripts/profile_sbs_4k.py:
    u8 rgb [1, rows, w, 3] and depth [1, rows, w]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[y0:y0 + rows, 0:w].astype(np.float32)
    base = 0.5 + 0.5 * np.sin(xx / 97.0) * np.cos(yy / 53.0)
    blocks = ((xx // 240).astype(int) % 3 == (yy // 135).astype(int) % 3)
    tex = rng.normal(0, 0.04, (rows, w)).astype(np.float32)
    plane = np.clip(base * 0.6 + blocks * 0.3 + tex, 0, 1)
    rgb = (np.stack([plane, 0.8 * plane + 0.1, 1.0 - 0.7 * plane], -1)
           * 255).astype(np.uint8)
    d = 0.45 + 0.35 * np.sin(xx / 311.0) * np.cos(yy / 173.0) + blocks * 0.15
    depth = (np.clip(d, 0, 1) * 255).astype(np.uint8)
    return rgb[None], depth[None]


# (convergence, stretched_w, up_w, W' odd): the defaults (-10, lo < ro) and
# +25 (lo > ro, an even W' that the split route takes)
GEOMETRY_CASES = {"default": (-10.0, 3949, 11847, True),
                  "conv+25": (25.0, 3964, 11892, False)}


@pytest.mark.parametrize("name", list(GEOMETRY_CASES))
def test_4k_geometry_in_both_packages(name):
    """sbs_shapes, the crop offsets, the planar-u8 gate and the split
    route's guard at 2160 x 3840 agree between the packages, and the
    strip's columns give the same geometry. At the defaults both guards
    refuse the odd W' = 11847, so the fused postprocess runs."""
    from vsc_tpu.ops import stereo as jst
    from vsc_tpu.ops.bilateral_pallas import (
        bilateral_pool_supported as jax_split_ok)
    from vsc_tpu_torch.ops.bilateral_cuda import bilateral_pool_supported
    conv, stretched_w, up_w, odd = GEOMETRY_CASES[name]
    p, jp = StereoParams(convergence=conv), JaxParams(convergence=conv)
    s = tst.sbs_shapes(H4K, W4K, p)
    assert s == jst.sbs_shapes(H4K, W4K, jp)
    assert (s["stretched_w"], s["up_h"], s["up_w"], s["crop_w"],
            s["scale_ratio"]) == (stretched_w, 6480, up_w, 11520, 3.0)
    offsets = tst._crop_offsets(H4K, W4K, p)
    assert offsets == jst._crop_offsets(H4K, W4K, jp)
    lo, ro, crop_w = offsets
    assert lo + crop_w <= up_w and ro + crop_w <= up_w
    assert (lo > ro) == (conv > 0)
    assert tst._planar_u8_geometry_ok(s, p)
    assert jst._planar_u8_geometry_ok(jst.sbs_shapes(H4K, W4K, jp), jp)
    sm = p.artifact_smoothing
    split = bilateral_pool_supported(s["up_h"], s["up_w"], sm)
    assert split == jax_split_ok(s["up_h"], s["up_w"], sm) == (not odd)
    strip = tst.sbs_shapes(STRIP_ROWS, W4K, p)
    assert (strip["stretched_w"], strip["up_w"], strip["crop_w"]) == (
        stretched_w, up_w, 11520)
    assert tst._crop_offsets(STRIP_ROWS, W4K, p) == offsets
    assert tst._planar_u8_geometry_ok(strip, p)


def test_4k_strip_matches_jax_planar(monkeypatch):
    """[1, 32, 3840] at StereoParams(): the port's CPU path against JAX's
    planar-u8 branch (Pallas in interpret mode)."""
    rgb, depth = _scene(STRIP_Y0, STRIP_ROWS, W4K)
    got = tst.generate_sbs(torch.from_numpy(rgb), torch.from_numpy(depth),
                           StereoParams()).numpy()
    assert got.shape == (1, STRIP_ROWS, 2 * W4K, 3)
    _check(got, _jax_sbs(monkeypatch, rgb, depth, JaxParams()), W4K)


@pytest.mark.parametrize("use_16bit", [False, True], ids=["u8", "u16"])
def test_4k_stub_depth_matches_jax(use_16bit):
    """build_depth_fn with the stub model at out 2160 x 3840: the bilinear
    resize to 1536 and back, min-max and quantization, in both packages,
    within 1 code."""
    from vsc_tpu.pipeline import depth_map_generator as jdepth
    from vsc_tpu_torch.pipeline import depth_map_generator as tdepth
    rgb, _ = _scene(0, H4K, W4K)
    got = tdepth.build_depth_fn("stub", 1536, H4K, W4K, use_16bit,
                                device="cpu")(torch.from_numpy(rgb)).numpy()
    want = np.asarray(jdepth.build_depth_fn("stub", 1536, H4K, W4K,
                                            use_16bit, None)(rgb))
    dtype = np.uint16 if use_16bit else np.uint8
    assert got.shape == want.shape == (1, H4K, W4K)
    assert got.dtype == want.dtype == dtype
    top = np.iinfo(dtype).max
    assert got.min() == 0 and got.max() == top
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.slow
def test_4k_whole_frame_matches_jax(monkeypatch):
    """One whole 2160 x 3840 frame at StereoParams() through both packages'
    generate_sbs, under the strip's gates."""
    rgb, depth = _scene(0, H4K, W4K)
    got = tst.generate_sbs(torch.from_numpy(rgb), torch.from_numpy(depth),
                           StereoParams()).numpy()
    assert got.shape == (1, H4K, 2 * W4K, 3)
    _check(got, _jax_sbs(monkeypatch, rgb, depth, JaxParams()), W4K)
