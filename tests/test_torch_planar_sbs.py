"""The port's generate_sbs on the CPU (every kernel replaced by its plain
version) against the JAX generate_sbs with its planar-u8 Pallas kernels in
interpret mode (VSC_TPU_SBS=planar), on the hardware SSIM gate's four
parameter sets (scripts/check_hw_ssim.py) scaled from 1920 to 128 columns,
plus super_sampling 2 and a frame small enough for both packages to take
the compat branch."""

import numpy as np
import pytest
import torch

import oracle
from vsc_tpu.config import StereoParams
from vsc_tpu_torch.ops import stereo as tst

H, W = 72, 128
S = W / 1920


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


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
    return rgb[None], (depth * 255).astype(np.uint8)[None], noise[None]


CASES = {
    # the gate's sets: lo < ro, lo > ro, the compat branch, all-holes depth
    "default": (StereoParams(max_disparity=50 * S, convergence=-10 * S),
                "smooth"),
    "conv+25_ss3": (StereoParams(max_disparity=50 * S, convergence=25 * S),
                    "smooth"),
    "conv+10_ss1": (StereoParams(max_disparity=50 * S, convergence=10 * S,
                                 super_sampling=1.0), "smooth"),
    "noise_depth": (StereoParams(max_disparity=50 * S, convergence=-10 * S),
                    "noise"),
    # W' = 270: even, not a multiple of 4 (the two-level pool prepass)
    "ss2": (StereoParams(max_disparity=50 * S, convergence=-10 * S,
                         super_sampling=2.0), "smooth"),
}


def _jax_sbs(monkeypatch, rgb, depth, params):
    """JAX's generate_sbs with the structure it takes on the TPU: the
    planar-u8 kernels, and the Pallas blur, warp and postprocess in the
    compat branch."""
    from vsc_tpu.ops import stereo
    for knob in ("VSC_TPU_BLUR", "VSC_TPU_WARP", "VSC_TPU_POSTPROCESS"):
        monkeypatch.setenv(knob, "pallas")
    monkeypatch.setenv("VSC_TPU_SBS", "planar")
    stereo._generate_sbs_impl.clear_cache()
    try:
        return np.asarray(stereo.generate_sbs(rgb, depth, params))
    finally:
        stereo._generate_sbs_impl.clear_cache()


def _check(got, want, w):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    # tests/test_stereo_planar_u8.py's thresholds
    assert float(diff.mean()) < 0.05, diff.mean()
    assert float((diff > 1).mean()) < 0.005, (diff > 1).mean()
    assert int(diff.max()) <= 16, diff.max()
    for i in range(got.shape[0]):
        for eye in (slice(0, w), slice(w, 2 * w)):
            s = oracle.ssim(got[i, :, eye], want[i, :, eye])
            assert s >= 0.99, (i, eye, s)


@pytest.mark.parametrize("name", list(CASES))
def test_generate_sbs_matches_jax_planar(monkeypatch, name):
    params, kind = CASES[name]
    rgb, depth, noise = _content(H, W, seed=len(name))
    depth = noise if kind == "noise" else depth
    s = tst.sbs_shapes(H, W, params)
    assert tst._planar_u8_geometry_ok(s, params) == (params.super_sampling
                                                     > 1)
    got = tst.generate_sbs(_t(rgb), _t(depth), params).numpy()
    _check(got, _jax_sbs(monkeypatch, rgb, depth, params), W)


def test_tiny_frame_takes_the_compat_branch(monkeypatch):
    """24 x 48 at super_sampling 2: crop_w 96 < 129, so both packages run
    the compat branch (the finish's f32 entry then takes its glue)."""
    params = StereoParams(max_disparity=6.0, convergence=-2.0,
                          super_sampling=2.0, edge_softness=3.0,
                          artifact_smoothing=1.0, depth_gamma=0.2,
                          sharpen=10.0)
    rgb, depth, _ = _content(24, 48, seed=1)
    assert not tst._planar_u8_geometry_ok(tst.sbs_shapes(24, 48, params),
                                          params)
    got = tst.generate_sbs(_t(rgb), _t(depth), params).numpy()
    _check(got, _jax_sbs(monkeypatch, rgb, depth, params), 48)
