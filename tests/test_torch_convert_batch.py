"""``pipeline/stream_convert.convert_batch``, the convert path's batch step,
on the CPU: a padded host batch through ``render_sbs`` comes back as its
real frames' SBS, and a dispatch past its deadline raises the exit-100
``AccelFailure``."""

import threading
import time

import numpy as np
import pytest
import torch

from vsc_tpu_torch.config import StereoParams
from vsc_tpu_torch.pipeline import stream_convert
from vsc_tpu_torch.pipeline.depth_map_generator import build_depth_fn

H, W = 36, 64


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)


def test_convert_batch_returns_the_real_frames_sbs():
    real = _frames(3)
    padded = np.concatenate([real, real[-1:]])      # the dispatch shape, 4
    depth_fn = build_depth_fn("stub", 96, H, W, False, device="cpu")
    params = StereoParams(super_sampling=1.0)
    got = stream_convert.convert_batch(padded, 3, depth_fn, params, "cpu",
                                       deadline=600.0)
    want = stream_convert.render_sbs(torch.from_numpy(padded), depth_fn,
                                     params)[:3].numpy()
    assert isinstance(got, np.ndarray)
    assert got.dtype == np.uint8 and got.shape == (3, H, 2 * W, 3)
    np.testing.assert_array_equal(got, want)


def test_convert_batch_past_its_deadline_raises_accel_failure():
    release = threading.Event()

    def wedged_depth(rgb):
        release.wait(30)
        raise RuntimeError("released")

    start = time.monotonic()
    try:
        with pytest.raises(stream_convert.AccelFailure, match="deadline"):
            stream_convert.convert_batch(_frames(2), 2, wedged_depth,
                                         StereoParams(), "cpu", deadline=0.2)
        assert time.monotonic() - start < 10
    finally:
        release.set()
