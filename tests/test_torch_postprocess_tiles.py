"""The invariants the postprocess kernel's tiles rest on, held on the plain
version (``postprocess_eye_plain``) on the CPU:

  - a pixel whose in-image 3x3 neighbours are all valid outputs its rounded
    bilateral, whatever the quarter-resolution estimate holds: a tile with
    no hole within 1 of it takes that fast path;
  - the output at a pixel does not move when colors or valid flags farther
    than the margin M from it change: a tile plus a halo of 9 (colors read
    to 9 + rb, valid flags to 10) holds every dependency of its output;
  - ``hole_tiles``, the kernel's test of which tiles take the hole path,
    against a loop over the tiles.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vsc_tpu_torch.ops.postprocess_cuda import (TILE_H, TILE_W, _margin,
                                                bilateral_plain, hole_tiles,
                                                postprocess_eye_plain)

SMOOTHINGS = [0.0, 0.5, 1.0, 2.5, 4.0]


def _inputs(rng, b, h, w, holes):
    rgb = rng.integers(0, 256, (3, b, h, w))
    valid = (rng.random((b, h, w)) > holes).astype(np.int64)
    eye4 = np.concatenate([rgb * valid, valid[None]]).astype(np.uint8)
    hq, wq = (h + 3) // 4, (w + 3) // 4
    smooth_q = rng.random((3, b, hq, wq)).astype(np.float32) * 255
    return torch.from_numpy(eye4), torch.from_numpy(smooth_q)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), h=st.integers(1, 24),
       w=st.integers(1, 24), holes=st.sampled_from([0.0, 0.02, 0.1, 0.4]),
       smoothing=st.sampled_from(SMOOTHINGS))
def test_pixels_without_nearby_holes_output_their_bilateral(
        seed, h, w, holes, smoothing):
    rng = np.random.default_rng(seed)
    eye4, smooth_q = _inputs(rng, 1, h, w, holes)
    got = postprocess_eye_plain(eye4, smooth_q, smoothing)
    want = eye4[:3].to(torch.float32)
    if smoothing > 0:
        want = bilateral_plain(want, smoothing)
    want = torch.round(torch.clamp(want, 0.0, 255.0)).to(torch.uint8)
    # in-image 3x3 neighbourhood all valid (outside the image counts as valid)
    hole = (eye4[3] == 0).to(torch.float32)[:, None]
    near = torch.nn.functional.max_pool2d(hole, 3, stride=1, padding=1)[:, 0]
    clean = (near == 0)[None].expand_as(got)
    assert torch.equal(got[clean], want[clean])
    # and another quarter-resolution estimate changes nothing there
    other = postprocess_eye_plain(eye4, smooth_q * 0.5 + 7.0, smoothing)
    assert torch.equal(other[clean], got[clean])


@pytest.mark.parametrize("smoothing", [0.0, 1.0, 4.0])
@pytest.mark.parametrize("py,px", [(20, 21), (2, 37), (39, 0)])
def test_output_ignores_inputs_beyond_the_margin(smoothing, py, px):
    H = W = 40
    M = _margin(smoothing)
    rng = np.random.default_rng(py * 100 + px)
    eye4, smooth_q = _inputs(rng, 1, H, W, 0.25)
    eye4[3, 0, max(py - 3, 0):py + 4, max(px - 3, 0):px + 4] = 0   # a hole
    eye4[:3] *= (eye4[3] > 0)[None]
    base = postprocess_eye_plain(eye4, smooth_q, smoothing)[:, 0, py, px]
    yy = torch.arange(H)[:, None]
    xx = torch.arange(W)[None, :]
    far = torch.maximum((yy - py).abs(), (xx - px).abs()) > M
    assert bool(far.any())
    for trial in range(3):
        other, _ = _inputs(np.random.default_rng(trial), 1, H, W, 0.5)
        changed = torch.where(far[None, None], other, eye4)
        got = postprocess_eye_plain(changed, smooth_q, smoothing)
        assert torch.equal(got[:, 0, py, px], base)


@pytest.mark.parametrize("b,h,w,holes", [
    (2, 3 * TILE_H + 5, 4 * TILE_W - 3, 0.002), (1, TILE_H, TILE_W, 0.0),
    (1, 7, 5, 0.3), (3, 2 * TILE_H, 3 * TILE_W + 1, 0.0005)])
def test_hole_tiles_matches_a_loop(b, h, w, holes):
    rng = np.random.default_rng(h * w)
    valid = (rng.random((b, h, w)) > holes).astype(np.uint8)
    got = hole_tiles(torch.from_numpy(valid)).numpy()
    nty, ntx = -(-h // TILE_H), -(-w // TILE_W)
    want = np.zeros((b, nty, ntx), dtype=bool)
    for n in range(b):
        for ty in range(nty):
            for tx in range(ntx):
                y0, x0 = ty * TILE_H, tx * TILE_W
                box = valid[n, max(y0 - 1, 0):y0 + TILE_H + 1,
                            max(x0 - 1, 0):x0 + TILE_W + 1]
                want[n, ty, tx] = bool((box == 0).any())
    assert got.shape == want.shape
    assert np.array_equal(got, want)
