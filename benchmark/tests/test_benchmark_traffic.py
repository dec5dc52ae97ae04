"""The traffic generators: deterministic per seed, different between
seeds, and the frozen recipe equal to the program's."""

import json

import numpy as np
import pytest
import torch

from frozen.content import bench_content, content_pool
from lib.spec import BENCH_DIR, load_benchmark, load_entry, resolve

preview_schedule = load_entry("render_params").schedule

SEEDS = (0, 7, 2**31 + 11, 3_999_999_999)


@pytest.mark.parametrize("seed", SEEDS)
def test_content_pool_repeats_per_seed(seed):
    a = content_pool(3, 24, 40, seed, 4.0, "cpu")
    b = content_pool(3, 24, 40, seed, 4.0, "cpu")
    for x, y in zip(a, b):
        assert x.dtype == np.uint8 and np.array_equal(x, y)
    assert a[0].shape == (3, 24, 40, 3) and a[1].shape == (3, 24, 40)


def test_content_pool_differs_between_seeds_and_frames():
    f1, d1 = content_pool(2, 24, 40, 1, 4.0, "cpu")
    f2, d2 = content_pool(2, 24, 40, 2, 4.0, "cpu")
    assert not np.array_equal(f1, f2) and not np.array_equal(d1, d2)
    assert not np.array_equal(f1[0], f1[1])     # the pan moves the scene


def test_frozen_recipe_equals_the_programs():
    from vsc_tpu_torch.bench import bench_content as program
    for got, want in zip(bench_content(54, 96), program(54, 96)):
        assert np.array_equal(got, want)


def test_preview_schedule_repeats_per_seed_and_moves_one_slider():
    mix = json.loads((BENCH_DIR / "traffic" / "preview.json").read_text())
    a = preview_schedule(mix, 5, 16, 200)
    assert a == preview_schedule(mix, 5, 16, 200)
    assert a != preview_schedule(mix, 6, 16, 200)
    ranges = {s[0]: s[1:] for s in mix["sliders"]}
    prev = dict(mix["start"])
    for i, (frame, values) in enumerate(a):
        assert 0 <= frame < 16
        assert values["super_sampling"] == 3.0
        moved = [k for k in values if values[k] != prev[k]]
        assert len(moved) <= 1
        for k in moved:
            lo, hi, scale = ranges[k]
            assert lo * scale - 1e-9 <= values[k] <= hi * scale + 1e-9
        prev = values
        if i % mix["frame_every"]:
            assert frame == a[i - 1][0]


@pytest.mark.parametrize("cell", ["dp1080-convert", "dp1080-rerender"])
def test_batch_mixes_name_their_pool(cell):
    c = resolve(load_benchmark(), cell)
    batch = c.mix.get("batch") or c.config["batch"]
    pool = c.mix.get("pool_frames") or c.mix["pool_batches"] * batch
    assert pool % batch == 0 and pool // batch >= 2
    assert torch.Generator is not None
