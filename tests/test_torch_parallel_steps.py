"""The port's sharded entry points as a user runs them, on the CPU: the
dry run (vsc_tpu_torch/parallel/dryrun.py, the counterpart of
``__graft_entry__.dryrun_multichip``) over two gloo processes, and the
step CLIs on a 2-shard CPU mesh (the default data mesh replaced by the CPU
named twice, as a host with two cards gives it) against their one-device
runs, bit for bit."""

import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vsc_tpu_torch.parallel import auto, make_mesh

REPO = Path(__file__).resolve().parents[1]
H, W = 54, 96


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_dryrun_over_two_gloo_processes():
    """The dry run (the small DepthPro on a (4 data x 2 model) mesh with
    seq_shard, then both SBS parameter sets) as two processes over gloo on
    the CPU, each on its slice of the batch, checked against the unsharded
    run in process 0."""
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get(
                   "PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "vsc_tpu_torch.parallel.dryrun", "8",
         "--processes", "2", "--timeout", "50"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ok = [ln for ln in proc.stdout.splitlines()
          if ln.startswith("dryrun_multichip OK:")]
    assert len(ok) == 1, proc.stdout
    assert "mesh=(4 data x 2 model) over 2 process(es)" in ok[0]


@pytest.fixture()
def two_shards(monkeypatch):
    """The default data mesh replaced by two data rows on the CPU, as a
    host with two cards would give the step CLIs; the health probe records
    the devices it is asked about."""
    mesh = make_mesh(2, 1, devices=[torch.device("cpu")] * 2)
    monkeypatch.setattr(auto, "_data_mesh", lambda: mesh)
    from vsc_tpu_torch.parallel import health
    probed = []
    real = health.check_accelerator_health

    def probe(device=None, timeout=None):
        probed.append(torch.device(device))
        return real(device, timeout)
    monkeypatch.setattr(health, "check_accelerator_health", probe)
    return mesh, probed


def _pngs(wf, sub):
    from vsc_tpu_torch.io.image import read_rgb
    files = sorted((wf / sub).glob("*.png"))
    return [f.name for f in files], [read_rgb(f) for f in files]


def _frames_wf(workflow, n):
    from vsc_tpu_torch.io.image import write_rgb
    rng = np.random.default_rng(7)
    for i in range(1, n + 1):
        img = rng.integers(0, 256, (H, W, 3), np.uint8)
        img[:, :W // 2] //= 2                   # depth the stub can see
        write_rgb(workflow / "frames" / f"frame_{i:06d}.png", img)
    return workflow


def test_depth_and_sbs_steps_on_two_shards_equal_one_device(
        workflow, tmp_path, two_shards, monkeypatch):
    """The depth step (stub model; batch 3 padded to 4 for two shards) and
    the SBS step at the StereoParams() defaults (batch 3) write the same
    8-bit PNGs on a 2-shard mesh as on one device; the probe runs on the
    mesh's one distinct device before the run and each dispatch."""
    from vsc_tpu_torch.config import load_config, save_config
    from vsc_tpu_torch.pipeline import depth_map_generator as tdepth
    from vsc_tpu_torch.pipeline import sbs_generator as tsbs
    wf = _frames_wf(workflow, 5)
    config = load_config(wf)
    config["free_space"]["sbs_generator"] = "none"
    save_config(wf, config)
    one = tmp_path / "one_device"
    shutil.copytree(wf, one)
    argv = ["--cpu", "--no-interactive", "--batch-size", "3"]

    with monkeypatch.context() as m:          # the one-device runs
        m.setattr(auto, "_data_mesh", lambda: None)
        assert tdepth.main([str(one), "--model", "stub", *argv]) == 0
        assert tsbs.main([str(one), *argv]) == 0
    mesh, probed = two_shards
    probed.clear()
    assert auto.device_count("cpu") == 2
    assert tdepth.main([str(wf), "--model", "stub", *argv]) == 0
    assert tsbs.main([str(wf), *argv]) == 0
    assert probed == [torch.device("cpu")] * 3   # the run, 2 dispatches
    for sub, n in (("depth_maps", 5), ("sbs", 5)):
        names, got = _pngs(wf, sub)
        want_names, want = _pngs(one, sub)
        assert names == want_names and len(names) == n
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert got[0].shape == (H, 2 * W, 3)


def test_depth_step_small_depthpro_on_two_shards(workflow, tmp_path,
                                                 two_shards, monkeypatch):
    """A small DepthPro (tests/test_torch_models.py's config, its seeded
    weights as an npz of the JAX tree, as tests/test_torch_steps.py loads
    it) in the depth step: the 2-shard mesh keeps one replica (one device,
    named twice) and writes the one-device run's PNGs."""
    from vsc_tpu_torch.models import (DepthPro, DepthProConfig, ViTConfig,
                                      init_flax_like)
    from vsc_tpu_torch.models.convert import jax_flat_from_state_dict
    from vsc_tpu_torch.pipeline import depth_map_generator as tdepth
    cfg = DepthProConfig(img_size=128, tile_size=32, hook_block_ids=(0, 2),
                         decoder_features=16, dims_encoder=(16, 24, 32, 32),
                         encoder=ViTConfig(img_size=32, patch_size=4,
                                           embed_dim=128, depth=4,
                                           num_heads=2), use_fov_head=False)
    tmodel = DepthPro(cfg)
    init_flax_like(tmodel, torch.Generator().manual_seed(0))
    npz = tmp_path / "small.npz"
    np.savez(npz, **jax_flat_from_state_dict(tmodel.state_dict(), tmodel))
    monkeypatch.setenv(tdepth.CHECKPOINT_ENV, str(npz))
    meshes = []

    def build(*a, **k):
        meshes.append(k.get("mesh"))
        return functools.partial(real, model_cfg=cfg)(*a, **k)
    real = tdepth.build_depth_fn
    monkeypatch.setattr(tdepth, "build_depth_fn", build)
    wf = _frames_wf(workflow, 2)
    one = tmp_path / "one_device"
    shutil.copytree(wf, one)
    argv = ["--cpu", "--no-interactive", "--batch-size", "2", "--model",
            "depthpro"]
    with monkeypatch.context() as m:
        m.setattr(auto, "_data_mesh", lambda: None)
        assert tdepth.main([str(one), *argv]) == 0
    assert tdepth.main([str(wf), *argv]) == 0
    assert meshes == [None, two_shards[0]]
    names, got = _pngs(wf, "depth_maps")
    want_names, want = _pngs(one, "depth_maps")
    assert names == want_names and len(names) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].std() > 0


def test_stream_convert_on_two_shards_equals_one_device(workflow, tmp_path,
                                                        two_shards,
                                                        monkeypatch):
    """stream_convert.run --cpu (stub depth, tests/test_torch_slice.py's
    stereo settings; batch 3, a dispatch of 4 on two shards) encodes the
    same chunks, decoded frame for frame, as its one-device run."""
    from vsc_tpu_torch.config import get_path, load_config, save_config
    from vsc_tpu_torch.io.media import decode_frames
    from vsc_tpu_torch.native import vscmedia_path
    from vsc_tpu_torch.pipeline import stream_convert
    if vscmedia_path() is None:
        pytest.skip("native media engine unavailable")
    config = load_config(workflow)
    config["stereo"].update(super_sampling=1.0, max_disparity=5.0,
                            convergence=0.0, edge_softness=1.0)
    config["encoding"] = {"crf": 30, "preset": "ultrafast"}
    save_config(workflow, config)
    one = tmp_path / "one_device"
    shutil.copytree(workflow, one)
    argv = ["--cpu", "--model", "stub", "--input-size", "96",
            "--batch-size", "3", "--chunk-size", "20", "--no-concat"]
    with monkeypatch.context() as m:          # the one-device run
        m.setattr(auto, "_data_mesh", lambda: None)
        assert stream_convert.main([str(one), *argv]) == 0
    assert auto.device_count("cpu") == 2
    assert stream_convert.main([str(workflow), *argv]) == 0

    def decoded(wf):
        chunks = sorted(get_path(wf, load_config(wf), "chunks").glob("*.mkv"))
        return [c.name for c in chunks], [list(decode_frames(c, 384, 108))
                                          for c in chunks]
    names, got = decoded(workflow)
    want_names, want = decoded(one)
    assert names == want_names == ["sbs_000001_000020.mkv",
                                   "sbs_000020_000036.mkv"]
    assert [len(c) for c in got] == [len(c) for c in want] == [20, 17]
    assert got == want
