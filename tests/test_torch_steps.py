"""The port's step workflow (vsc_tpu_torch/pipeline/{workflow_init,
frame_extractor, depth_map_generator, sbs_generator}) on the CPU, against
the JAX package's step CLIs on the tests' workflow fixture (the 36-frame
192 x 108 clip), and against the port's own streaming path:

- workflow_init writes JAX's config.json, frame_extractor JAX's frames;
- the depth step's PNGs within 1 code of JAX's depth step (stub model, and
  a small DepthPro loaded from an npz of JAX parameters);
- the SBS step at the StereoParams() defaults against JAX's SBS step on its
  Pallas kernels (interpret mode): the thresholds of
  tests/test_stereo_planar_u8.py and per-eye SSIM >= 0.99;
- the step path (depth PNG written and read back, then SBS) equal bit for
  bit to ``stream_convert.render_sbs`` on the same frames;
- the 16-bit path (uint16 TIFF depth) against JAX's;
- resume: the frame range, skip-existing, the ragged last batch, the
  free_space modes, missing depth ranges, .tif preferred over .png;
- exit code 100 when the health probe fails before the run or mid-run;
- under VSC_TPU_PROFILE_DIR a step writes its torch.profiler trace.
"""

import functools
import json
import shutil

import numpy as np
import pytest
import torch

import oracle
from vsc_tpu_torch.config import StereoParams, load_config, save_config
from vsc_tpu_torch.io.image import (read_depth, read_rgb,
                                    write_quantized_depth, write_rgb)
from vsc_tpu_torch.pipeline import depth_map_generator as tdepth
from vsc_tpu_torch.pipeline import frame_extractor as textract
from vsc_tpu_torch.pipeline import sbs_generator as tsbs

H, W = 108, 192
STUB = ["--cpu", "--model", "stub", "--input-size", "96", "--no-interactive"]
# cheap stereo settings for the resume tests (as tests/test_pipeline_e2e.py)
FAST_STEREO = {
    "max_disparity": 6.0, "convergence": -2.0, "super_sampling": 1.0,
    "edge_softness": 1.0, "artifact_smoothing": 0.0, "depth_gamma": 0.5,
    "sharpen": 2.0,
}
PALLAS_KNOBS = ("VSC_TPU_BLUR", "VSC_TPU_WARP", "VSC_TPU_POSTPROCESS")


def _set(wf, **sections):
    config = load_config(wf)
    for key, value in sections.items():
        if isinstance(value, dict):
            config[key].update(value)
        else:
            config[key] = value
    save_config(wf, config)
    return config


def _files(wf, sub, pattern="*"):
    return sorted((wf / sub).glob(pattern))


def _jax_sbs_step(wf, monkeypatch, batch_size=8):
    """JAX's SBS step on its Pallas kernels in interpret mode (the TPU
    structure the port takes on every device), as
    tests/test_torch_slice.py sets them."""
    from vsc_tpu.ops import stereo
    from vsc_tpu.pipeline import sbs_generator
    config = load_config(wf)
    for knob in PALLAS_KNOBS:
        monkeypatch.setenv(knob, "pallas")
    if config["stereo"]["super_sampling"] > 1:
        monkeypatch.setenv("VSC_TPU_SBS", "planar")
    stereo._generate_sbs_impl.clear_cache()
    try:
        assert sbs_generator.run(wf, config, batch_size=batch_size,
                                 interactive=False) == 0
    finally:
        stereo._generate_sbs_impl.clear_cache()


def _assert_sbs_close(got_files, want_files):
    """tests/test_stereo_planar_u8.py's thresholds, per-eye SSIM >= 0.99."""
    assert [f.name for f in got_files] == [f.name for f in want_files]
    got = np.stack([read_rgb(f) for f in got_files]).astype(int)
    want = np.stack([read_rgb(f) for f in want_files]).astype(int)
    assert got.shape == want.shape == (len(got_files), H, 2 * W, 3)
    diff = np.abs(got - want)
    assert float(diff.mean()) < 0.05, diff.mean()
    assert float((diff > 1).mean()) < 0.005, (diff > 1).mean()
    assert int(diff.max()) <= 16, diff.max()
    for i in range(len(got)):
        for eye in (slice(0, W), slice(W, 2 * W)):
            s = oracle.ssim(got[i, :, eye].astype(np.uint8),
                            want[i, :, eye].astype(np.uint8))
            assert s >= 0.99, (i, eye, s)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch's CPU kernels on 2 threads here: the suite runs several test
    workers on the machine's cores, and more threads a worker only wait on
    each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def frames_wf(workflow):
    """The workflow fixture with its 36 frames extracted by the port."""
    assert textract.main([str(workflow)]) == 0
    assert len(_files(workflow, "frames", "frame_*.png")) == 36
    return workflow


def test_workflow_init_and_extractor_match_jax(tmp_path, test_video):
    from vsc_tpu.pipeline import frame_extractor as jextract
    from vsc_tpu.pipeline import workflow_init as jinit
    from vsc_tpu_torch.pipeline import workflow_init as tinit
    tw, jw = tmp_path / "torch_wf", tmp_path / "jax_wf"
    assert tinit.main(["--input-video", str(test_video),
                       "--workflow-dir", str(tw)]) == 0
    assert jinit.main(["--input-video", str(test_video),
                       "--workflow-dir", str(jw)]) == 0
    assert (tw / "config.json").read_text() == (jw / "config.json").read_text()
    assert textract.main([str(tw)]) == 0
    assert jextract.main([str(jw)]) == 0
    got, want = _files(tw, "frames"), _files(jw, "frames")
    assert [f.name for f in got] == [f.name for f in want]
    assert len(got) == 36
    for g, w in zip(got, want):
        np.testing.assert_array_equal(read_rgb(g), read_rgb(w))


def test_depth_step_stub_within_one_code_of_jax(frames_wf, tmp_path):
    from vsc_tpu.pipeline import depth_map_generator as jdepth
    twin = tmp_path / "jax_wf"
    shutil.copytree(frames_wf, twin)
    # frames 1-10 at batch 8: one full batch, one ragged (padded) one
    assert tdepth.main([str(frames_wf), *STUB, "--end-frame", "10"]) == 0
    assert jdepth.run(twin, load_config(twin), end_frame=10, batch_size=8,
                      interactive=False, model_name="stub", input_size=96)
    got, want = (_files(frames_wf, "depth_maps"), _files(twin, "depth_maps"))
    assert [f.name for f in got] == [f.name for f in want]
    assert len(got) == 10
    for g, w in zip(got, want):
        dg, dw = read_depth(g), read_depth(w)
        assert dg.dtype == np.uint8 and dg.shape == (H, W)
        assert dg.min() == 0 and dg.max() == 255
        assert np.abs(dg.astype(int) - dw.astype(int)).max() <= 1, g.name


def test_depth_step_small_depthpro_within_one_code_of_jax(
        frames_wf, tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    from flax.core import meta
    from vsc_tpu.models import DepthPro as JDepthPro
    from vsc_tpu.models import DepthProConfig as JCfg
    from vsc_tpu.models import ViTConfig as JViTCfg
    from vsc_tpu.models.convert import load_params
    from vsc_tpu.ops.resize import resize
    from vsc_tpu_torch.models import (DepthPro, DepthProConfig, ViTConfig,
                                      init_flax_like)
    from vsc_tpu_torch.models.convert import jax_flat_from_state_dict
    # tests/test_torch_slice.py's small DepthPro, its weights drawn by the
    # port and saved as an npz of the JAX parameter tree
    enc = dict(img_size=32, patch_size=4, embed_dim=128, depth=4,
               num_heads=2)
    small = dict(img_size=128, tile_size=32, hook_block_ids=(0, 2),
                 decoder_features=16, dims_encoder=(16, 24, 32, 32))
    cfg = DepthProConfig(encoder=ViTConfig(**enc), use_fov_head=False,
                         **small)
    tmodel = DepthPro(cfg)
    init_flax_like(tmodel, torch.Generator().manual_seed(0))
    npz = tmp_path / "small.npz"
    np.savez(npz, **jax_flat_from_state_dict(tmodel.state_dict(), tmodel))
    model = JDepthPro(JCfg(encoder=JViTCfg(flash_attention=True, **enc),
                           use_fov_head=False, **small))
    shapes = meta.unbox(jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 128, 128, 3)))["params"])
    params = load_params(npz, jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    monkeypatch.setenv(tdepth.CHECKPOINT_ENV, str(npz))
    monkeypatch.setattr(tdepth, "build_depth_fn", functools.partial(
        tdepth.build_depth_fn, model_cfg=cfg))
    # frames 1-3 at batch 2: the second batch padded with frame 3
    assert tdepth.main([str(frames_wf), "--cpu", "--model", "depthpro",
                        "--end-frame", "3", "--batch-size", "2",
                        "--no-interactive"]) == 0
    got = _files(frames_wf, "depth_maps")
    assert [f.name for f in got] == [f"depth_frame_{i:06d}.png"
                                     for i in (1, 2, 3)]

    frames = np.stack([read_rgb(f) for f in
                       _files(frames_wf, "frames", "frame_*.png")[:3]])
    # vsc_tpu/pipeline/depth_map_generator.py's depth_fn_impl, same batches
    batches = [frames[:2], np.concatenate([frames[2:], frames[2:]])]

    @jax.jit
    def depth_fn_impl(p, frames_u8):
        x = resize(frames_u8.astype(jnp.float32), 128, 128, "bilinear",
                   channel_last=True) / 127.5 - 1.0
        d = model.apply({"params": p}, x)["canonical_inverse_depth"]
        d = resize(d, H, W, "bilinear")
        lo = d.min(axis=(1, 2), keepdims=True)
        hi = d.max(axis=(1, 2), keepdims=True)
        return jnp.round((d - lo) / jnp.maximum(hi - lo, 1e-12)
                         * 255.0).astype(jnp.uint8)
    want = np.concatenate([np.asarray(depth_fn_impl(params, b))
                           for b in batches])[:3]
    assert np.std(want.astype(np.float32)) > 0
    for g, w in zip(got, want):
        assert np.abs(read_depth(g).astype(int) - w.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def sbs_defaults(tmp_path_factory, test_video):
    """Frames 1-4 through the port's depth (stub) and SBS steps at the
    StereoParams() defaults (super_sampling 3) and the default free_space
    mode ("frame"); the JAX twin is copied before the SBS step."""
    from vsc_tpu_torch.config import create_default_config
    root = tmp_path_factory.mktemp("steps")
    wf = root / "workflow"
    for sub in ("frames", "depth_maps", "sbs", "chunks"):
        (wf / sub).mkdir(parents=True)
    save_config(wf, create_default_config(test_video))
    assert textract.main([str(wf)]) == 0
    assert tdepth.main([str(wf), *STUB, "--end-frame", "4"]) == 0
    twin = root / "jax_wf"
    shutil.copytree(wf, twin)
    assert tsbs.main([str(wf), "--cpu", "--batch-size", "4",
                      "--no-interactive"]) == 0
    return wf, twin


def test_sbs_step_defaults_close_to_jax(sbs_defaults, monkeypatch):
    wf, twin = sbs_defaults
    assert load_config(wf)["stereo"] == StereoParams().to_dict()
    jax_wf = twin.parent / "jax_sbs"
    shutil.copytree(twin, jax_wf)
    _jax_sbs_step(jax_wf, monkeypatch)
    _assert_sbs_close(_files(wf, "sbs"), _files(jax_wf, "sbs"))


def test_sbs_step_equals_the_stream_path(sbs_defaults):
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depth_fn
    from vsc_tpu_torch.pipeline.stream_convert import render_sbs
    wf, twin = sbs_defaults
    # the "frame" free_space mode took the four consumed frames only
    left = _files(wf, "frames", "frame_*.png")
    assert len(left) == 32 and left[0].name == "frame_000005.png"
    frames = np.stack([read_rgb(f) for f in
                       _files(twin, "frames", "frame_*.png")[:4]])
    depth_fn = build_depth_fn("stub", 96, H, W, False, device="cpu")
    want = render_sbs(torch.from_numpy(frames), depth_fn,
                      StereoParams()).numpy()
    got = _files(wf, "sbs")
    assert [f.name for f in got] == [f"sbs_{i:06d}.png" for i in range(1, 5)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(read_rgb(g), w)


def test_16bit_path_against_jax(frames_wf, tmp_path, monkeypatch):
    from vsc_tpu.pipeline import depth_map_generator as jdepth
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depth_fn
    from vsc_tpu_torch.pipeline.stream_convert import render_sbs
    _set(frames_wf, depth={"save_16bit": True},
         stereo={"super_sampling": 1.0}, free_space={
             "sbs_generator": "none", "chunk_generator": "none"})
    twin = tmp_path / "jax_wf"
    shutil.copytree(frames_wf, twin)
    assert tdepth.main([str(frames_wf), *STUB, "--end-frame", "2"]) == 0
    assert jdepth.run(twin, load_config(twin), end_frame=2, batch_size=8,
                      interactive=False, model_name="stub", input_size=96)
    got = _files(frames_wf, "depth_maps")
    assert [f.name for f in got] == [f"depth_frame_{i:06d}.tif"
                                     for i in range(1, 3)]
    for g in got:
        dg, dw = read_depth(g), read_depth(twin / "depth_maps" / g.name)
        assert dg.dtype == dw.dtype == np.uint16
        assert dg.min() == 0 and dg.max() == 65535
        assert np.abs(dg.astype(int) - dw.astype(int)).max() <= 1, g.name

    # SBS on the uint16 depth: the port's step, its stream path, and JAX's
    # SBS step on the same TIFFs
    assert tsbs.main([str(frames_wf), "--cpu", "--no-interactive"]) == 0
    params = StereoParams.from_config(load_config(frames_wf)["stereo"])
    frames = np.stack([read_rgb(f) for f in
                       _files(frames_wf, "frames", "frame_*.png")[:2]])
    depth_fn = build_depth_fn("stub", 96, H, W, True, device="cpu")
    want = render_sbs(torch.from_numpy(frames), depth_fn, params).numpy()
    got = _files(frames_wf, "sbs")
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(read_rgb(g), w)
    shutil.rmtree(twin / "depth_maps")
    shutil.copytree(frames_wf / "depth_maps", twin / "depth_maps")
    _jax_sbs_step(twin, monkeypatch)
    _assert_sbs_close(_files(frames_wf, "sbs"), _files(twin, "sbs"))


def test_depth_resume_range_and_ragged_batch(frames_wf, capsys):
    assert tdepth.main([str(frames_wf), *STUB, "--start-frame", "3",
                        "--end-frame", "7", "--batch-size", "4"]) == 0
    got = _files(frames_wf, "depth_maps")
    assert [f.name for f in got] == [f"depth_frame_{i:06d}.png"
                                     for i in range(3, 8)]
    first = {f.name: f.read_bytes() for f in got}
    # frame 7 rode alone in a batch padded with copies of itself
    lone = tdepth.build_depth_fn("stub", 96, H, W, False, device="cpu")(
        torch.from_numpy(read_rgb(frames_wf / "frames" / "frame_000007.png")
                         [None]))
    np.testing.assert_array_equal(read_depth(got[-1]), lone[0].numpy())
    capsys.readouterr()
    assert tdepth.main([str(frames_wf), *STUB, "--batch-size", "4"]) == 0
    assert "Found: 36 images, 5 already processed, 31 to process" in \
        capsys.readouterr().out
    assert len(_files(frames_wf, "depth_maps")) == 36
    assert all((frames_wf / "depth_maps" / n).read_bytes() == b
               for n, b in first.items())
    assert tdepth.main([str(frames_wf), *STUB]) == 0
    assert "All images already processed." in capsys.readouterr().out


def _small_pairs(wf, depth_for=(1, 2), n_frames=3, ext=".png"):
    rng = np.random.default_rng(5)
    for i in range(1, n_frames + 1):
        write_rgb(wf / "frames" / f"frame_{i:06d}.png",
                  rng.integers(0, 256, (H, W, 3), np.uint8))
    for i in depth_for:
        dtype = np.uint16 if ext == ".tif" else np.uint8
        write_quantized_depth(
            rng.integers(0, np.iinfo(dtype).max, (H, W), dtype),
            wf / "depth_maps" / f"depth_frame_{i:06d}{ext}")


@pytest.mark.parametrize("mode, frames_left, depth_left", [
    ("none", 3, 2), ("frame", 1, 2), ("depth", 3, 0), ("all", 1, 0)])
def test_sbs_free_space_modes_and_missing_depth(workflow, capsys, mode,
                                                frames_left, depth_left):
    _set(workflow, stereo=FAST_STEREO,
         free_space={"sbs_generator": mode, "chunk_generator": "none"})
    _small_pairs(workflow)
    assert tsbs.main([str(workflow), "--cpu", "--no-interactive"]) == 0
    out = capsys.readouterr().out
    assert ("Missing depth maps: 1 frames in range frame_000003 to "
            "frame_000003") in out
    assert len(_files(workflow, "sbs")) == 2
    assert len(_files(workflow, "frames")) == frames_left
    assert len(_files(workflow, "depth_maps")) == depth_left


def test_sbs_skip_existing_and_tif_preferred(workflow, capsys):
    _set(workflow, stereo=FAST_STEREO,
         free_space={"sbs_generator": "none", "chunk_generator": "none"})
    _small_pairs(workflow, depth_for=(1, 2, 3), ext=".tif")
    # a PNG beside frame 2's TIFF: the TIFF is the one read
    write_quantized_depth(np.zeros((H, W), np.uint8) + np.arange(
        W, dtype=np.uint8), workflow / "depth_maps" / "depth_frame_000002.png")
    sentinel = np.zeros((H, 2 * W, 3), np.uint8)
    write_rgb(workflow / "sbs" / "sbs_000001.png", sentinel)
    assert tsbs.main([str(workflow), "--cpu", "--no-interactive",
                      "--batch-size", "4"]) == 0
    assert "Found: 3 frame pairs, 1 already processed, 2 to process" in \
        capsys.readouterr().out
    np.testing.assert_array_equal(
        read_rgb(workflow / "sbs" / "sbs_000001.png"), sentinel)
    from vsc_tpu_torch.ops.stereo import generate_sbs
    params = StereoParams.from_config(load_config(workflow)["stereo"])
    rgb = read_rgb(workflow / "frames" / "frame_000002.png")
    tif = read_depth(workflow / "depth_maps" / "depth_frame_000002.tif")
    want = generate_sbs(torch.from_numpy(np.stack([rgb] * 4)),
                        torch.from_numpy(np.stack([tif] * 4)), params)
    np.testing.assert_array_equal(
        read_rgb(workflow / "sbs" / "sbs_000002.png"), want[0].numpy())
    assert tsbs.main([str(workflow), "--cpu", "--no-interactive"]) == 0
    assert "All frames already processed." in capsys.readouterr().out


@pytest.mark.parametrize("fail_at, saved", [(1, 0), (3, None)],
                         ids=["before-the-run", "mid-run"])
def test_sbs_exit_100_when_the_probe_fails(workflow, monkeypatch, fail_at,
                                           saved):
    from vsc_tpu_torch.parallel import health
    _set(workflow, stereo=FAST_STEREO,
         free_space={"sbs_generator": "none", "chunk_generator": "none"})
    _small_pairs(workflow, depth_for=(1, 2, 3))
    calls = []

    def probe(device=None, timeout=None):
        calls.append(device)
        return len(calls) < fail_at
    monkeypatch.setattr(health, "check_accelerator_health", probe)
    # one probe before the run, then one before each 1-frame dispatch
    assert tsbs.main([str(workflow), "--cpu", "--no-interactive",
                      "--batch-size", "1"]) == health.ACCEL_ERROR_EXIT_CODE
    assert len(calls) == fail_at
    assert all(d == torch.device("cpu") for d in calls)
    if saved is not None:
        assert len(_files(workflow, "sbs")) == saved


def test_profile_dir_traces_the_depth_step(frames_wf, tmp_path, monkeypatch):
    from vsc_tpu_torch.utils.profiling import PROFILE_ENV
    monkeypatch.setenv(PROFILE_ENV, str(tmp_path / "prof"))
    assert tdepth.main([str(frames_wf), *STUB, "--end-frame", "2"]) == 0
    assert [p.name for p in (tmp_path / "prof").iterdir()] == [
        "depth_map_generator"]
    traces = list((tmp_path / "prof" / "depth_map_generator").glob(
        "*/trace.json"))
    assert len(traces) == 1, traces     # one directory for the run
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("conv2d" in e.get("name", "") for e in events)
