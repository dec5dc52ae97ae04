"""The port's streaming slice against the JAX package, on the CPU:
(a) the device work of one batch (small DepthPro + SBS at super_sampling 1,
the compat branch, and 3, the default planar-u8 branch) against the JAX
composition with its Pallas kernels in interpret mode;
(b) the port's stream_convert CLI on the workflow fixture."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

import oracle
from vsc_tpu.config import StereoParams
from vsc_tpu.models import DepthPro as JDepthPro
from vsc_tpu.models import DepthProConfig as JCfg
from vsc_tpu.models import ViTConfig as JViTCfg
from vsc_tpu.models.convert import save_params
from vsc_tpu_torch.models import DepthProConfig, ViTConfig
from vsc_tpu_torch.pipeline.depth_map_generator import build_depth_fn
from vsc_tpu_torch.pipeline.stream_convert import render_sbs

ENC = dict(img_size=32, patch_size=4, embed_dim=128, depth=4, num_heads=2)
SMALL = dict(img_size=128, tile_size=32, hook_block_ids=(0, 2),
             decoder_features=16, dims_encoder=(16, 24, 32, 32))
H, W = 72, 128
# 1080p defaults with disparity and convergence scaled from 1920 to W


def _params(super_sampling):
    return StereoParams(max_disparity=50.0 * W / 1920,
                        convergence=-10.0 * W / 1920,
                        super_sampling=super_sampling)


def _frames(b=2, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for i in range(b):
        base = 0.5 + 0.5 * np.sin(xx / (9.0 + i)) * np.cos(yy / 7.0)
        rgb = np.stack([base, 0.7 * base + 0.2, 1.0 - base], -1) * 255
        rgb[20:50, 30 + 10 * i:70 + 10 * i] = 240.0
        out.append(np.clip(rgb + rng.normal(0, 6, rgb.shape), 0, 255))
    return np.stack(out).astype(np.uint8)


def _jax_depth(model, params, frames):
    """depth_map_generator.depth_fn_impl's math with the small model."""
    from vsc_tpu.ops.resize import resize
    S = model.cfg.img_size
    x = resize(jnp.asarray(frames, jnp.float32), S, S, "bilinear",
               channel_last=True) / 127.5 - 1.0
    depth = model.apply({"params": params}, x)["canonical_inverse_depth"]
    depth = resize(depth, H, W, "bilinear")
    d_min = depth.min(axis=(1, 2), keepdims=True)
    d_max = depth.max(axis=(1, 2), keepdims=True)
    norm = (depth - d_min) / jnp.maximum(d_max - d_min, 1e-12)
    return jnp.round(norm * 255.0).astype(jnp.uint8)


@pytest.mark.parametrize("super_sampling", [1.0, 3.0])
def test_render_sbs_matches_jax_kernel_path(tmp_path, monkeypatch,
                                            super_sampling):
    from vsc_tpu.ops import stereo
    sbs_params = _params(super_sampling)
    jcfg = JCfg(encoder=JViTCfg(flash_attention=True, **ENC),
                use_fov_head=False, **SMALL)
    model = JDepthPro(jcfg)
    dummy = jnp.zeros((1, 128, 128, 3), jnp.float32)
    params = meta.unbox(model.init(jax.random.PRNGKey(0), dummy)["params"])
    npz = tmp_path / "small.npz"
    save_params(params, npz)
    frames = _frames()

    depth_fn = build_depth_fn(
        "depthpro", 128, H, W, False, str(npz), device="cpu",
        model_cfg=DepthProConfig(encoder=ViTConfig(**ENC), **SMALL))
    got_depth = depth_fn(torch.from_numpy(frames)).numpy()
    got = render_sbs(torch.from_numpy(frames), depth_fn, sbs_params).numpy()

    want_depth = _jax_depth(model, params, frames)
    for knob in ("VSC_TPU_BLUR", "VSC_TPU_WARP", "VSC_TPU_POSTPROCESS"):
        monkeypatch.setenv(knob, "pallas")
    if super_sampling > 1:
        monkeypatch.setenv("VSC_TPU_SBS", "planar")
    stereo._generate_sbs_impl.clear_cache()
    try:
        want = np.asarray(stereo.generate_sbs(frames, want_depth,
                                              sbs_params))
    finally:
        stereo._generate_sbs_impl.clear_cache()

    assert np.std(np.asarray(want_depth, np.float32)) > 0
    assert np.abs(got_depth.astype(int)
                  - np.asarray(want_depth).astype(int)).max() <= 1
    assert got.shape == want.shape == (2, H, 2 * W, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    # tests/test_stereo_planar_u8.py's thresholds
    assert float(diff.mean()) < 0.05, diff.mean()
    assert float((diff > 1).mean()) < 0.005, (diff > 1).mean()
    assert int(diff.max()) <= 16, diff.max()
    for i in range(2):
        for eye in (slice(0, W), slice(W, 2 * W)):
            s = oracle.ssim(got[i, :, eye], want[i, :, eye])
            assert s >= 0.99, (i, eye, s)


@pytest.fixture()
def media_workflow(request):
    # the port's CLI runs the port's own copy of the media engine
    from vsc_tpu_torch.native import vscmedia_path
    if vscmedia_path() is None:
        pytest.skip("native media engine unavailable")
    from vsc_tpu.config import load_config, save_config
    wf = request.getfixturevalue("workflow")
    config = load_config(wf)
    config["stereo"].update(super_sampling=1.0, max_disparity=5.0,
                            convergence=0.0, edge_softness=1.0)
    config["encoding"] = {"crf": 30, "preset": "ultrafast"}
    save_config(wf, config)
    return wf


def test_stream_convert_cli_stub(media_workflow):
    from vsc_tpu.config import get_path, load_config
    from vsc_tpu.io.probe import probe_video
    from vsc_tpu_torch.pipeline import stream_convert
    rc = stream_convert.main([str(media_workflow), "--cpu", "--model", "stub",
                              "--input-size", "96", "--batch-size", "4",
                              "--chunk-size", "20", "--no-concat"])
    assert rc == 0
    config = load_config(media_workflow)
    chunks = sorted(get_path(media_workflow, config, "chunks").glob("*.mkv"))
    # chunk_generator's naming: later chunks start at the previous end frame
    assert [c.name for c in chunks] == ["sbs_000001_000020.mkv",
                                        "sbs_000020_000036.mkv"]
    info = probe_video(chunks[0])
    assert (info["width"], info["height"]) == (384, 108)


def test_stream_convert_hang_exits_100(media_workflow, monkeypatch):
    """A dispatch that hangs surfaces as the exit-100 accelerator-failure
    contract within the dispatch deadline."""
    import time
    from vsc_tpu_torch.pipeline import depth_map_generator, stream_convert

    def hanging(*a, **k):
        return lambda rgb: time.sleep(3600)

    monkeypatch.setattr(depth_map_generator, "build_depth_fn", hanging)
    monkeypatch.setattr(stream_convert, "DISPATCH_TIMEOUT", 1.0)
    monkeypatch.setattr(stream_convert, "DISPATCH_COLD_TIMEOUT", 1.0)
    start = time.monotonic()
    rc = stream_convert.main([str(media_workflow), "--cpu", "--model", "stub",
                              "--input-size", "96", "--no-concat"])
    assert rc == 100
    assert time.monotonic() - start < 60
