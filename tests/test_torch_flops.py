"""The port's analytic work counts (vsc_tpu_torch/utils/flops.py) against
the JAX package's vsc_tpu/utils/flops.py, on the CPU: DepthPro FLOPs equal
on six configurations, the SBS roofline's bytes and vector operations
equal stage by stage on four geometry / parameter sets with each stage's
time on the card's rates, and torch's FlopCounterMode over the port's
DepthPro at tiny() within 0.1 % of the analytic count; the port's own SBS
bound, sbs_least_time, on the bytes the port's kernels read and write."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vsc_tpu.config import StereoParams as JParams
from vsc_tpu.models import DepthProConfig as JCfg
from vsc_tpu.models import ViTConfig as JViT
from vsc_tpu.utils import flops as jflops
from vsc_tpu_torch.config import StereoParams
from vsc_tpu_torch.models import DepthPro, DepthProConfig, ViTConfig
from vsc_tpu_torch.utils import flops

# name -> (DepthProConfig kwargs, ViTConfig kwargs); None: tiny()
CONFIGS = {
    "default": ({}, {}),
    "fov_head_off": ({"use_fov_head": False}, {}),
    "fov_encoder_off": ({"use_fov_encoder": False}, {}),
    "tiny": None,
    # the JAX bench's BENCH_DEPTH=flagship config (bench.py:117-124)
    "flagship": ({"img_size": 384, "tile_size": 96, "hook_block_ids": (1, 3),
                  "decoder_features": 128,
                  "dims_encoder": (128, 256, 256, 256)},
                 {"img_size": 96, "patch_size": 12, "embed_dim": 256,
                  "depth": 6, "num_heads": 8}),
    "input_2048": ({"img_size": 2048, "tile_size": 512}, {"img_size": 512}),
}


def _configs(name):
    if CONFIGS[name] is None:
        return JCfg.tiny(), DepthProConfig.tiny()
    kw, enc = CONFIGS[name]
    return (JCfg(encoder=JViT(**enc), **kw),
            DepthProConfig(encoder=ViTConfig(**enc), **kw))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_depthpro_flops_equal_jax(name):
    jcfg, cfg = _configs(name)
    for batch in (1, 3):
        assert flops.depthpro_flops(cfg, batch) == \
            jflops.depthpro_flops(jcfg, batch)
    assert flops.vit_flops(cfg.encoder, 35) == \
        jflops.vit_flops(jcfg.encoder, 35)


def test_depthpro_flops_sizes():
    """The counts the bench divides by the card's peak: 18.86 TFLOP a
    frame head off (the bench's model), 19.25 with the FOV head."""
    head_off = flops.depthpro_flops(DepthProConfig(use_fov_head=False), 1)
    head_on = flops.depthpro_flops(DepthProConfig(), 1)
    assert 18.86e12 < head_off < 18.87e12
    assert 19.24e12 < head_on < 19.25e12


# (height, width, StereoParams kwargs)
GEOMETRIES = [
    (1080, 1920, {}),
    (2160, 3840, {}),
    (1080, 1920, {"super_sampling": 1.0}),
    # every optional stage off but a 2x super-sampling, positive convergence
    (720, 1280, {"max_disparity": 30.0, "convergence": 5.0,
                 "super_sampling": 2.0, "edge_softness": 0.0,
                 "artifact_smoothing": 0.0, "depth_gamma": 1.0,
                 "sharpen": 0.0}),
]


@pytest.mark.parametrize("h,w,kw", GEOMETRIES)
def test_sbs_roofline_matches_jax_stages(h, w, kw):
    got = flops.sbs_roofline(h, w, StereoParams(**kw))
    want = jflops.sbs_roofline(h, w, JParams(**kw))
    assert list(got["stages"]) == list(want["stages"])
    total = 0.0
    for name, st in got["stages"].items():
        assert st["bytes"] == want["stages"][name]["bytes"], name
        assert st["vops"] == want["stages"][name]["vops"], name
        ms = 1e3 * max(st["bytes"] / 3.35e12, st["vops"] / 33.5e12)
        assert st["ms"] == round(ms, 3), name
        total += ms
    assert got["ms"] == round(total, 2)


def test_sbs_roofline_on_the_card_rates():
    assert flops.sbs_roofline(1080, 1920)["ms"] == 1.30
    assert flops.sbs_roofline(2160, 3840)["ms"] == 5.07
    assert flops.sbs_roofline(1080, 1920,
                              StereoParams(super_sampling=1.0))["ms"] == 0.19
    # the stages time the same work at the v5e's rates in the JAX package
    assert jflops.sbs_roofline(1080, 1920)["ms"] > \
        flops.sbs_roofline(1080, 1920)["ms"]


def _kernel_bytes(monkeypatch, h, w):
    """The bytes each kernel wrapper of the port's SBS path reads and
    writes (its tensor arguments and its result; the finish reads only
    each eye's crop) on one h x w frame at StereoParams(), on the CPU. The
    depth's bilinear upsample runs the upsample kernel on the card and the
    phase decomposition here: it is read off ``resize``."""
    from vsc_tpu_torch.ops import pool_cuda, pyramid_cuda, stereo
    seen = {}

    def nb(x):
        return x.numel() * x.element_size() if torch.is_tensor(x) else 0

    def record(module, attr, name, read=None):
        fn = getattr(module, attr)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if name is not None:
                got = (read(*args) if read else sum(map(nb, args))) + nb(out)
                seen[name] = seen.get(name, 0) + got
            return out
        monkeypatch.setattr(module, attr, wrapped)

    record(stereo, "upsample_bilinear_int", "upsample_u8")
    record(stereo, "gaussian_blur_planes", "blur")
    record(stereo, "forward_warp_pair_planar", "warp_planar_u8")
    record(stereo, "postprocess_eye", "postprocess")
    record(stereo, "sharpen_downscale_planar", "finish",
           read=lambda out, f, sh, H, W, crop_w, offs: out[..., :crop_w]
           .numel())
    record(pool_cuda, "avgpool4_eye4", "pool4_eye4")
    record(pool_cuda, "avgpool2_eye4", "pool_eye4")
    record(pool_cuda, "avgpool2", "pool_f32")
    record(pyramid_cuda, "pyramid_fill_below", "pyramid")
    resize = stereo.resize

    def resize_rec(x, *args, **kwargs):
        out = resize(x, *args, **kwargs)
        if args[2] == "bilinear" and not kwargs.get("channel_last"):
            seen["upsample_f32"] = nb(x) + nb(out)
        return out
    monkeypatch.setattr(stereo, "resize", resize_rec)
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.integers(0, 256, (1, h, w, 3), np.uint8))
    depth = torch.from_numpy(rng.integers(0, 256, (1, h, w), np.uint8))
    stereo.generate_sbs(rgb, depth, StereoParams())
    return seen


# the three pool routes of sbs_least_time (frozen in the benchmark): 2x2 +
# edge pad + 2x2, one 4x4, and the torch pools at an odd up-res width. The
# port's path pools with one quarter kernel at every width: the pair read
# once, the quarter written once, the bytes of the 4x4 and the torch glue
# stages, fewer than the two-launch stages'
@pytest.mark.parametrize("h,w,pools", [
    (48, 64, {"pool_eye4", "edge_even", "pool_f32"}),
    (48, 66, {"pool4_eye4"}),
    (48, 65, {"pool_glue"}),
])
def test_sbs_least_time_counts_the_port_path_bytes(monkeypatch, h, w, pools):
    torch.set_num_threads(1)
    model = flops.sbs_least_time(h, w)["stages"]
    glue = {"stretch", "normalize", "pack"}
    assert pools <= set(model)
    assert not ({"pool_eye4", "pool4_eye4", "pool_glue"} - pools) & set(model)
    seen = _kernel_bytes(monkeypatch, h, w)
    assert set(seen) == (set(model) - glue - pools) | {"pool4_eye4"}
    for name, got in seen.items():
        if name != "pool4_eye4":
            assert model[name]["bytes"] == got, name
    model_pool = sum(model[n]["bytes"] for n in pools)
    if len(pools) == 1:
        assert model_pool == seen["pool4_eye4"]
    else:
        assert model_pool > seen["pool4_eye4"]


def test_sbs_least_time_at_1080p():
    got = flops.sbs_least_time(1080, 1920)
    total = 0.0
    for name, st in got["stages"].items():
        t = flops.least_time(st["bytes"], f32=st["ops"])
        assert (st["ms"], st["bound_by"]) == (t["bound_ms"], t["bound_by"])
        total += st["ms"]
    assert got["ms"] == total
    # chip_smoke.py's per-kernel bounds on the card's batch-2 tensors
    # (PERF.md section 6), two frames of each stage: every kernel but the
    # postprocess, whose bound there adds the fill and polish of that run's
    # hole pixels (0.2973 ms); the pools' is that of the 2x2 kernel and the
    # f32 2x2 kernel the path took until its one quarter kernel
    st = got["stages"]
    for names, batch2 in ((("blur",), 0.09424047761194031),
                          (("warp_planar_u8",), 0.17670089552238805),
                          (("upsample_u8", "upsample_f32"),
                           0.10340274626865673),
                          (("pool_eye4", "pool_f32"), 0.30632023880597015),
                          (("pyramid",), 0.041243749253731345),
                          (("finish",), 0.08690550447761194)):
        assert 2 * sum(st[n]["ms"] for n in names) == pytest.approx(
            batch2, rel=1e-12), names
    assert st["postprocess"]["bound_by"] == "operations"
    assert 0.14 < st["postprocess"]["ms"] < 0.2973 / 2
    # u8 planes between the kernels: about half JAX's f32 stage model
    assert 0.6 < got["ms"] < 0.7 < 1.30 == flops.sbs_roofline(1080, 1920)[
        "ms"]
    assert flops.sbs_least_time(2160, 3840)["ms"] < \
        flops.sbs_roofline(2160, 3840)["ms"]
    with pytest.raises(ValueError, match="compat"):
        flops.sbs_least_time(1080, 1920, StereoParams(super_sampling=1.0))


def test_least_time_takes_the_larger_bound():
    assert flops.least_time(3.35e9) == {"bound_ms": 1.0, "bound_by": "bytes"}
    got = flops.least_time(3.35e9, bf16_tensor=989e9 * 2, f32=67e9)
    assert got == {"bound_ms": 2.0, "bound_by": "operations"}
    assert flops.issue_floor(33.5e9) == {"issue_floor_ms": 1.0}


# flops.py counts the four 1x1 projections of the hooked, fine and mid
# features (upsample_latent0.0, upsample_latent1.0, upsample0.0,
# upsample1.0) on the merged grid; the model projects every tile's tokens
# before the merge trims their overlap, 25 tiles of 8 x 8 (40^2 px against
# the grid's 32^2) and 9 of 8 x 8 (24^2 against 16^2) at tiny():
# 2 x 2 x (1600 - 1024) x 32 x 16 + 2 x (1600 - 1024) x 32 x 24
# + 2 x (576 - 256) x 32 x 32 = 2,719,744 FLOPs, with the head on or off.
TILE_OVERLAP_PROJ = 2_719_744


@pytest.mark.parametrize("head", [True, False])
def test_flop_counter_agrees_at_tiny(head):
    cfg = dataclasses.replace(DepthProConfig.tiny(), use_fov_head=head)
    torch.manual_seed(0)
    model = DepthPro(cfg).eval()
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        model(torch.zeros((2, 64, 64, 3)))
    counted = counter.get_total_flops()
    analytic = flops.depthpro_flops(cfg, 2)
    assert abs(counted - analytic) <= 1e-3 * analytic
    assert counted - analytic == 2 * TILE_OVERLAP_PROJ
