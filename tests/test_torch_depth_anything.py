"""Depth Anything V2 in the port (``models/depth_anything.py``) against its
plain reference (``tests/plain_depth_anything_v2.py``, which imports
neither JAX nor the port) on the CPU at a tiny, non-square size: embed 32,
4 blocks, 2 heads, patch 2, a 6 x 6 position table, 4 hooks, features 16.
Also the pieces the model brought: the DINOv2 position table, the input
rule, cv2's INTER_CUBIC taps, the official key layout, the flash
attention's plain order, ``build_depth_fn`` and the CLIs' ``--model``."""

import filecmp
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_depth_anything_v2 as ref
from vsc_tpu_torch.models import depth_anything as dav2
from vsc_tpu_torch.models.convert import (ConversionError,
                                          depth_anything_v2_state_dict)
from vsc_tpu_torch.models.depth_anything import (DepthAnythingV2,
                                                 DepthAnythingV2Config)
from vsc_tpu_torch.pipeline import depth_map_generator as tdepth

TINY = DepthAnythingV2Config.tiny()
REF_TINY = ref.DAv2Cfg(patch_size=2, pos_grid=6, embed_dim=32, depth=4,
                       num_heads=2, hooks=(0, 1, 2, 3), features=16,
                       out_channels=(8, 16, 32, 32), input_size=12)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def weights(tmp_path):
    """A seeded state dict of the tiny model in the official key layout
    (mask token included), saved as a .pth; with the reference model."""
    with torch.device("meta"):
        model = ref.DepthAnythingV2(REF_TINY)
    state = ref.init_seeded(model, 7)
    path = tmp_path / "depth_anything_v2_tiny.pth"
    torch.save(state, path)
    return path, ref.load_official(path, REF_TINY, "cpu")


def _port(path):
    model = DepthAnythingV2(TINY)
    model.load_state_dict(depth_anything_v2_state_dict(path, model),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("h,w", [(12, 22), (12, 12), (16, 10), (24, 30)])
def test_port_matches_the_plain_reference_in_float32(weights, h, w):
    # float32 on both sides, same weights and the same bicubic table
    # (F.interpolate with the same arguments): only the order of the
    # matmuls' and convolutions' sums differs, so the outputs agree to
    # float32 rounding carried through the 4 blocks and the head: 1e-5 of
    # the output's range (measured 1.5e-6 at 12 x 22)
    path, model = weights
    port = _port(path)
    x = torch.from_numpy(np.random.default_rng(h * w).standard_normal(
        (3, h, w, 3)).astype(np.float32))
    with torch.no_grad():
        got, want = port(x), model(x)
    assert got.shape == want.shape == (3, h, w) and got.dtype == torch.float32
    span = float(want.max() - want.min())
    err = float((got - want).abs().max())
    assert span > 0
    assert err <= 1e-5 * span, (err, span)


def test_position_table_takes_dinov2s_offset():
    from vsc_tpu_torch.models.vit import POS_OFFSET, ViT, pos_table
    torch.manual_seed(0)
    vit = ViT(TINY.encoder)
    torch.nn.init.normal_(vit.pos_embed, 0.0, 0.02)
    pe, D = vit.pos_embed.detach(), TINY.encoder.embed_dim
    want = torch.nn.functional.interpolate(
        pe[:, 1:].reshape(1, 6, 6, D).permute(0, 3, 1, 2),
        scale_factor=((5 + 0.1) / 6, (11 + 0.1) / 6), mode="bicubic",
        antialias=False).permute(0, 2, 3, 1).reshape(1, 55, D)
    got = pos_table(pe, 6, 5, 11)
    assert POS_OFFSET == 0.1 and got.shape == (1, 56, D)
    assert torch.equal(got[:, :1], pe[:, :1])
    assert torch.equal(got[:, 1:], want)
    # the offset is what makes the scale factor give exactly 5 x 11; a
    # resize to that size maps coordinates by another scale
    by_size = torch.nn.functional.interpolate(
        pe[:, 1:].reshape(1, 6, 6, D).permute(0, 3, 1, 2), size=(5, 11),
        mode="bicubic").permute(0, 2, 3, 1).reshape(1, 55, D)
    assert not torch.allclose(got[:, 1:], by_size)
    # the reference's interpolate_pos_encoding, the same table
    with torch.device("meta"):
        rmodel = ref.DepthAnythingV2(REF_TINY)
    rmodel = rmodel.to_empty(device="cpu")
    with torch.no_grad():
        rmodel.pretrained.pos_embed.copy_(pe)
        assert torch.equal(rmodel.pretrained.interpolate_pos_encoding(5, 11),
                           got)
    # the table's own grid takes the table itself, no new work; another
    # grid is interpolated once and kept until the table changes
    with torch.no_grad():
        assert vit.pos_for(6, 6) is vit.pos_embed
        first = vit.pos_for(5, 11)
        assert vit.pos_for(5, 11) is first
        vit.pos_embed.mul_(2.0)
        assert torch.equal(vit.pos_for(5, 11), 2.0 * first)


@pytest.mark.parametrize("hw,want", [
    ((1080, 1920), (518, 924)), ((2160, 3840), (518, 924)),
    ((720, 1280), (518, 924)), ((1920, 1080), (924, 518)),
    ((480, 640), (518, 686)), ((518, 518), (518, 518))])
def test_input_size_rule(hw, want):
    # DAv2's Resize(518, 518, keep_aspect_ratio=True, ensure_multiple_of=14,
    # resize_method="lower_bound"): 1080p, 4K, 720p and portrait
    assert dav2.input_size_for(*hw) == want
    assert ref.input_size_for(*hw) == want
    assert dav2.input_size_for(*hw, 12, 2) == ref.input_size_for(*hw, 12, 2)


@pytest.mark.parametrize("src,dst", [(1080, 518), (1920, 924), (37, 50),
                                     (9, 40), (20, 7)])
def test_cubic_taps_equal_cv2_inter_cubic(src, dst):
    # cv2 resizes the x / 255 float64 image (transform.py); the port's taps
    # are cv2's float32 weights applied in float32: within 2e-4 of a code
    # on the 0-255 scale (measured 8e-5 at 1080 x 1920 -> 518 x 924)
    import cv2
    from vsc_tpu_torch.ops.resize import resize
    img = np.random.default_rng(src + dst).random((src, 33, 3)) * 255.0
    img = img.astype(np.float32)
    want = cv2.resize(img.astype(np.float64) / 255.0, (33, dst),
                      interpolation=cv2.INTER_CUBIC) * 255.0
    got = resize(torch.from_numpy(img)[None], dst, 33, "cubic",
                 channel_last=True)[0]
    assert float(np.abs(got.numpy() - want).max()) <= 2e-4
    # the reference's own taps: the same arithmetic, the same bits
    assert torch.equal(ref.resize(torch.from_numpy(img)[None], dst, 33,
                                  "cubic", channel_last=True)[0], got)


def test_official_layout_round_trip(weights, tmp_path):
    path, model = weights
    state = torch.load(path, weights_only=True)
    port = _port(path)
    own = port.state_dict()
    # every tensor but the mask token, under its own name, bit for bit
    assert dav2.IGNORED_KEYS == ("pretrained.mask_token",)
    assert set(state) - set(own) == {"pretrained.mask_token"}
    assert set(own) <= set(state)
    for k, v in own.items():
        assert torch.equal(v, state[k]), k
    # and back: the port's state dict plus the mask token loads into the
    # reference strictly, and both models compute the same
    back = dict(own, **{"pretrained.mask_token": state[
        "pretrained.mask_token"]})
    p2 = tmp_path / "back.pth"
    torch.save(back, p2)
    again = ref.load_official(p2, REF_TINY, "cpu")
    x = torch.randn(2, 12, 22, 3)
    with torch.no_grad():
        assert torch.equal(again(x), model(x))
    # strict: a missing, an unexpected or a reshaped tensor is refused
    for name, bad in (
            ("missing", {k: v for k, v in state.items()
                         if k != "depth_head.scratch.output_conv1.bias"}),
            ("unexpected", dict(state, **{"depth_head.extra": torch.ones(1)})),
            ("shape", dict(state, **{"pretrained.cls_token":
                                     torch.zeros(1, 1, 33)}))):
        p3 = tmp_path / f"{name}.pth"
        torch.save(bad, p3)
        with pytest.raises(ConversionError, match=name):
            depth_anything_v2_state_dict(p3, DepthAnythingV2(TINY))


def test_build_depth_fn_within_one_code_of_the_reference(weights):
    path, model = weights
    frames = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (3, 36, 64, 3), dtype=np.uint8))
    fn = tdepth.build_depth_fn("depth-anything-v2", 518, 36, 64, False,
                               checkpoint=str(path), device="cpu",
                               model_cfg=TINY)
    got = fn(frames)
    want = ref.depth_u8(model, frames, block=2)
    assert got.dtype == torch.uint8 and got.shape == (3, 36, 64)
    assert int(got.max()) == 255 and int(got.min()) == 0
    assert int((got.int() - want.int()).abs().max()) <= 1
    # the model's input is the aspect-kept lower bound: 12 x 22 here
    assert dav2.input_size_for(36, 64, TINY.input_size, 2) == (12, 22)
    # 16-bit output from the same depth
    fn16 = tdepth.build_depth_fn("depth-anything-v2", 518, 36, 64, True,
                                 checkpoint=str(path), device="cpu",
                                 model_cfg=TINY)
    d16 = fn16(frames)
    assert d16.dtype == torch.uint16
    assert int((d16.int() / 257.0 - got.int()).abs().max()) <= 1


def test_build_depth_fn_on_a_one_device_data_mesh(weights):
    from vsc_tpu_torch.parallel.auto import gather, shard_batch
    from vsc_tpu_torch.parallel.mesh import Sharded, make_mesh
    path, _ = weights
    mesh = make_mesh(data=1, devices=["cpu"])
    frames = np.random.default_rng(4).integers(0, 256, (2, 36, 64, 3),
                                               dtype=np.uint8)
    fn = tdepth.build_depth_fn("depth-anything-v2", 518, 36, 64, False,
                               checkpoint=str(path), device="cpu",
                               model_cfg=TINY)
    fn_mesh = tdepth.build_depth_fn("depth-anything-v2", 518, 36, 64, False,
                                    checkpoint=str(path), mesh=mesh,
                                    model_cfg=TINY)
    batch = shard_batch(frames, torch.device("cpu"), mesh)
    got = fn_mesh(batch if isinstance(batch, Sharded)
                  else Sharded((batch,), mesh))
    assert isinstance(got, Sharded)
    assert torch.equal(gather(got), fn(torch.from_numpy(frames)))


def test_seeded_init_without_a_checkpoint_is_the_seeds():
    a = tdepth.build_depth_anything("cpu", cfg=TINY, seed=3)
    b = tdepth.build_depth_anything("cpu", cfg=TINY, seed=3)
    c = tdepth.build_depth_anything("cpu", cfg=TINY, seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = "depth_head.resize_layers.0.weight"
    assert not torch.equal(sa[w], sc[w])
    # the transposed convolutions follow flax's lecun law (fan-in kh kw Cin)
    assert float(sa[w].std()) == pytest.approx((8 * 16) ** -0.5, rel=0.2)
    assert float(sa["pretrained.blocks.0.ls1.gamma"].min()) == 1.0


def test_benchmark_copy_is_the_same_file_and_computes_the_same(weights,
                                                               monkeypatch):
    mine = REPO / "tests" / "plain_depth_anything_v2.py"
    copy = REPO / "benchmark" / "reference" / "depth_anything_v2.py"
    assert filecmp.cmp(mine, copy, shallow=False)
    spec = importlib.util.spec_from_file_location("bench_dav2_ref", copy)
    bench = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, bench)  # for its dataclass
    spec.loader.exec_module(bench)
    path, model = weights
    other = bench.load_official(path, bench.DAv2Cfg(**vars(REF_TINY)), "cpu")
    frames = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, 36, 64, 3), dtype=np.uint8))
    assert torch.equal(bench.depth_u8(other, frames),
                       ref.depth_u8(model, frames))


@pytest.mark.parametrize("T", [5, 128, 129, 300])
def test_flash_plain_order_is_the_full_row_softmax(T):
    # the flash kernel's order (keys in tiles of 128, the running max and
    # sum) against the full-row plain version: in float32 the same function
    # to float32 rounding (2e-6); in bf16 p is rounded at the running max,
    # not the final one, so within bf16's step of the output (2^-8 of
    # the v values' largest magnitude)
    from vsc_tpu_torch.ops.attention_cuda import (flash_attention,
                                                  flash_attention_plain,
                                                  qkv_attention_plain)
    g = torch.Generator().manual_seed(T)
    qkv = torch.randn((2, T, 3 * 2 * 64), generator=g)
    torch.testing.assert_close(flash_attention_plain(qkv, 2, 0.125),
                               qkv_attention_plain(qkv, 2, 0.125),
                               atol=2e-6, rtol=0)
    qb = qkv.to(torch.bfloat16)
    got = flash_attention_plain(qb, 2, 0.125).float()
    want = qkv_attention_plain(qb, 2, 0.125).float()
    vmax = float(qb[..., 2 * 2 * 64:].float().abs().max())
    assert float((got - want).abs().max()) <= 2 ** -8 * vmax
    assert torch.equal(flash_attention(qb, 2, 0.125),
                       flash_attention_plain(qb, 2, 0.125))


def test_vit_sends_long_bf16_attention_to_the_flash_route(monkeypatch):
    from vsc_tpu_torch.models import vit
    from vsc_tpu_torch.ops import attention_cuda
    from vsc_tpu_torch.ops.attention_cuda import qkv_attention_plain
    seen = []
    monkeypatch.setattr(attention_cuda, "flash_attention",
                        lambda qkv, h, s: seen.append(tuple(qkv.shape))
                        or qkv_attention_plain(qkv, h, s))
    attn = vit.Attention(128, 2).to(torch.bfloat16)
    with torch.no_grad():
        attn(torch.randn(1, 641, 128, dtype=torch.bfloat16))
        attn(torch.randn(1, 640, 128, dtype=torch.bfloat16))
        attn.float()(torch.randn(1, 641, 128))
    assert seen == [(1, 641, 384)]


def test_depth_step_cli_runs_depth_anything(frames_wf, weights, monkeypatch):
    from vsc_tpu_torch.io.image import read_rgb
    path, model = weights
    monkeypatch.setenv(tdepth.DAV2_CHECKPOINT_ENV, str(path))
    calls = []
    real = tdepth.build_depth_fn

    def build(*a, **k):
        calls.append(a[:2])
        return real(*a, model_cfg=TINY, **k)
    monkeypatch.setattr(tdepth, "build_depth_fn", build)
    # frames 1-3 at batch 2: the second batch padded with frame 3
    assert tdepth.main([str(frames_wf), "--cpu", "--model",
                        "depth-anything-v2", "--end-frame", "3",
                        "--batch-size", "2", "--no-interactive"]) == 0
    # the input size left to the model (its own, 518; TINY's here)
    assert calls == [("depth-anything-v2", None)]
    got = sorted((frames_wf / "depth_maps").glob("depth_frame_*.png"))
    assert [f.name for f in got] == [f"depth_frame_{i:06d}.png"
                                     for i in (1, 2, 3)]
    frames = np.stack([read_rgb(f) for f in sorted(
        (frames_wf / "frames").glob("frame_*.png"))[:3]])
    want = ref.depth_u8(model, torch.from_numpy(frames))
    for f, w in zip(got, want):
        import cv2
        d = cv2.imread(str(f), cv2.IMREAD_UNCHANGED)
        assert np.abs(d.astype(int) - w.numpy().astype(int)).max() <= 1


@pytest.fixture()
def frames_wf(workflow):
    from vsc_tpu_torch.pipeline import frame_extractor
    assert frame_extractor.main([str(workflow)]) == 0
    return workflow


@pytest.mark.parametrize("module", ["depth_map_generator", "stream_convert"])
@pytest.mark.parametrize("argv,want", [
    (["--model", "depth-anything-v2"], ("depth-anything-v2", None)),
    (["--model", "depth-anything-v2", "--input-size", "700"],
     ("depth-anything-v2", 700)),
    (["--model", "depthpro"], ("depthpro", None))])
def test_cli_model_choice_reaches_run(module, argv, want, workflow,
                                      monkeypatch):
    import importlib
    mod = importlib.import_module("vsc_tpu_torch.pipeline." + module)
    seen = []
    monkeypatch.setattr(mod, "run", lambda *a, **k: seen.append(
        (k["model_name"], k["input_size"])) or True)
    assert mod.main([str(workflow), "--cpu", *argv]) == 0
    assert seen == [want]
    # no --input-size: each model's own, from its config
    from vsc_tpu_torch.models.depthpro import DepthProConfig
    assert DepthAnythingV2Config().input_size == 518
    assert DepthProConfig().img_size == 1536
    assert tdepth.LuminanceStub(1536).input_size == 1536


@pytest.mark.parametrize("module", ["depth_map_generator", "stream_convert"])
def test_cli_refuses_depth_anything_without_its_weights(module, frames_wf,
                                                        monkeypatch, capsys):
    # no cache or hub can hold the official weights: without
    # VSC_TPU_DAV2_CHECKPOINT both CLIs stop with an error before building
    # a model, and write nothing
    import importlib
    mod = importlib.import_module("vsc_tpu_torch.pipeline." + module)
    monkeypatch.delenv(tdepth.DAV2_CHECKPOINT_ENV, raising=False)
    monkeypatch.setattr(tdepth, "build_depth_fn", lambda *a, **k: pytest.fail(
        "a model was built without its weights"))
    argv = [str(frames_wf), "--cpu", "--model", "depth-anything-v2"]
    if module == "depth_map_generator":
        argv.append("--no-interactive")
    assert mod.main(argv) == 1
    assert tdepth.DAV2_CHECKPOINT_ENV in capsys.readouterr().out
    assert not list((frames_wf / "depth_maps").iterdir())
    assert not list((frames_wf / "chunks").iterdir())
    with pytest.raises(tdepth.ConfigError, match="depth_anything_v2_vitl"):
        tdepth.model_checkpoint(tdepth.DAV2)


@pytest.mark.parametrize("name,hw,want", [
    ("depth-anything-v2", (36, 64), (12, 22)),
    ("depthpro", (36, 64), (64, 64)),
    ("stub", (36, 64), (32, 32))])
def test_each_model_prepares_its_own_input(name, hw, want):
    # build_depth_fn calls one interface: the model's prepare (its resize
    # and normalization) and inverse_depth; the rules are the models' own
    from vsc_tpu_torch.models.depthpro import DepthPro, DepthProConfig
    if name == "depth-anything-v2":
        model = DepthAnythingV2(TINY).eval()
    elif name == "depthpro":
        model = DepthPro(DepthProConfig.tiny()).eval()
    else:
        model = tdepth.LuminanceStub(32)
    frames = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 255, (2, *hw, 3)).astype(np.float32))
    with torch.no_grad():
        x = model.prepare(frames)
        depth = model.inverse_depth(x)
    assert tuple(x.shape) == (2, *want, 3) and x.dtype == torch.float32
    assert depth.dtype == torch.float32 and depth.ndim == 3
    assert depth.shape[0] == 2 and bool(torch.isfinite(depth).all())
    if name == "depth-anything-v2":
        # ImageNet's normalization: 0-255 maps to about [-2.1, 2.6]
        assert tuple(depth.shape) == (2, *want)
        assert float(x.min()) < -1.0 and float(x.max()) > 1.0
    else:
        # DepthPro's: x / 127.5 - 1
        assert float(x.min()) >= -1.0 and float(x.max()) <= 1.0


def test_unknown_model_is_refused():
    with pytest.raises(ValueError, match="unknown depth model"):
        tdepth.build_depth_fn("depth-anything-v3", 518, 8, 8, False,
                              device="cpu")
