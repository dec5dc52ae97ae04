"""The Depth Anything V2 cell (``dav2l-1080-convert``): its entry through
``run_cell`` on the CPU at a test's size, the frozen operation count
against a hand count and against torch's FlopCounterMode on the reference,
the long attention's reader, the weight file and the control."""

import copy
import time

import pytest
import torch

from frozen import dav2, flops
from lib import trace
from lib.harness import run_cell
from lib.spec import load_benchmark, load_reader, resolve

CELL = "dav2l-1080-convert"
LARGE = resolve(load_benchmark(), CELL).config["model"]
TINY = {"encoder": {"img_size": 12, "patch_size": 2, "embed_dim": 32,
                    "depth": 4, "num_heads": 2, "mlp_ratio": 4.0,
                    "layerscale_init": 1.0},
        "hook_block_ids": [0, 1, 2, 3], "features": 16,
        "out_channels": [8, 16, 32, 32], "use_clstoken": False,
        "input_size": 12}


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The cell at the tiny widths, 32 x 64 frames, batch 2, its weight
    file under tmp_path."""
    from lib import weights_dav2
    torch.set_num_threads(2)
    monkeypatch.setattr(weights_dav2, "CACHE", tmp_path / "cache")
    cell = resolve(load_benchmark(), CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(model=TINY, batch=2, frame={"height": 32,
                                                   "width": 64})
    return cell


def test_the_cell_resolves_to_its_entry_and_metrics():
    cell = resolve(load_benchmark(), CELL)
    assert cell.chips == 1 and cell.mix["entry"] == "render_sbs_dav2"
    # the rerender's rate and bound: frames whose SBS reached host memory
    assert {m["name"] for m in cell.end_to_end} == {
        "sbs_frames_per_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "convert_mfu_pct.dav2", "depth_mfu_pct.dav2",
        "depth_encoder_ms_per_frame.dav2", "depth_decoder_ms_per_frame.dav2",
        "device_idle_pct.dav2", "attention_long_roofline_pct.dav2"}
    assert all(m["moves"] == "sbs_frames_per_s" for m in cell.per_layer)


def test_sound_run_on_the_cpu_is_correct(tiny):
    logs = []
    r = run_cell(tiny, 2**31 + 29, 0.5, False, ["cpu"], time.perf_counter(),
                 log=logs.append)
    assert r["correct"] is True and r["attempted"] > 0
    assert set(r["check"]) == {"depth_gap", "sbs_off_share"}
    assert r["check"]["depth_gap"]["value"] <= 0.5
    assert set(r["metrics"]) == {"sbs_frames_per_s", "peak_mem_gib",
                                 "setup_s"}
    assert list(r)[-1] == "check" and logs[-1].startswith("check ")


def test_broken_depth_is_not_correct(tiny, monkeypatch):
    # the depth map flipped where it is made: the check's depth_gap sees it
    from vsc_tpu_torch.pipeline import depth_map_generator
    real = depth_map_generator.build_depth_fn

    def build(*a, **k):
        fn = real(*a, **k)
        return lambda x: 255 - fn(x)
    monkeypatch.setattr(depth_map_generator, "build_depth_fn", build)
    r = run_cell(tiny, 5, 0.3, False, ["cpu"], time.perf_counter(),
                 log=lambda s: None)
    assert r["correct"] is False
    assert r["check"]["depth_gap"]["value"] > \
        r["check"]["depth_gap"]["limit"]


def test_control_plant_reads_and_restores(tiny):
    import control_dav2
    from vsc_tpu_torch.ops import stereo
    from vsc_tpu_torch.pipeline import depth_map_generator
    before = (depth_map_generator.build_depth_fn, stereo.generate_sbs)
    rows = control_dav2.readings(tiny, [3], 0.3, ["cpu"], ("depth",),
                                 log=lambda s: None)
    assert (depth_map_generator.build_depth_fn, stereo.generate_sbs) == before
    assert rows[0]["check"]["depth_gap"]["value"] > 0.0


def test_frozen_count_equals_the_hand_count_at_1080p():
    # ViT: 24 blocks of 24 T D^2 + 4 T^2 D at T = 2,443, D = 1024 (1.476 +
    # 0.587 TFLOP) and the patch embedding; the DPT head's convolutions
    # 0.518 TFLOP: 2.583 TFLOP a frame
    T, D = 2443, 1024
    vit = 24 * (24 * T * D * D + 4 * T * T * D) + 2 * 2442 * D * 3 * 196
    assert dav2.tokens(LARGE, 1080, 1920) == T
    assert dav2.input_hw(1080, 1920, 518, 14) == (518, 924)
    total = dav2.dav2_flops(LARGE, 1080, 1920)
    assert total == pytest.approx(2.583e12, rel=1e-3)
    assert total - vit == pytest.approx(0.518e12, rel=2e-3)


@pytest.mark.parametrize("hw", [(32, 64), (40, 40), (64, 30)])
def test_frozen_count_equals_flop_counter_on_the_reference(hw):
    # torch's FlopCounterMode over the reference's forward counts the same
    # matmuls, batched matmuls and convolutions (transposed ones too)
    from torch.utils.flop_counter import FlopCounterMode
    from reference.depth_anything_v2 import (DepthAnythingV2, cfg_from_dict,
                                             input_size_for)
    cfg = cfg_from_dict(TINY)
    model = DepthAnythingV2(cfg)
    for p in model.parameters():
        torch.nn.init.normal_(p, 0.0, 0.1)
    h, w = input_size_for(*hw, cfg.input_size, cfg.patch_size)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(torch.randn(1, h, w, 3))
    assert dav2.dav2_flops(TINY, *hw) == pytest.approx(
        fc.get_total_flops(), rel=1e-9)


def test_long_attention_reader_counts_one_launch_a_block():
    read = load_reader("attention_long_roofline_pct.dav2")
    ker = "void (anonymous namespace)::flash_attention_kernel(...)"
    bound = dav2.flash_attention_bound(8, 2443, 1024, 16)["bound_ms"]
    assert bound == pytest.approx(1e3 * 4 * 8 * 2443 ** 2 * 1024 / 989e12)
    steps = 3

    def rec(n, us):
        dev = [(i * 1e4, i * 1e4 + us, ker) for i in range(n)]
        dev.append((0.0, 5.0, "other_kernel"))
        return {"trace": {"device": dev, "host": [], "window": (0.0, 1e7),
                          "steps": steps},
                "trace_lib": trace, "flops": flops,
                "attention_long": {"launches": 24, "bound_ms": 24 * bound}}
    got = read(rec(24 * steps, 1000.0))
    assert got == pytest.approx(100 * bound / 1.0)
    # any other count of launches a step, or none, or no record: nothing
    assert read(rec(24 * steps - 1, 1000.0)) is None
    assert read(rec(24 * steps + 24, 1000.0)) is None
    assert read(rec(0, 1000.0)) is None
    r = rec(24 * steps, 1000.0)
    del r["attention_long"]
    assert read(r) is None


def test_weight_file_is_the_official_layout_and_repeats(tmp_path,
                                                       monkeypatch):
    from lib import weights_dav2
    from vsc_tpu_torch.models.depth_anything import (DepthAnythingV2,
                                                     IGNORED_KEYS)
    from entries.render_sbs_dav2 import program_config
    monkeypatch.setattr(weights_dav2, "CACHE", tmp_path)
    a = weights_dav2.weight_file(TINY, 0)
    assert weights_dav2.weight_file(TINY, 0) == a
    b = weights_dav2.weight_file(TINY, 1)
    sa = torch.load(a, weights_only=True)
    sb = torch.load(b, weights_only=True)
    own = DepthAnythingV2(program_config(TINY)).state_dict()
    assert set(sa) == set(own) | set(IGNORED_KEYS)
    assert all(v.dtype == torch.bfloat16 for v in sa.values())
    w = "pretrained.blocks.0.attn.qkv.weight"
    assert not torch.equal(sa[w], sb[w])
    assert float(sa["pretrained.blocks.0.ls1.gamma"].min()) == 1.0
