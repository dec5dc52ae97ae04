"""The plain reference against the program's CPU path: DepthPro at
DepthProConfig.tiny()'s widths from the benchmark's own weight file, and
the SBS on small frames, at the defaults and at moved sliders. On the CPU
the program runs float32 and its kernels' plain versions, so the two agree
to float32 rounding (depth) and exactly (SBS)."""

import pytest
import torch

from frozen.content import content_pool
from lib import check
from lib.program import program_config
from lib.weights import weight_file, weight_specs
from reference import sbs as ref_sbs
from reference.depthpro import DepthPro, cfg_from_dict, depth_u8, load_apple

from conftest import TINY_MODEL


def _program(path):
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depthpro
    return build_depthpro(64, "cpu", cfg=program_config(TINY_MODEL),
                          checkpoint=str(path))


def test_weight_file_names_are_the_programs_and_repeat(tmp_path,
                                                       monkeypatch):
    from lib import weights
    monkeypatch.setattr(weights, "CACHE", tmp_path)
    cfg = cfg_from_dict(TINY_MODEL)
    p1 = weight_file(TINY_MODEL, cfg, 3, "cpu")
    s1 = torch.load(p1, weights_only=True)
    prog = _program(p1)
    assert set(s1) == set(prog.state_dict())
    assert all(s1[k].dtype == torch.bfloat16 for k in s1)
    p1.unlink()
    s2 = torch.load(weight_file(TINY_MODEL, cfg, 3, "cpu"), weights_only=True)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    specs = {n: (m, s) for n, _, m, s in weight_specs(cfg)}
    assert specs["encoder.patch_encoder.blocks.0.ls1.gamma"] == (1e-5, 0.0)
    assert specs["encoder.image_encoder.norm.weight"] == (1.0, 0.0)
    assert specs["head.1.weight"][1] == pytest.approx((1 / 32) ** 0.5)


def test_reference_depth_equals_the_programs_cpu_path(tmp_path,
                                                      monkeypatch):
    from lib import weights
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depth_fn
    monkeypatch.setattr(weights, "CACHE", tmp_path)
    cfg = cfg_from_dict(TINY_MODEL)
    path = weight_file(TINY_MODEL, cfg, 5, "cpu")
    frames, _ = content_pool(3, 40, 72, 9, 4.0, "cpu")
    x = torch.from_numpy(frames)
    ref = load_apple(path, cfg, "cpu")
    prog = _program(path)
    img = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2).float(), size=(64, 64)).permute(0, 2, 3, 1)
    img = img / 127.5 - 1.0
    with torch.no_grad():
        want = prog(img)["canonical_inverse_depth"]
        got = ref(img)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    fn = build_depth_fn("depthpro", 64, 40, 72, False, checkpoint=str(path),
                        device="cpu", model_cfg=program_config(TINY_MODEL))
    d_prog = fn(x)
    d_ref = depth_u8(ref, x)
    assert check.depth_gap(d_prog, d_ref) <= 0.01


def test_reference_module_tree_is_the_programs():
    from vsc_tpu_torch.models import DepthPro as ProgramDepthPro
    cfg = cfg_from_dict(TINY_MODEL)
    with torch.device("meta"):
        ours = DepthPro(cfg).state_dict()
        theirs = ProgramDepthPro(program_config(TINY_MODEL)).state_dict()
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}


PARAMS = [{}, {"max_disparity": 23.0, "convergence": 17.0,
               "edge_softness": 0.0, "depth_gamma": 1.3, "sharpen": 0.0},
          {"artifact_smoothing": 4.2, "edge_softness": 3.0,
           "convergence": -41.0}, {"artifact_smoothing": 0.0}]


@pytest.mark.parametrize("p", PARAMS, ids=range(len(PARAMS)))
def test_reference_sbs_equals_the_programs_cpu_path(p):
    from vsc_tpu_torch.config.stereo_params import StereoParams
    from vsc_tpu_torch.ops.stereo import generate_sbs
    frames, depths = content_pool(2, 30, 64, 4, 4.0, "cpu")
    rgb, dep = torch.from_numpy(frames), torch.from_numpy(depths)
    q = ref_sbs.params_dict(p)
    want = generate_sbs(rgb, dep, StereoParams(**q))
    got = ref_sbs.generate_sbs(rgb, dep, q)
    assert got.dtype == torch.uint8 and got.shape == (2, 30, 128, 3)
    assert torch.equal(got, want)
    assert check.sbs_off_share(want, got) == 0.0


def test_reference_sbs_refuses_another_branch():
    rgb = torch.zeros(1, 8, 16, 3, dtype=torch.uint8)
    with pytest.raises(ValueError):
        ref_sbs.generate_sbs(rgb, torch.zeros(1, 8, 16, dtype=torch.uint8),
                             {"super_sampling": 1.0})


def test_controls_read_above_the_program():
    """The control at a test's size: the SBS with its float stages in
    bfloat16 and DepthPro with float8 matmul inputs read far above the
    program's float32 CPU path (which reads 0)."""
    frames, depths = content_pool(2, 30, 64, 8, 4.0, "cpu")
    rgb, dep = torch.from_numpy(frames), torch.from_numpy(depths)
    f32 = ref_sbs.generate_sbs(rgb, dep)
    bf16 = ref_sbs.generate_sbs(rgb, dep, precision="bfloat16")
    assert check.sbs_off_share(bf16, f32) > 0.01
    cfg = cfg_from_dict(TINY_MODEL)
    g = torch.Generator().manual_seed(0)
    model = DepthPro(cfg)
    for p in model.parameters():
        p.data = torch.randn(p.shape, generator=g) * 0.2
    x = torch.from_numpy(content_pool(2, 40, 72, 3, 4.0, "cpu")[0])
    want = depth_u8(model, x)
    model.set_precision("fp8")
    assert check.depth_gap(depth_u8(model, x), want) > 1.0


@pytest.mark.parametrize("name", ["dp1080-convert", "dp1080-rerender",
                                  "dp1080-preview"])
def test_control_script_reads_program_and_control(tiny_cell, name):
    """``control.py``'s readings at a test's size: a whole run of the cell
    with the control planted reads above the cell's limits, and
    ``correct`` false; the program's own run reads within them."""
    import time

    import control
    from lib.harness import run_cell
    cell = tiny_cell(name)
    rows = control.readings(cell, [11, 12], 0.3, ["cpu"],
                            log=lambda *a, **k: 0)
    assert [r["seed"] for r in rows] == [11, 12]
    for r in rows:
        assert r["correct"] is False
        assert r["check"]["sbs_off_share"]["value"] > \
            r["check"]["sbs_off_share"]["limit"]
    prog = run_cell(cell, 11, 0.3, False, ["cpu"], time.perf_counter(),
                    log=lambda s: None)
    assert prog["correct"] is True


@pytest.mark.card
def test_reference_holds_the_program_on_the_card(card, tiny_cell):
    """On the card at a test's size, through whole runs: the SBS kernels
    meet the cells' SBS limit, the planted control reads ``correct``
    false, and the program's bf16 depth lies nearer the float32 reference
    than the float8 control's. The cells' depth limit (1.2 codes) is set
    at their own size and is not held here: at these widths (D 32, four
    blocks, 64-pixel input) the program's bf16 depth reads about 2.2 codes
    off, since the min-max normalisation of a map this small stretches
    bf16's rounding over a narrow range."""
    import time

    import control
    from lib.harness import run_cell
    for name in ("dp1080-convert", "dp1080-rerender"):
        cell = tiny_cell(name)
        ctrl = control.readings(cell, [21], 0.5, [str(card)], log=print)[0]
        assert ctrl["correct"] is False
        for seed in (21, 22):
            r = run_cell(cell, seed, 0.5, False, [str(card)],
                         time.perf_counter(), log=print)
            print(name, seed, r["check"])
            got = r["check"]
            assert got["sbs_off_share"]["value"] <= \
                got["sbs_off_share"]["limit"]
            if "depth_gap" in got:
                assert got["depth_gap"]["value"] < \
                    ctrl["check"]["depth_gap"]["value"]
