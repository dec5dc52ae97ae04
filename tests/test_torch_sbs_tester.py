"""The port's sbs_tester (vsc_tpu_torch/pipeline/sbs_tester) on the cases of
tests/test_sbs_tester.py: the headless grid sweep (BASELINE config #4
workload) on the CPU, its previews equal to the JAX package's, the grid
refused without depth, the monitor helpers, the headless picker and the
slider debounce."""

import json

import numpy as np
import pytest
import torch

from vsc_tpu_torch.config import load_config, save_config
from vsc_tpu_torch.io.image import read_rgb, write_quantized_depth, write_rgb
from vsc_tpu_torch.pipeline import sbs_tester as st

CPU = torch.device("cpu")


def _pairs(workflow, n=2, h=36, w=48):
    rng = np.random.default_rng(0)
    for i in range(1, n + 1):
        write_rgb(workflow / "frames" / f"frame_{i:06d}.png",
                  rng.integers(0, 256, (h, w, 3), np.uint8))
        write_quantized_depth(rng.integers(0, 256, (h, w), np.uint8),
                              workflow / "depth_maps"
                              / f"depth_frame_{i:06d}.png")


def test_grid_sweep_equals_jax(workflow, tmp_path, monkeypatch):
    from vsc_tpu.ops import stereo
    from vsc_tpu.pipeline import sbs_tester as jst

    config = load_config(workflow)
    config["stereo"].update({
        "max_disparity": 4.0, "convergence": 0.0, "super_sampling": 1.0,
        "edge_softness": 1.0, "artifact_smoothing": 0.0, "depth_gamma": 1.0,
        "sharpen": 0.0,
    })
    save_config(workflow, config)
    _pairs(workflow)

    out_dir = tmp_path / "grid"
    assert st.main([str(workflow), "--cpu", "--grid",
                    "max_disparity=3,5;depth_gamma=0.5", "--frames", "2",
                    "--out-dir", str(out_dir)]) == 0
    report = json.loads((out_dir / "grid_report.json").read_text())
    assert len(report) == 2  # 2 disparities x 1 gamma
    for entry in report:
        assert entry["frames_per_s"] > 0 and entry["steady_s"] > 0
    assert [e["label"] for e in report] == [
        "max_disparity=3.0,depth_gamma=0.5", "max_disparity=5.0,depth_gamma=0.5"]
    previews = sorted(out_dir.glob("grid_*.png"))
    assert len(previews) == 2
    assert read_rgb(previews[0]).shape == (36, 96, 3)  # H x 2W preview

    # JAX on its Pallas kernels (interpret mode), the TPU structure the
    # port takes on every device
    for knob in ("VSC_TPU_BLUR", "VSC_TPU_WARP", "VSC_TPU_POSTPROCESS"):
        monkeypatch.setenv(knob, "pallas")
    jax_dir = tmp_path / "jax_grid"
    stereo._generate_sbs_impl.clear_cache()
    try:
        assert jst.run_grid(workflow, config,
                            "max_disparity=3,5;depth_gamma=0.5", 2, jax_dir)
    finally:
        stereo._generate_sbs_impl.clear_cache()
    for p in previews:
        diff = np.abs(read_rgb(p).astype(int)
                      - read_rgb(jax_dir / p.name).astype(int))
        assert float(diff.mean()) < 0.05 and int(diff.max()) <= 16, p.name


def test_grid_requires_depth(workflow):
    config = load_config(workflow)
    assert not st.run_grid(workflow, config, "max_disparity=3", 2, None, CPU)


def test_monitor_detection_helpers():
    """3D-display helpers (reference sbs_tester.py:153-200, 697): xrandr
    geometry parsing, the height*2 fullscreen stretch, headless fallback."""
    text = """Monitors: 2
 0: +*DP-1 2560/597x1440/336+0+0  DP-1
 1: +HDMI-1 1920/509x1080/286+2560+180  HDMI-1
"""
    mons = st.parse_xrandr_monitors(text)
    assert mons == [
        {"x": 0, "y": 0, "width": 2560, "height": 1440},
        {"x": 2560, "y": 180, "width": 1920, "height": 1080},
    ]
    sbs = np.zeros((36, 96, 3), np.uint8)
    assert st.fullscreen_image(sbs, mons[1]).shape == (2160, 1920, 3)
    mons = st.detect_monitors()
    assert len(mons) >= 1 and mons[0]["width"] > 0


def test_no_arg_opens_picker(monkeypatch, workflow):
    """No workflow argument -> folder dialog (reference sbs_tester.py:
    726-736); cancel exits with an error, a picked workflow reaches the
    grid (no depth maps: refused)."""
    picked = {}

    def fake_picker():
        picked["called"] = True
        return None
    monkeypatch.setattr(st, "pick_workflow_dir", fake_picker)
    assert st.main(["--cpu"]) == 1
    assert picked.get("called")
    monkeypatch.setattr(st, "pick_workflow_dir", lambda: str(workflow))
    assert st.main(["--cpu", "--grid", "max_disparity=4"]) == 1


def test_picker_headless_returns_none(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    assert st.pick_workflow_dir() is None


def test_headless_interactive_mode_is_refused(monkeypatch, workflow, capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    assert st.main([str(workflow), "--cpu"]) == 1
    assert "use --grid" in capsys.readouterr().out


@pytest.mark.parametrize("needle", [
    'state["render_after"] = time.monotonic() + 0.1',
    'time.monotonic() >= state["render_after"]'])
def test_slider_debounce_rearms(needle):
    """on_change postpones rendering ~100 ms past the LAST movement
    (reference sbs_tester.py:487-498 cancel+reschedule semantics)."""
    import inspect
    assert needle in inspect.getsource(st.run_interactive)


def test_sliders_equal_jax():
    from vsc_tpu.pipeline import sbs_tester as jst
    assert st.SLIDERS == jst.SLIDERS
