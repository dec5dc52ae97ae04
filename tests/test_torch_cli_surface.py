"""CLI surface of the port's step mains, as tests/test_cli_surface.py holds
the JAX package's: argument handling and error paths (no device work), and
the device rule: a compute main without ``--cpu`` runs on the card, and on
a machine without one exits non-zero with default_device's message,
never falling back to the CPU."""

import importlib

import pytest

from vsc_tpu_torch.config import load_config

PIPELINE = "vsc_tpu_torch.pipeline."
# the mains that run on a device, and those that do not
COMPUTE = ["depth_map_generator", "sbs_generator", "sbs_tester",
           "stream_convert"]
HOST = ["frame_extractor", "chunk_generator", "video_concatenator"]


def _args(module, path):
    return [str(path)] + (["--cpu"] if module in COMPUTE else [])


def test_workflow_init_main(tmp_path, test_video):
    from vsc_tpu_torch.pipeline.workflow_init import main
    wf = tmp_path / "wf"
    assert main(["--input-video", str(test_video),
                 "--workflow-dir", str(wf)]) == 0
    config = load_config(wf)
    assert config["input_video"].endswith("test.mkv")
    for sub in ("frames", "depth_maps", "sbs", "chunks"):
        assert (wf / sub).is_dir()
    # re-init refused
    assert main(["--input-video", str(test_video),
                 "--workflow-dir", str(wf)]) == 1
    # missing input video
    assert main(["--input-video", str(tmp_path / "nope.mkv")]) == 1


@pytest.mark.parametrize("module", HOST + COMPUTE)
def test_mains_reject_missing_workflow(module, tmp_path, capsys):
    mod = importlib.import_module(PIPELINE + module)
    assert mod.main(_args(module, tmp_path / "missing")) == 1
    assert "not" in capsys.readouterr().out     # "does not exist" / "not found"


@pytest.mark.parametrize("module", HOST + COMPUTE)
def test_mains_reject_invalid_config(module, tmp_path, capsys):
    (tmp_path / "config.json").write_text("{}")
    mod = importlib.import_module(PIPELINE + module)
    assert mod.main(_args(module, tmp_path)) == 1
    assert "ERROR" in capsys.readouterr().out


@pytest.mark.parametrize("module", COMPUTE)
def test_compute_mains_need_the_card_unless_cpu(module, workflow,
                                                monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(PIPELINE + module)
    ran = []
    monkeypatch.setattr(mod, "load_config",
                        lambda *a: ran.append(a) or load_config(*a))
    assert mod.main([str(workflow)]) == 1
    assert "no CUDA device" in capsys.readouterr().out
    assert not ran      # stopped before it read the workflow


def test_depth_main_runs_on_the_cpu_when_asked(workflow, capsys):
    from vsc_tpu_torch.pipeline import depth_map_generator
    assert depth_map_generator.main([str(workflow), "--cpu", "--model",
                                     "stub"]) == 0
    out = capsys.readouterr().out
    assert "Found: 0 images" in out and "no CUDA device" not in out
