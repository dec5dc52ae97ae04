"""The port's orchestrator driving the port's real step CLIs as child
processes on the CPU (``OrchestratorConfig(cpu=True)``), as
tests/test_orchestrator_run.py drives the JAX package's:

- classic mode: two workflows on 8-frame 192 x 108 clips with audio, the
  first with the default stereo and free_space settings, the second with
  cheap stereo settings and no free_space deletions, reach
  DONE (output video twice the clip's width, the YAML collapsed to DONE);
  the second workflow's depth and SBS PNGs equal, bit for bit, what the
  port's depth_map_generator.main and sbs_generator.main give in-process
  with --cpu on the same extracted frames;
- --streaming mode reaches DONE with no PNG intermediates;
- without --cpu and with no card, the depth child exits 1 with
  default_device()'s message, the orchestrator takes it as an accelerator
  failure (cooldown, FAILED, no strike) and never runs it on the CPU.

The children run offline with an empty weight cache, so the depth step
takes the luminance stub, and with two torch threads, as the in-process
reference does.
"""

import asyncio
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from rich.console import Console

from vsc_tpu_torch.config import get_path, load_config, save_config
from vsc_tpu_torch.io.image import read_depth, read_rgb
from vsc_tpu_torch.io.media import make_test_video
from vsc_tpu_torch.io.probe import probe_video
from vsc_tpu_torch.pipeline import depth_map_generator as tdepth
from vsc_tpu_torch.pipeline import sbs_generator as tsbs
from vsc_tpu_torch.pipeline import workflow_init
from vsc_tpu_torch.runtime import workflow_metrics as wm
from vsc_tpu_torch.runtime.orchestrator import Orchestrator, OrchestratorConfig
from vsc_tpu_torch.runtime.workflow_state import (PERSISTENT_STEPS,
                                                   StepStatus,
                                                   get_step_status,
                                                   load_workflows,
                                                   normalize_path)
from vsc_tpu_torch.utils.profiling import PROFILE_ENV

W, H, FRAMES = 192, 108, 8
THREADS = 2
# cheap stereo settings (as the JAX streaming test's) where the run is
# checked against in-process mains or streams; the first workflow of the
# classic run keeps the defaults
FAST_STEREO = {"max_disparity": 5.0, "super_sampling": 1.0,
               "artifact_smoothing": 0.0, "sharpen": 0.0}


class Recording(Orchestrator):
    """Keeps every log line (the dashboard keeps the last 20)."""

    def log(self, message):
        self.all_logs.append(message)
        super().log(message)


@pytest.fixture()
def child_env(tmp_path, monkeypatch):
    """What the children inherit: offline, an empty weight cache, two
    torch threads, no trace."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    monkeypatch.setenv("VSC_TPU_CACHE", str(tmp_path / "empty_cache"))
    monkeypatch.setenv("OMP_NUM_THREADS", str(THREADS))
    monkeypatch.delenv("VSC_TPU_DEPTH_CHECKPOINT", raising=False)
    monkeypatch.delenv(PROFILE_ENV, raising=False)


def new_workflow(root, name, **config_updates):
    clip = root / f"{name}.mkv"
    make_test_video(clip, width=W, height=H, frames=FRAMES,
                    framerate="24/1", with_audio=True)
    wf = root / name / "workflow"
    assert workflow_init.main(["--input-video", str(clip),
                               "--workflow-dir", str(wf)]) == 0
    if config_updates:
        config = load_config(wf)
        for key, value in config_updates.items():
            config[key].update(value)
        save_config(wf, config)
    return wf


def run_orchestrator(root, wfs, timeout, stop_when=None, **cfg):
    yaml_path = root / "workflows.yaml"
    yaml_path.write_text(yaml.safe_dump({str(w): None for w in wfs},
                                        sort_keys=False))
    wm.invalidate_cache()
    orch = Recording(yaml_path, load_workflows(yaml_path),
                     OrchestratorConfig(scheduler_interval=0.2, **cfg),
                     console=Console(file=io.StringIO(), width=120))
    orch.all_logs = []

    async def _run():
        task = asyncio.create_task(orch.run())
        try:
            while not task.done():
                if stop_when is not None and stop_when(orch):
                    orch.stop_event.set()
                    orch.wakeup.set()
                await asyncio.sleep(0.1)
            await task
        finally:
            if not task.done():
                task.cancel()
                await orch.shutdown()

    asyncio.run(asyncio.wait_for(_run(), timeout=timeout))
    return orch


def _statuses(orch, wf):
    return {s: get_step_status(orch.workflows[normalize_path(str(wf))][s])
            for s in PERSISTENT_STEPS}


def _pngs(wf, sub, pattern):
    return sorted((wf / sub).glob(pattern))


def test_classic_run_on_the_cpu(tmp_path, child_env):
    first = new_workflow(tmp_path, "first")
    second = new_workflow(tmp_path, "second", stereo=FAST_STEREO, free_space={
        "sbs_generator": "none", "chunk_generator": "none"})
    orch = run_orchestrator(tmp_path, [first, second], timeout=240, cpu=True)
    failed = [line for line in orch.all_logs if "FAILED" in line
              or "ERROR" in line]
    assert not failed, "\n".join(orch.all_logs[-40:])
    saved = yaml.safe_load((tmp_path / "workflows.yaml").read_text())
    for wf in (first, second):
        assert _statuses(orch, wf) == dict.fromkeys(PERSISTENT_STEPS,
                                                    StepStatus.DONE)
        assert saved[normalize_path(str(wf))] == "DONE"
        out = get_path(wf, load_config(wf), "output_video")
        info = probe_video(out)
        assert (info["width"], info["height"]) == (2 * W, H), info
        assert info["has_audio"]
    assert orch.all_finished()
    # the default free_space: frames deleted after SBS, SBS files after
    # chunking but the last (the next chunk's overlap)
    assert not _pngs(first, "frames", "frame_*.png")
    assert [p.name for p in _pngs(first, "sbs", "sbs_*.png")] == [
        f"sbs_{FRAMES:06d}.png"]
    # every step ran once a workflow, as a child process of its own
    started = [line for line in orch.all_logs if "STARTED" in line]
    assert len(started) == 10, started

    # the second workflow against the step mains in-process
    ref = tmp_path / "reference"
    ref.mkdir()
    shutil.copy(second / "config.json", ref / "config.json")
    shutil.copytree(second / "frames", ref / "frames")
    frames = _pngs(second, "frames", "frame_*.png")
    assert len(frames) == FRAMES
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        assert tdepth.main([str(ref), "--cpu", "--no-interactive"]) == 0
        assert tsbs.main([str(ref), "--cpu", "--no-interactive"]) == 0
    finally:
        torch.set_num_threads(threads)
    for sub, pattern, read in (("depth_maps", "depth_frame_*.png",
                                read_depth),
                               ("sbs", "sbs_*.png", read_rgb)):
        got, want = _pngs(second, sub, pattern), _pngs(ref, sub, pattern)
        assert [p.name for p in got] == [p.name for p in want]
        assert len(got) == FRAMES
        for g, w in zip(got, want):
            np.testing.assert_array_equal(read(g), read(w), err_msg=g.name)


def test_streaming_run_on_the_cpu(tmp_path, child_env):
    wf = new_workflow(tmp_path, "clip", stereo=FAST_STEREO)
    orch = run_orchestrator(tmp_path, [wf], timeout=180, cpu=True,
                            streaming=True)
    assert _statuses(orch, wf) == dict.fromkeys(PERSISTENT_STEPS,
                                                StepStatus.DONE)
    started = [line.split("STARTED[/blue]: ")[1].split(" for ")[0]
               for line in orch.all_logs if "STARTED" in line]
    assert started == ["stream_convert", "video_concatenator"], started
    out = Path(json.loads((wf / "config.json").read_text())["output_video"])
    assert probe_video(out)["width"] == 2 * W
    assert not _pngs(wf, "frames", "*.png")
    assert not _pngs(wf, "depth_maps", "*.png")
    assert not _pngs(wf, "sbs", "*.png")
    assert list((wf / "chunks").glob("*.mkv"))
    saved = yaml.safe_load((tmp_path / "workflows.yaml").read_text())
    assert saved[normalize_path(str(wf))] == "DONE"


def test_no_card_is_an_accelerator_failure(tmp_path, child_env,
                                           monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")    # no card for anyone
    wf = new_workflow(tmp_path, "clip")

    def two_depth_failures(orch):
        return sum("FAILED" in line and "depth_map_generator" in line
                   for line in orch.all_logs) >= 2

    orch = run_orchestrator(tmp_path, [wf], timeout=120,
                            stop_when=two_depth_failures,
                            accel_cooldown_seconds=0.5)
    assert two_depth_failures(orch), "\n".join(orch.all_logs[-30:])
    assert _statuses(orch, wf) == {
        "frame_extractor": StepStatus.DONE,
        "depth_map_generator": StepStatus.FAILED,
        "sbs_generator": StepStatus.PENDING}
    assert orch.accel_cooldown_until > 0
    assert not orch.strikes            # an accelerator failure, no strike
    logs = "\n".join(orch.all_logs)
    assert "Accelerator failure detected" in logs
    assert "no CUDA device" in logs    # the child's own message
    assert not _pngs(wf, "depth_maps", "*")
