"""The port's orchestrator (vsc_tpu_torch/runtime/orchestrator.py) against
the JAX package's on fake steps, as tests/test_orchestrator.py drives it:
each scenario runs on a subclass of one package's ``Orchestrator`` that
overrides only ``_build_command`` (``python -S -c`` snippets with scripted
exit codes and side effects), in a fresh directory, then on the other's in
the same directory. The launches ``(step, workflow)`` in order, the final
statuses, the strikes, the saved YAML and each scenario's own observations
must be equal.

Each scheduler tick waits for every child to exit before the next one, and
the accelerator cooldown is long where a scenario reaches it, so the launch
sequence does not depend on how fast the children start.

Also: the port's own ``_build_command`` (``-m vsc_tpu_torch.pipeline.<step>``
with JAX's flags, ``--cpu`` only to the three compute steps), ``main``'s
validate-only exit codes against JAX's, and that importing the runtime pulls
in no torch."""

import asyncio
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path
from types import SimpleNamespace

import pytest
import yaml

import vsc_tpu.config as jconfig
import vsc_tpu.runtime.orchestrator as jorch
import vsc_tpu.runtime.workflow_metrics as jm
import vsc_tpu.runtime.workflow_state as jstate
import vsc_tpu_torch.config as tconfig
import vsc_tpu_torch.runtime.orchestrator as torch_orch
import vsc_tpu_torch.runtime.workflow_metrics as tm
import vsc_tpu_torch.runtime.workflow_state as tstate

REPO = Path(__file__).resolve().parents[1]
JAX = SimpleNamespace(name="jax", orch=jorch, metrics=jm, state=jstate,
                      config=jconfig)
PORT = SimpleNamespace(name="port", orch=torch_orch, metrics=tm,
                       state=tstate, config=tconfig)
LONG_COOLDOWN = 3600.0


def make_workflow(pkg, root, name="wf1", with_video=True):
    wf = root / name
    for sub in ("frames", "depth_maps", "sbs", "chunks"):
        (wf / sub).mkdir(parents=True)
    video = root / f"{name}.mkv"
    if with_video:
        video.write_bytes(b"\x1a\x45\xdf\xa3 fake")
    pkg.config.save_config(wf, pkg.config.create_default_config(video))
    return wf


def fake_orchestrator(pkg, yaml_path, script=None, **cfg):
    """pkg's Orchestrator with scripted steps: script[step] = {"rc": n,
    "effect": python source run before the exit, which finds the workflow
    path in sys.argv[1]}."""
    script = script or {}

    class Fake(pkg.orch.Orchestrator):
        def _build_command(self, step, workflow_path, workflow):
            self.launched.append((step, workflow_path))
            behavior = script.get(step, {"rc": 0})
            code = (f"{behavior.get('effect', '')}\n"
                    f"import sys; sys.exit({behavior.get('rc', 0)})")
            # -S skips site: the fake child starts at once
            return [sys.executable, "-S", "-c", code, workflow_path]

    params = dict(scheduler_interval=0.05, accel_cooldown_seconds=0.2)
    params.update(cfg)
    orch = Fake(yaml_path, pkg.state.load_workflows(yaml_path),
                pkg.orch.OrchestratorConfig(**params))
    orch.launched = []
    return orch


def run_ticks(pkg, orch, ticks):
    """Scheduling ticks without the live display; each tick waits for every
    child (and its monitor) to finish."""

    async def _run():
        for _ in range(ticks):
            pkg.metrics.invalidate_cache()
            if orch.repair_stale_state():
                orch.save_state()
            await orch.schedule_once()
            for _ in range(1200):
                if not orch.active:
                    break
                await asyncio.sleep(0.025)
            assert not orch.active, "a fake child did not finish in 30 s"
            if orch.all_finished():
                break

    asyncio.run(_run())


def record(pkg, orch, root, extra):
    """What must be equal between the packages (paths relative to root)."""
    def rel(p):
        return str(Path(p).relative_to(root.resolve()))
    statuses = {rel(p): {s: pkg.state.get_step_status(wf.get(s))
                         for s in pkg.state.STEP_ORDER}
                for p, wf in orch.workflows.items()}
    strikes = {rel(k.rsplit(":", 1)[0]) + ":" + k.rsplit(":", 1)[1]: v
               for k, v in orch.strikes.items()}
    text = orch.yaml_path.read_text() if orch.yaml_path.exists() else None
    return dict(launched=[(s, rel(p)) for s, p in orch.launched],
                statuses=statuses, strikes=strikes, yaml=text, extra=extra)


def yaml_of(root, *wfs, done=()):
    path = root / "workflows.yaml"
    path.write_text(yaml.safe_dump(
        {str(w): ("DONE" if w in done else None) for w in wfs},
        sort_keys=False))
    return path


def files_effect(n=3, sub="frames", fmt="frame_{:06d}.png"):
    """Touches n files of the launched workflow's sub directory."""
    return ("import pathlib, sys\n"
            f"d = pathlib.Path(sys.argv[1]) / {sub!r}\n"
            f"[(d / {fmt!r}.format(i)).touch() for i in range(1, {n + 1})]")


def launch_and_wait(orch, step, key):
    async def _run():
        assert await orch._launch(step, key)
        await asyncio.wait_for(orch.active[f"{key}:{step}"].monitor,
                               timeout=60)
    asyncio.run(_run())


# --------------------------------------------------------------- scenarios
# each: (pkg, root) -> (orchestrator, extra observations)

def sc_two_strike_escalation(pkg, root):
    wf = make_workflow(pkg, root)
    orch = fake_orchestrator(pkg, yaml_of(root, wf),
                             {"frame_extractor": {"rc": 1}})
    run_ticks(pkg, orch, 30)
    key = pkg.state.normalize_path(str(wf))
    assert pkg.state.get_step_status(
        orch.workflows[key]["frame_extractor"]) == pkg.state.StepStatus.ERROR
    return orch, [orch.all_finished()]


def sc_frame_then_depth(pkg, root):
    wf = make_workflow(pkg, root)
    orch = fake_orchestrator(pkg, yaml_of(root, wf), {
        "frame_extractor": {"rc": 0, "effect": files_effect()},
        "depth_map_generator": {"rc": 1},
    }, accel_cooldown_seconds=LONG_COOLDOWN)
    run_ticks(pkg, orch, 8)
    order = [s for s, _ in orch.launched]
    assert order.index("frame_extractor") < order.index("depth_map_generator")
    # a failed depth step is an accelerator failure: cooldown, no strike
    return orch, [orch.accel_cooldown_until > 0]


def sc_accel_failure_cooldown(pkg, root):
    wf = make_workflow(pkg, root)
    (wf / "frames" / "frame_000001.png").touch()
    orch = fake_orchestrator(pkg, yaml_of(root, wf), {
        "depth_map_generator": {"rc": pkg.orch.ACCEL_ERROR_EXIT_CODE},
    }, accel_cooldown_seconds=LONG_COOLDOWN)
    run_ticks(pkg, orch, 6)
    assert orch.accel_cooldown_until > 0
    key = pkg.state.normalize_path(str(wf))
    # the cooldown blocks every accelerator step
    gates = [orch._can_start(s, key, orch.workflows[key])
             for s in ("depth_map_generator", "sbs_generator",
                       "stream_convert")]
    return orch, [gates, pkg.orch.ACCEL_ERROR_EXIT_CODE]


def sc_sbs_watermark(pkg, root):
    wf = make_workflow(pkg, root)
    orch = fake_orchestrator(pkg, yaml_of(root, wf))
    key = pkg.state.normalize_path(str(wf))
    workflow = orch.workflows[key]
    S = pkg.state.StepStatus
    workflow["frame_extractor"] = S.DONE
    workflow["depth_map_generator"] = S.RUNNING
    orch.active[f"{key}:depth_map_generator"] = types.SimpleNamespace(
        step="depth_map_generator")       # a live depth process
    seen = [orch._can_start("sbs_generator", key, workflow)]
    n = pkg.metrics.MIN_DEPTH_FOR_SBS
    for i in range(1, n):
        (wf / "depth_maps" / f"depth_frame_{i:06d}.png").touch()
    pkg.metrics.invalidate_cache()
    seen.append(orch._can_start("sbs_generator", key, workflow))  # n - 1
    (wf / "depth_maps" / f"depth_frame_{n:06d}.png").touch()
    pkg.metrics.invalidate_cache()
    seen.append(orch._can_start("sbs_generator", key, workflow))  # n
    # SBS caught up with depth: nothing to do
    (wf / "sbs" / f"sbs_{n:06d}.png").touch()
    pkg.metrics.invalidate_cache()
    seen.append(orch._can_start("sbs_generator", key, workflow))
    (wf / "sbs" / f"sbs_{n:06d}.png").unlink()
    # depth DONE waives the watermark
    workflow["depth_map_generator"] = S.DONE
    for f in (wf / "depth_maps").glob("*.png"):
        f.unlink()
    (wf / "depth_maps" / "depth_frame_000001.png").touch()
    pkg.metrics.invalidate_cache()
    seen.append(orch._can_start("sbs_generator", key, workflow))
    # the SBS limit of 2 processes
    for i in range(2):
        orch.active[f"x{i}:sbs_generator"] = types.SimpleNamespace(
            step="sbs_generator")
    seen.append(orch._can_start("sbs_generator", key, workflow))
    orch.active.clear()
    assert seen == [False, False, True, False, True, False]
    return orch, seen


def sc_sbs_rearm(pkg, root):
    # SBS finishing while depth still streams re-arms to PENDING; once depth
    # is DONE and SBS has caught up, SBS is DONE
    wf = make_workflow(pkg, root)
    key = pkg.state.normalize_path(str(wf))
    orch = fake_orchestrator(pkg, yaml_of(root, wf), {
        "sbs_generator": {"effect": files_effect(
            20, "sbs", "sbs_{:06d}.png")}})
    S = pkg.state.StepStatus
    for i in range(1, 21):
        (wf / "depth_maps" / f"depth_frame_{i:06d}.png").touch()
    orch.workflows[key]["frame_extractor"] = S.DONE
    orch.workflows[key]["depth_map_generator"] = S.RUNNING
    seen = []
    launch_and_wait(orch, "sbs_generator", key)
    seen.append(pkg.state.get_step_status(
        orch.workflows[key]["sbs_generator"]))
    orch.workflows[key]["depth_map_generator"] = S.DONE
    launch_and_wait(orch, "sbs_generator", key)
    seen.append(pkg.state.get_step_status(
        orch.workflows[key]["sbs_generator"]))
    assert seen == [S.PENDING, S.DONE]
    return orch, seen


def sc_stale_repair(pkg, root):
    wf = make_workflow(pkg, root)
    orch = fake_orchestrator(pkg, yaml_of(root, wf))
    (wf / "depth_maps" / "depth_frame_000005.png").touch()
    (wf / "sbs" / "sbs_000005.png").touch()
    pkg.metrics.invalidate_cache()
    fixed = orch.repair_stale_state()
    again = orch.repair_stale_state()
    orch.save_state()
    return orch, [fixed, again]


def sc_validate_only(pkg, root):
    wf = make_workflow(pkg, root, with_video=False)
    orch = fake_orchestrator(pkg, yaml_of(root, wf))
    ok = orch.validate_all()
    orch.save_state()
    return orch, [ok]


def sc_stuck_not_completed(pkg, root):
    good = make_workflow(pkg, root, name="good")
    bad = make_workflow(pkg, root, name="bad", with_video=False)
    orch = fake_orchestrator(pkg, yaml_of(root, good, bad, done=(good,)))
    ok = orch.validate_all()
    key = pkg.state.normalize_path(str(bad))
    finished = orch.workflow_finished(key, orch.workflows[key])
    stuck = [str(Path(p).relative_to(root.resolve()))
             for p in orch.stuck_workflows()]
    msg = orch.completion_message()
    assert "1 stuck (ERROR)" in msg and "All workflows completed" not in msg
    orch.save_state()
    return orch, [ok, finished, stuck, msg, orch.all_finished()]


def sc_chunk_end_frame(pkg, root):
    wf = make_workflow(pkg, root)
    orch = fake_orchestrator(pkg, yaml_of(root, wf))
    key = pkg.state.normalize_path(str(wf))
    workflow = orch.workflows[key]
    workflow["sbs_generator"] = pkg.state.StepStatus.DONE
    for i in range(1, 11):
        (wf / "sbs" / f"sbs_{i:06d}.png").touch()
    pkg.metrics.invalidate_cache()
    # the package's own _build_command (the fake overrides it); the flags
    # after the workflow path
    cmd = pkg.orch.Orchestrator._build_command(orch, "chunk_generator", key,
                                               workflow)
    return orch, [cmd[cmd.index(key) + 1:]]


def sc_full_classic_run(pkg, root):
    # every step produces what the next gate checks: to the output video
    wf = make_workflow(pkg, root)
    cfg = pkg.config.load_config(wf)
    out = pkg.config.get_path(wf, cfg, "output_video")
    orch = fake_orchestrator(pkg, yaml_of(root, wf), {
        "frame_extractor": {"effect": files_effect(6)},
        "depth_map_generator": {"effect": files_effect(
            6, "depth_maps", "depth_frame_{:06d}.png")},
        "sbs_generator": {"effect": files_effect(6, "sbs", "sbs_{:06d}.png")},
        "chunk_generator": {"effect": files_effect(
            1, "chunks", "sbs_000001_000006.mkv")},
        "video_concatenator": {"effect": (
            f"import pathlib; pathlib.Path({str(out)!r}).write_bytes(b'x')")},
    })
    run_ticks(pkg, orch, 20)
    assert orch.all_finished()
    orch.save_state()       # as run() ends: the finished workflow collapses
    key = pkg.state.normalize_path(str(wf))
    assert yaml.safe_load(orch.yaml_path.read_text()) == {key: "DONE"}
    return orch, []


def sc_prefetch_horizon(pkg, root):
    # four workflows; wf1's depth maps exist (stale repair makes its depth
    # RUNNING) and an accelerator cooldown holds its depth step, so the
    # depth frontier stays at wf1: frames are extracted one workflow a
    # tick, no further than prefetch_workflows (2) past the frontier
    wfs = [make_workflow(pkg, root, name=f"wf{i}") for i in range(1, 5)]
    (wfs[0] / "depth_maps" / "depth_frame_000001.png").touch()
    orch = fake_orchestrator(pkg, yaml_of(root, *wfs), {
        "frame_extractor": {"effect": files_effect(1)}})
    orch.accel_cooldown_until = time.time() + LONG_COOLDOWN
    S = pkg.state.StepStatus

    def names():
        return [Path(p).name for p in orch._prefetch_candidates()]
    cands = [names()]
    run_ticks(pkg, orch, 6)
    cands.append(names())
    # the frontier moves on when wf1's depth is DONE
    first = pkg.state.normalize_path(str(wfs[0]))
    orch.workflows[first]["depth_map_generator"] = S.DONE
    cands.append(names())
    orch.cfg.prefetch_workflows = 0
    orch.workflows[first]["depth_map_generator"] = S.RUNNING
    for w in orch.workflows.values():
        w["frame_extractor"] = S.PENDING
    cands.append(names())
    assert [s for s, _ in orch.launched] == ["frame_extractor"] * 3
    return orch, cands


def sc_disk_gate(pkg, root, monkeypatch):
    wf = make_workflow(pkg, root)
    orch = fake_orchestrator(pkg, yaml_of(root, wf), {
        "frame_extractor": {"effect": files_effect()}})
    monkeypatch.setattr(pkg.orch, "_free_gb",
                        lambda path: pkg.metrics.DISK_SPACE_THRESHOLD_GB - 0.5)
    run_ticks(pkg, orch, 3)
    blocked = list(orch.launched)
    warned = any("Low disk space" in line for line in orch.dash.logs)
    monkeypatch.setattr(pkg.orch, "_free_gb",
                        lambda path: pkg.metrics.DISK_SPACE_THRESHOLD_GB)
    run_ticks(pkg, orch, 2)
    return orch, [blocked, warned]


SCENARIOS = [sc_two_strike_escalation, sc_frame_then_depth,
             sc_accel_failure_cooldown, sc_sbs_watermark, sc_sbs_rearm,
             sc_stale_repair, sc_validate_only, sc_stuck_not_completed,
             sc_chunk_end_frame, sc_full_classic_run, sc_prefetch_horizon,
             sc_disk_gate]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_scheduling_matches_jax(scenario, tmp_path, monkeypatch):
    root = tmp_path / "case"
    records = []
    for pkg in (JAX, PORT):
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir()
        for m in (jm, tm):
            m.invalidate_cache()
        args = (pkg, root, monkeypatch) if scenario is sc_disk_gate else (
            pkg, root)
        orch, extra = scenario(*args)
        records.append(record(pkg, orch, root, extra))
    assert records[0] == records[1]


# ------------------------------------------------------------ the command

STEPS = ("frame_extractor", "depth_map_generator", "sbs_generator",
         "chunk_generator", "video_concatenator", "stream_convert")


@pytest.mark.parametrize("cpu", [False, True])
def test_command_runs_the_port_step_modules(tmp_path, cpu):
    wfs = {}
    for pkg in (JAX, PORT):
        wfs[pkg.name] = make_workflow(pkg, tmp_path / pkg.name)
        for i in range(1, 4):
            (wfs[pkg.name] / "sbs" / f"sbs_{i:06d}.png").touch()
    jm.invalidate_cache()
    tm.invalidate_cache()
    jo = jorch.Orchestrator(tmp_path / "j.yaml", {}, jorch.OrchestratorConfig())
    po = torch_orch.Orchestrator(tmp_path / "p.yaml", {},
                                 torch_orch.OrchestratorConfig(cpu=cpu))
    assert po.cfg.scripts_dir == REPO       # the children's cwd
    S = tstate.StepStatus
    for step in STEPS:
        state = {"sbs_generator": S.DONE}
        want = jo._build_command(step, str(wfs["jax"]), state)
        got = po._build_command(step, str(wfs["port"]), state)
        assert got[:4] == [sys.executable, "-m",
                           f"vsc_tpu_torch.pipeline.{step}",
                           str(wfs["port"])], got
        assert (REPO / "vsc_tpu_torch" / "pipeline" / f"{step}.py").is_file()
        flags = want[3:] + (["--cpu"] if cpu and step in (
            "depth_map_generator", "sbs_generator", "stream_convert") else [])
        assert got[4:] == flags, (step, got)
    assert "--end-frame" in po._build_command(
        "chunk_generator", str(wfs["port"]), {"sbs_generator": S.DONE})


def test_launch_runs_children_in_the_repo_root(tmp_path):
    """A real launch: the child runs in scripts_dir, where -m finds the
    port's package (the child prints its cwd and the module's file)."""
    wf = make_workflow(PORT, tmp_path)
    key = tstate.normalize_path(str(wf))

    class Probe(torch_orch.Orchestrator):
        def _build_command(self, step, workflow_path, workflow):
            return [sys.executable, "-c",
                    "import os, importlib.util; print(os.getcwd()); "
                    "print(importlib.util.find_spec("
                    "'vsc_tpu_torch.pipeline.frame_extractor').origin)"]

    orch = Probe(tmp_path / "workflows.yaml",
                 {key: {s: tstate.StepStatus.PENDING
                        for s in tstate.STEP_ORDER}},
                 torch_orch.OrchestratorConfig())

    async def _run():
        assert await orch._launch("frame_extractor", key)
        await asyncio.wait_for(orch.active[f"{key}:frame_extractor"].monitor,
                               timeout=60)
    asyncio.run(_run())
    lines = [line for line in orch.dash.logs if "frame_extractor|" in line]
    assert any(line.endswith(str(REPO)) for line in lines), lines
    assert any(line.endswith(str(REPO / "vsc_tpu_torch" / "pipeline"
                                 / "frame_extractor.py")) for line in lines)


@pytest.mark.parametrize("good", [True, False])
def test_main_validate_only_matches_jax(tmp_path, good, capsys):
    rcs = []
    for pkg in (JAX, PORT):
        root = tmp_path / pkg.name
        root.mkdir()
        wf = make_workflow(pkg, root, with_video=good)
        rcs.append(pkg.orch.main([str(yaml_of(root, wf)), "--validate-only"]))
    assert rcs[0] == rcs[1] == (0 if good else 1)
    assert torch_orch.main([str(tmp_path / "none.yaml"), "--cpu"]) == 1


def test_runtime_imports_no_torch():
    code = ("import sys\n"
            "import vsc_tpu_torch.runtime.orchestrator\n"
            "import vsc_tpu_torch.runtime.dashboard\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'vsc_tpu'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
