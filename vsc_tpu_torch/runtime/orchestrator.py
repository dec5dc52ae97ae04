"""
Multi-workflow orchestrator
===========================

The port's own copy of ``vsc_tpu/runtime/orchestrator.py``: an asyncio
control plane that drives N video workflows through the five pipeline steps
concurrently, each step a child process running the port's step CLI
(``python -m vsc_tpu_torch.pipeline.<step>``), with the JAX package's
gates, limits and state transitions, so the same workflows.yaml behaves
identically:

  - step gates and priorities: concat > chunk > sbs > depth > frame-prefetch
    (workflow_orchestrator.py:1088-1103); depth needs frames DONE; SBS
    starts at the MIN_DEPTH_FOR_SBS watermark while depth streams and
    re-arms to PENDING when it finishes ahead of depth
    (workflow_orchestrator.py:412-450, 783-796); chunk/concat are driven
    purely off filesystem state.
  - concurrency limits: 1 depth, 2 sbs, 1 mutex (frame/chunk/concat)
    process (workflow_orchestrator.py:74-76) — here these are *defaults*;
    with more cards each limit can scale with the card count.
  - failure policy: two-strike FAILED -> ERROR for persistent steps,
    endless filesystem-based retry for transient steps
    (workflow_orchestrator.py:822-856); accelerator failure (depth step
    failure or exit code 100) terminates all accelerator processes and
    imposes a cooldown (workflow_orchestrator.py:712-755).
  - stale-state repair each tick (workflow_orchestrator.py:195-261),
    disk-space gate (885-893), 5 s tick + event-driven wakeups, hourly
    fallback resync, psutil process-tree shutdown with RUNNING preserved
    for restart priority.

Structure here is intentionally different from the reference: per-step
*policies* (dataclass of gate predicate + limits + command) drive a
generic scheduler, and display is delegated to runtime.dashboard.

Where the port differs from the JAX package's orchestrator:

  - ``_build_command`` runs ``python -m vsc_tpu_torch.pipeline.<step>`` in
    ``scripts_dir`` (the repository root, so ``-m`` resolves without an
    install) where JAX's runs the root wrapper scripts;
  - the device rule: the port's compute steps run on the card unless given
    ``--cpu``, which ``OrchestratorConfig.cpu`` (``main``'s ``--cpu``)
    forwards to depth_map_generator, sbs_generator and stream_convert. With
    no card they exit 1 with ``default_device()``'s message, which counts as
    an accelerator failure; the orchestrator never falls back to the CPU on
    its own. It imports no torch itself: the device rule lives in the
    children.

    python -m vsc_tpu_torch.runtime.orchestrator workflows.yaml \
        [--validate-only] [--streaming] [--cpu]
"""

from __future__ import annotations

import asyncio
import os
import shlex
import sys
import time
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path

from vsc_tpu_torch.config import ConfigError, get_path, load_config
from vsc_tpu_torch.runtime import workflow_metrics as metrics
from vsc_tpu_torch.runtime.workflow_state import (
    MUTEX_STEPS,
    PERSISTENT_STEPS,
    STEP_ORDER,
    TRANSIENT_STEPS,
    StepStatus,
    get_step_status,
    load_workflows,
    save_workflows,
    set_step_status,
)

__all__ = ["Orchestrator", "OrchestratorConfig", "main"]

ACCEL_ERROR_EXIT_CODE = 100


@dataclass
class OrchestratorConfig:
    scheduler_interval: float = 5.0
    fallback_resync_interval: float = 3600.0
    prefetch_workflows: int = 2
    accel_cooldown_seconds: float = 30.0
    max_depth_processes: int = 1
    max_sbs_processes: int = 2
    max_mutex_processes: int = 1
    # the directory the children run in: the repository root, where
    # `python -m vsc_tpu_torch.pipeline.<step>` finds the package
    scripts_dir: Path = Path(__file__).resolve().parents[2]
    # Streaming mode: one stream_convert process per workflow replaces the
    # extract/depth/SBS/chunk steps (no PNG intermediates); concat stays a
    # normal step. Opt-in via `--streaming`.
    streaming: bool = False
    # Run the compute steps on the CPU (`--cpu` to each); without it they
    # run on the card or fail.
    cpu: bool = False


@dataclass
class StepProcess:
    workflow_path: str
    step: str
    process: asyncio.subprocess.Process
    reader: asyncio.Task | None = None
    monitor: asyncio.Task | None = None
    progress_line: str = ""
    tail: str = ""  # last output for error context

    @property
    def key(self) -> str:
        return f"{self.workflow_path}:{self.step}"


def _workflow_display_name(workflow_path: str) -> str:
    p = Path(workflow_path)
    return p.parent.name if p.name == "workflow" else p.name


def _free_gb(path: Path) -> float:
    try:
        import shutil
        return shutil.disk_usage(str(path)).free / (1024 ** 3)
    except OSError:
        # Unknown is not "full": failing closed would deadlock the scheduler
        # on a probe error; the encoder itself still fails loudly on ENOSPC.
        return float("inf")


class Orchestrator:
    # Accelerator-bound steps, subject to the failure cooldown; the port's
    # CLIs of these take --cpu.
    ACCEL_STEPS = ("depth_map_generator", "sbs_generator", "stream_convert")

    def __init__(self, yaml_path: Path, workflows: dict[str, dict],
                 cfg: OrchestratorConfig | None = None, console=None):
        self.yaml_path = Path(yaml_path)
        self.workflows = workflows
        self.cfg = cfg or OrchestratorConfig()
        self.active: dict[str, StepProcess] = {}
        self.stop_event = asyncio.Event()
        self.wakeup = asyncio.Event()
        self.accel_cooldown_until = 0.0
        # Failure strikes per workflow:step. The reference *documents*
        # two-strike FAILED -> ERROR escalation but infers the strike from
        # the step status, which its own launch path resets to RUNNING — so
        # escalation could never fire there. An explicit counter delivers
        # the documented semantics.
        self.strikes: dict[str, int] = {}
        from vsc_tpu_torch.runtime.dashboard import Dashboard
        self.dash = Dashboard(self, console=console)

    # ------------------------------------------------------------- helpers

    def log(self, message: str) -> None:
        stamp = datetime.now().strftime("[%Y-%m-%d %H:%M:%S]")
        self.dash.add_log(f"{stamp} {message}")

    def save_state(self) -> None:
        merged = save_workflows(self.yaml_path, self.workflows)
        self.workflows.clear()
        self.workflows.update(merged)

    def _active_count(self, step: str) -> int:
        return sum(1 for p in self.active.values() if p.step == step)

    def _active_mutex(self) -> int:
        return sum(1 for p in self.active.values() if p.step in MUTEX_STEPS)

    def _status(self, workflow: dict, step: str) -> str:
        return get_step_status(workflow.get(step, StepStatus.PENDING))

    def _has_process(self, workflow_path: str, step: str) -> bool:
        return f"{workflow_path}:{step}" in self.active

    # ------------------------------------------------------------- gating

    def _can_start(self, step: str, workflow_path: str, workflow: dict) -> bool:
        path = Path(workflow_path)
        st = self._status(workflow, step)

        if step in self.ACCEL_STEPS and time.time() < self.accel_cooldown_until:
            return False
        if step in MUTEX_STEPS:
            if self._active_mutex() >= self.cfg.max_mutex_processes:
                return False
        if self._has_process(workflow_path, step):
            return False

        if step == "frame_extractor":
            return st not in (StepStatus.DONE, StepStatus.ERROR)

        if step == "depth_map_generator":
            if self._active_count(step) >= self.cfg.max_depth_processes:
                return False
            if self._status(workflow, "frame_extractor") != StepStatus.DONE:
                return False
            return st not in (StepStatus.DONE, StepStatus.ERROR)

        if step == "sbs_generator":
            if self._active_count(step) >= self.cfg.max_sbs_processes:
                return False
            depth = self._status(workflow, "depth_map_generator")
            if depth not in (StepStatus.RUNNING, StepStatus.DONE):
                return False
            # watermark: while depth streams, wait for a working set of maps
            if depth != StepStatus.DONE and \
                    metrics.get_depth_count(path) < metrics.MIN_DEPTH_FOR_SBS:
                return False
            if st in (StepStatus.DONE, StepStatus.ERROR):
                return False
            # nothing to do when SBS has caught up with depth
            max_depth = metrics.get_max_depth_number(path)
            if max_depth > 0 and metrics.get_max_sbs_number(path) >= max_depth:
                return False
            return True

        if step == "chunk_generator":
            sbs_done = self._status(workflow, "sbs_generator") == StepStatus.DONE
            last = metrics.get_last_chunk_end_frame(path)
            return metrics.get_next_chunk_end_frame(path, last, sbs_done) is not None

        if step == "stream_convert":
            # owns the accelerator: shares the depth-process budget
            if self._active_count(step) >= self.cfg.max_depth_processes:
                return False
            if st == StepStatus.ERROR:
                return False
            if metrics.is_all_chunks_complete(path):
                return False
            return True

        if step == "video_concatenator":
            if self._status(workflow, "sbs_generator") != StepStatus.DONE:
                return False
            if not metrics.is_all_chunks_complete(path):
                return False
            try:
                config = load_config(path)
                if get_path(path, config, "output_video").exists():
                    return False
            except (ConfigError, OSError, KeyError, ValueError):
                pass
            return True

        return False

    # ------------------------------------------------------- stale repair

    def repair_stale_state(self) -> bool:
        """Reconcile YAML state with the filesystem
        (workflow_orchestrator.py:195-261 semantics)."""
        fixed = False
        for wf_path, wf in self.workflows.items():
            path = Path(wf_path)
            # SBS marked PENDING/RUNNING without a process but fully caught up
            if self._status(wf, "sbs_generator") in (StepStatus.PENDING,
                                                     StepStatus.RUNNING) \
                    and not self._has_process(wf_path, "sbs_generator"):
                max_depth = metrics.get_max_depth_number(path)
                if max_depth > 0 and metrics.get_max_sbs_number(path) >= max_depth:
                    set_step_status(wf, "sbs_generator", StepStatus.DONE)
                    fixed = True
            # depth PENDING but maps already exist: promote to RUNNING so the
            # restart gets priority
            if self._status(wf, "depth_map_generator") == StepStatus.PENDING \
                    and metrics.get_depth_count(path) > 0:
                set_step_status(wf, "depth_map_generator", StepStatus.RUNNING)
                fixed = True
        return fixed

    # -------------------------------------------------------- validation

    def validate_workflow(self, workflow_path: str) -> tuple[bool, str]:
        path = Path(workflow_path)
        if not path.is_dir():
            return False, f"Workflow directory does not exist: {workflow_path}"
        try:
            config = load_config(path)
        except ConfigError as e:
            return False, f"Config error: {e}"
        video = get_path(path, config, "input_video")
        if not video.is_file():
            return False, f"Input video not found: {video}"
        return True, ""

    def validate_all(self) -> bool:
        ok = True
        for wf_path, wf in self.workflows.items():
            if all(self._status(wf, s) == StepStatus.DONE for s in STEP_ORDER):
                continue
            valid, msg = self.validate_workflow(wf_path)
            if not valid:
                self.log(f"[red]ERROR[/red]: {msg}")
                ok = False
                for step in STEP_ORDER:  # first pending step takes the ERROR
                    if self._status(wf, step) == StepStatus.PENDING:
                        set_step_status(wf, step, StepStatus.ERROR)
                        break
        return ok

    # --------------------------------------------------------- completion

    def workflow_finished(self, workflow_path: str, workflow: dict) -> bool:
        for step in PERSISTENT_STEPS:
            st = self._status(workflow, step)
            if st == StepStatus.ERROR:
                return True  # permanently stuck: nothing more to schedule
            if st != StepStatus.DONE:
                return False
        try:
            path = Path(workflow_path)
            config = load_config(path)
            return get_path(path, config, "output_video").exists()
        except ConfigError:
            return True

    def stuck_workflows(self) -> list[str]:
        """Workflows that count as 'finished' only because a persistent step
        reached ERROR — permanently stuck, not completed. The reference
        conflates the two in its final message (its validate path assigns
        ERROR and its completion check then reads it as done,
        workflow_orchestrator.py:264-287 vs 340-355); we inherit the
        scheduling semantics but report stuck workflows distinctly."""
        return [p for p, wf in self.workflows.items()
                if any(self._status(wf, s) == StepStatus.ERROR
                       for s in PERSISTENT_STEPS)]

    def completion_message(self, already: bool = False) -> str:
        stuck = self.stuck_workflows()
        word = "already " if already else ""
        if stuck:
            done = len(self.workflows) - len(stuck)
            names = ", ".join(Path(p).name for p in stuck)
            return (f"[yellow]{done} workflow(s) {word}completed, "
                    f"{len(stuck)} stuck (ERROR): {names}[/yellow]")
        return f"[green]All workflows {word}completed![/green]"

    def all_finished(self) -> bool:
        if self.active:
            return False
        return all(self.workflow_finished(p, wf)
                   for p, wf in self.workflows.items())

    # ------------------------------------------------------ process launch

    def _build_command(self, step: str, workflow_path: str,
                       workflow: dict) -> list[str]:
        cmd = [sys.executable, "-m", f"vsc_tpu_torch.pipeline.{step}",
               workflow_path]
        if step in ("depth_map_generator", "sbs_generator"):
            cmd.append("--no-interactive")
        if step == "stream_convert":
            cmd.append("--no-concat")  # concat stays a gated step
        if step == "chunk_generator":
            path = Path(workflow_path)
            sbs_done = self._status(workflow, "sbs_generator") == StepStatus.DONE
            last = metrics.get_last_chunk_end_frame(path)
            nxt = metrics.get_next_chunk_end_frame(path, last, sbs_done)
            if nxt is not None:
                cmd += ["--end-frame", str(nxt)]
        if self.cfg.cpu and step in self.ACCEL_STEPS:
            cmd.append("--cpu")
        return cmd

    async def _launch(self, step: str, workflow_path: str) -> bool:
        workflow = self.workflows.get(workflow_path)
        if workflow is None:
            return False
        free = _free_gb(Path(workflow_path).parent)
        if free < metrics.DISK_SPACE_THRESHOLD_GB:
            self.log(f"[red]WARNING[/red]: Low disk space ({free:.1f} GB), "
                     "blocking new processes")
            return False

        cmd = self._build_command(step, workflow_path, workflow)
        env = os.environ.copy()
        env["DISABLE_TERMINAL_TITLE"] = "1"
        try:
            proc = await asyncio.create_subprocess_exec(
                *cmd,
                stdin=asyncio.subprocess.DEVNULL,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.STDOUT,
                cwd=str(self.cfg.scripts_dir),
                env=env,
            )
        except (OSError, ValueError) as e:
            self.log(f"[red]ERROR[/red]: Failed to start {step}: "
                     f"{e} (cmd: {shlex.join(cmd)})")
            return False

        info = StepProcess(workflow_path, step, proc)
        info.reader = asyncio.create_task(self._read_output(info))
        info.monitor = asyncio.create_task(self._monitor(info))
        self.active[info.key] = info

        if step in PERSISTENT_STEPS:
            set_step_status(workflow, step, StepStatus.RUNNING)
            self.save_state()
        self.log(f"[blue]STARTED[/blue]: {step} for "
                 f"{_workflow_display_name(workflow_path)} (PID {proc.pid})")
        return True

    async def _read_output(self, info: StepProcess) -> None:
        """Split child output on \\n AND \\r so tqdm-style progress lines
        become the live progress display
        (workflow_orchestrator.py:642-709 behavior)."""
        buffer = b""
        label = f"{info.step}|{_workflow_display_name(info.workflow_path)}"
        try:
            while True:
                chunk = await info.process.stdout.read(1024)
                if not chunk:
                    break
                buffer += chunk
                while True:
                    n = buffer.find(b"\n")
                    r = buffer.find(b"\r")
                    if n == -1 and r == -1:
                        break
                    pos = min(x for x in (n, r) if x != -1)
                    from_cr = pos == r and (n == -1 or r < n)
                    line = buffer[:pos].decode("utf-8", errors="replace").rstrip()
                    buffer = buffer[pos + 1:]
                    if not line:
                        continue
                    info.progress_line = line
                    info.tail = (info.tail + line + "\n")[-500:]
                    # plain (non-progress) lines also go to the log ring
                    if not from_cr and "%" not in line and "it/s" not in line:
                        self.log(f"[cyan][{label}][/cyan] {line}")
        except asyncio.CancelledError:
            pass
        except Exception as exc:  # noqa: BLE001 - reader must never kill the loop
            self.log(f"[red]output reader crashed for {label}: "
                     f"{type(exc).__name__}: {exc}[/red]")
        info.progress_line = ""

    async def _handle_accel_failure(self) -> None:
        """Terminate every accelerator process + cooldown
        (workflow_orchestrator.py:712-755)."""
        self.accel_cooldown_until = time.time() + self.cfg.accel_cooldown_seconds
        victims = [p for p in self.active.values()
                   if p.step in self.ACCEL_STEPS]
        self.log(f"[yellow]Accelerator failure detected - terminating "
                 f"{len(victims)} process(es), cooldown "
                 f"{self.cfg.accel_cooldown_seconds:.0f}s[/yellow]")
        for p in victims:
            try:
                p.process.terminate()
            except ProcessLookupError:
                pass

    async def _monitor(self, info: StepProcess) -> None:
        name = _workflow_display_name(info.workflow_path)
        try:
            rc = await info.process.wait()
            # re-fetch: save_state() swaps workflow dicts while we waited
            workflow = self.workflows.get(info.workflow_path)
            if workflow is None:
                return
            if rc == 0:
                self.strikes.pop(info.key, None)
                if info.step == "stream_convert":
                    # the stream subsumes extract/depth/SBS: mark them DONE
                    # so the concat gate and workflow_finished() see a
                    # completed pipeline
                    for step in ("frame_extractor", "depth_map_generator",
                                 "sbs_generator"):
                        set_step_status(workflow, step, StepStatus.DONE)
                elif info.step == "sbs_generator":
                    # SBS finishing while depth still streams means another
                    # pass is needed later: re-arm to PENDING
                    path = Path(info.workflow_path)
                    metrics.invalidate_cache()
                    depth_done = self._status(
                        workflow, "depth_map_generator") == StepStatus.DONE
                    caught_up = metrics.get_max_sbs_number(path) >= \
                        metrics.get_max_depth_number(path)
                    set_step_status(
                        workflow, "sbs_generator",
                        StepStatus.DONE if depth_done and caught_up
                        else StepStatus.PENDING)
                elif info.step in PERSISTENT_STEPS:
                    set_step_status(workflow, info.step, StepStatus.DONE)
                # transient steps: filesystem is the state
                self.log(f"[green]DONE[/green]: {info.step} for {name}")
            else:
                tail_lines = [l for l in info.tail.splitlines() if l.strip()][-5:]
                accel_failure = (info.step in ("depth_map_generator",
                                               "stream_convert")
                                 or rc == ACCEL_ERROR_EXIT_CODE)
                if accel_failure:
                    await self._handle_accel_failure()
                if info.step in TRANSIENT_STEPS:
                    self.log(f"[red]FAILED[/red]: {info.step} for {name} "
                             f"(exit {rc}) - will retry automatically")
                elif accel_failure or rc < 0:
                    # Accelerator failures and signal-terminated victims of
                    # _handle_accel_failure (rc<0) are not the step's fault:
                    # retry with cooldown forever (reference semantics,
                    # workflow_orchestrator.py:712-755) — no strike, else two
                    # transient accelerator blips would permanently ERROR the
                    # step.
                    set_step_status(workflow, info.step, StepStatus.FAILED)
                    self.log(f"[red]FAILED[/red]: {info.step} for {name} "
                             f"(exit {rc}) - accelerator/termination, will "
                             "retry after cooldown")
                else:
                    self.strikes[info.key] = self.strikes.get(info.key, 0) + 1
                    if self.strikes[info.key] >= 2:  # strike two
                        set_step_status(workflow, info.step, StepStatus.ERROR)
                        self.log(f"[red bold]ERROR[/red bold]: {info.step} for "
                                 f"{name} (exit {rc}) - permanent failure, "
                                 "needs manual intervention")
                    else:
                        set_step_status(workflow, info.step, StepStatus.FAILED)
                        self.log(f"[red]FAILED[/red]: {info.step} for {name} "
                                 f"(exit {rc}) - will retry")
                for line in tail_lines:
                    self.log(f"  [yellow]{line}[/yellow]")

            if info.step in PERSISTENT_STEPS:
                self.save_state()
            metrics.invalidate_cache()
            self.wakeup.set()
        except asyncio.CancelledError:
            try:
                info.process.terminate()
                await asyncio.wait_for(info.process.wait(), timeout=30)
            except (asyncio.TimeoutError, ProcessLookupError):
                try:
                    info.process.kill()
                except ProcessLookupError:
                    pass
        finally:
            self.active.pop(info.key, None)

    # ----------------------------------------------------------- scheduling

    def _candidates(self, step: str) -> list[str]:
        """Startable workflows for a step, ordered RUNNING-restarts first,
        then PENDING, then FAILED, preserving YAML order within each class."""
        if step in TRANSIENT_STEPS:
            return [p for p, wf in self.workflows.items()
                    if self._can_start(step, p, wf)]
        buckets: dict[str, list[str]] = {
            StepStatus.RUNNING: [], StepStatus.PENDING: [], StepStatus.FAILED: []}
        for p, wf in self.workflows.items():
            if not self._can_start(step, p, wf):
                continue
            st = self._status(wf, step)
            if st in buckets:
                buckets[st].append(p)
        return (buckets[StepStatus.RUNNING] + buckets[StepStatus.PENDING]
                + buckets[StepStatus.FAILED])

    def _prefetch_candidates(self) -> list[str]:
        """Frame-extraction prefetch: keep PREFETCH_WORKFLOWS of frames
        ready ahead of the depth frontier
        (workflow_orchestrator.py:530-605)."""
        order = list(self.workflows.keys())
        # FAILED included (unlike the reference, whose prefetch ignores
        # FAILED frame extractions, leaving them stuck until a restart):
        # retry happens in-session and the two-strike escalation applies.
        startable = [p for p in order
                     if self._can_start("frame_extractor", p, self.workflows[p])
                     and self._status(self.workflows[p], "frame_extractor")
                     in (StepStatus.PENDING, StepStatus.RUNNING,
                         StepStatus.FAILED)]
        if not startable:
            return []
        depth_pos = next(
            (i for i, p in enumerate(order)
             if self._status(self.workflows[p], "depth_map_generator")
             in (StepStatus.RUNNING, StepStatus.PENDING)), -1)
        if depth_pos == -1:
            return startable[: self.cfg.prefetch_workflows + 1]
        horizon = min(depth_pos + self.cfg.prefetch_workflows + 1, len(order))
        allowed = set(order[:horizon])
        return [p for p in startable if p in allowed]

    async def schedule_once(self) -> None:
        if self.cfg.streaming:
            # streaming mode: concat first, then one stream per workflow
            for step in ("video_concatenator", "stream_convert"):
                for wf_path, wf in self.workflows.items():
                    if self._can_start(step, wf_path, wf):
                        await self._launch(step, wf_path)
            return
        # Priority: completion-side steps first
        for step in ("video_concatenator", "chunk_generator",
                     "sbs_generator", "depth_map_generator"):
            for wf_path in self._candidates(step):
                if not self._can_start(step, wf_path, self.workflows[wf_path]):
                    continue  # limits may have filled while launching
                await self._launch(step, wf_path)
        for wf_path in self._prefetch_candidates():
            if self._can_start("frame_extractor", wf_path,
                               self.workflows[wf_path]):
                if await self._launch("frame_extractor", wf_path):
                    break  # one extraction at a time

    async def run(self) -> None:
        self.log("[blue]Validating workflows...[/blue]")
        self.validate_all()
        self.save_state()
        self.dash.print_status_table()

        last_resync = time.monotonic()
        if self.all_finished():
            self.log(self.completion_message(already=True))
            return

        import signal
        loop = asyncio.get_event_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, self.stop_event.set)
            except NotImplementedError:
                signal.signal(sig, lambda s, f: self.stop_event.set())

        async with self.dash.live():
            while not self.stop_event.is_set():
                try:
                    await asyncio.wait_for(self.wakeup.wait(),
                                           timeout=self.cfg.scheduler_interval)
                    self.wakeup.clear()
                    metrics.invalidate_cache()
                except asyncio.TimeoutError:
                    pass
                if time.monotonic() - last_resync >= \
                        self.cfg.fallback_resync_interval:
                    metrics.invalidate_cache()
                    self.save_state()  # pick up manual yaml edits
                    last_resync = time.monotonic()
                if self.repair_stale_state():
                    self.save_state()
                await self.schedule_once()
                if self.all_finished():
                    self.log(self.completion_message())
                    break
        await self.shutdown()

    async def shutdown(self) -> None:
        """Terminate process trees; RUNNING statuses are preserved so the
        next start restarts them first."""
        for info in list(self.active.values()):
            _terminate_tree(info.process.pid)
        for info in list(self.active.values()):
            for task in (info.reader, info.monitor):
                if task and not task.done():
                    task.cancel()
        tasks = [p.monitor for p in self.active.values() if p.monitor]
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        self.save_state()


def _terminate_tree(pid: int) -> None:
    """psutil-based recursive terminate -> kill
    (workflow_orchestrator.py:1176-1210)."""
    try:
        import psutil
        parent = psutil.Process(pid)
        children = parent.children(recursive=True)
        for p in children + [parent]:
            try:
                p.terminate()
            except psutil.NoSuchProcess:
                pass
        _, alive = psutil.wait_procs(children + [parent], timeout=5)
        for p in alive:
            try:
                p.kill()
            except psutil.NoSuchProcess:
                pass
    except psutil.Error:
        pass


def main(argv=None) -> int:
    import argparse
    from rich.console import Console

    parser = argparse.ArgumentParser(
        description="Orchestrate multiple video conversion workflows")
    parser.add_argument("yaml_path", type=Path, help="workflows.yaml file")
    parser.add_argument("--validate-only", action="store_true")
    parser.add_argument("--streaming", action="store_true",
                        help="One streaming process per workflow (no PNG "
                             "intermediates) instead of the classic steps")
    parser.add_argument("--cpu", action="store_true",
                        help="Run the compute steps on the CPU (default: "
                             "the card)")
    args = parser.parse_args(argv)

    console = Console()
    if not args.yaml_path.exists():
        console.print(f"[red]ERROR[/red]: Workflows file not found: "
                      f"{args.yaml_path}")
        return 1
    try:
        workflows = load_workflows(args.yaml_path)
    except Exception as e:
        console.print(f"[red]ERROR[/red]: Failed to load workflows: {e}")
        return 1
    if not workflows:
        console.print("[yellow]No workflows found in file[/yellow]")
        return 0
    console.print(f"[blue]Loaded {len(workflows)} workflow(s)[/blue]")

    cfg = OrchestratorConfig(streaming=args.streaming, cpu=args.cpu)
    orch = Orchestrator(args.yaml_path, workflows, cfg=cfg, console=console)
    if args.validate_only:
        ok = orch.validate_all()
        orch.dash.print_status_table()
        return 0 if ok else 1
    try:
        asyncio.run(orch.run())
    except KeyboardInterrupt:
        console.print("[yellow]Interrupted[/yellow]")
        return 1
    return 0


if __name__ == "__main__":
    from vsc_tpu_torch.utils.console import (ensure_utf8_console,
                                             set_terminal_title)
    ensure_utf8_console()
    set_terminal_title("workflow_orchestrator " + " ".join(sys.argv[1:]))
    sys.exit(main())
