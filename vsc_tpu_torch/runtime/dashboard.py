"""
Live dashboard
==============

Rich-based live display for the orchestrator: a rolling log ring, an
"Active Processes" panel showing each child's latest progress line (captured
from its \\r-rewritten tqdm output), and the per-workflow status table with
the reference's column layout and status colors
(reference workflow_orchestrator.py:125-173, 1133-1173).

The port's own copy of ``vsc_tpu/runtime/dashboard.py`` (no torch).
"""

from __future__ import annotations

import contextlib

from rich.console import Console, Group
from rich.live import Live
from rich.panel import Panel
from rich.table import Table
from rich.text import Text

from vsc_tpu_torch.runtime import workflow_metrics as metrics
from vsc_tpu_torch.runtime.workflow_state import StepStatus, get_step_status

__all__ = ["Dashboard"]

_STEP_SHORT = {
    "frame_extractor": "Frame",
    "depth_map_generator": "Depth",
    "sbs_generator": "SBS",
    "chunk_generator": "Chunk",
    "video_concatenator": "Concat",
}

_STATUS_COLORS = {
    StepStatus.PENDING: "dim",
    StepStatus.RUNNING: "yellow",
    StepStatus.DONE: "green",
    StepStatus.ERROR: "red",
    StepStatus.FAILED: "red bold",
}

_LOG_RING = 20


class Dashboard:
    def __init__(self, orchestrator, console: Console | None = None):
        self.orch = orchestrator
        self.console = console or Console()
        self.logs: list[str] = []
        self._live: Live | None = None

    def add_log(self, message: str) -> None:
        self.logs.append(message)
        del self.logs[:-_LOG_RING]

    def render(self) -> Group:
        from vsc_tpu_torch.runtime.orchestrator import _workflow_display_name
        parts = []
        if self.logs:
            parts.append(Text.from_markup("\n".join(self.logs[-10:])))
        if self.orch.active:
            lines = []
            for info in self.orch.active.values():
                short = _STEP_SHORT.get(info.step, info.step)
                name = _workflow_display_name(info.workflow_path)
                lines.append(f"[cyan][{short}|{name}][/cyan] "
                             f"{info.progress_line or 'Starting...'}")
            parts.append(Panel("\n".join(lines), title="Active Processes",
                               border_style="blue"))
        if not parts:
            return Group(Text("No active processes"))
        return Group(*parts)

    def status_table(self) -> Table:
        from pathlib import Path
        from vsc_tpu_torch.runtime.orchestrator import _workflow_display_name
        table = Table(title="Workflow Orchestrator Status", expand=True)
        for col in ("Workflow", "Frame", "Depth", "SBS", "Video"):
            table.add_column(col, style="cyan" if col == "Workflow" else "white")
        for wf_path, wf in self.orch.workflows.items():
            row = [_workflow_display_name(wf_path)]
            for step in ("frame_extractor", "depth_map_generator",
                         "sbs_generator"):
                status = get_step_status(wf.get(step, StepStatus.PENDING))
                color = _STATUS_COLORS.get(status, "white")
                row.append(f"[{color}]{status}[/{color}]")
            progress = metrics.get_video_progress(Path(wf_path))
            if progress == "DONE":
                row.append("[green]DONE[/green]")
            elif progress == "-":
                row.append("[dim]-[/dim]")
            else:
                row.append(f"[yellow]{progress}[/yellow]")
            table.add_row(*row)
        return table

    def print_status_table(self) -> None:
        self.console.print(self.status_table())

    @contextlib.asynccontextmanager
    async def live(self):
        import asyncio

        with Live(self.render(), console=self.console,
                  refresh_per_second=4) as live:
            self._live = live

            async def updater():
                while True:
                    live.update(self.render())
                    await asyncio.sleep(0.25)

            task = asyncio.create_task(updater())
            try:
                yield self
            finally:
                task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await task
                self._live = None
