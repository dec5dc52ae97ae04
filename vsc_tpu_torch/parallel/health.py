"""
Accelerator health probe (PyTorch / CUDA)
=========================================

Port of ``vsc_tpu/parallel/health.py``: a tiny known-answer computation on
the target device, run before dispatching work, returning False on a wrong
result, any runtime error, or a hang past its deadline. The orchestrator
reacts to exit code 100 the way the reference does (terminate, cool down,
retry). ``torch.cuda.synchronize`` takes the place of the JAX sync.
"""

from __future__ import annotations

import contextvars
import functools
import os
import queue
import threading

import torch

from vsc_tpu_torch.utils.profiling import span

__all__ = ["ACCEL_ERROR_EXIT_CODE", "check_accelerator_health",
           "run_with_deadline"]

ACCEL_ERROR_EXIT_CODE = 100

_DEFAULT_TIMEOUT = float(os.environ.get("VSC_TPU_HEALTH_TIMEOUT", "600"))
_WARM_TIMEOUT = float(os.environ.get("VSC_TPU_HEALTH_WARM_TIMEOUT", "60"))
_probe_succeeded_once = False


def _run_probe(device) -> bool:
    x = torch.tensor([1.0, 2.0, 3.0], device=device)
    result = (x * 2.0).sum()
    if result.is_cuda:
        torch.cuda.synchronize(result.device)
    return abs(float(result) - 12.0) < 1e-3


class _Dispatcher:
    """One daemon thread that runs the calls put on its queue, in turn.
    It lives across calls, so its per-thread state (PyTorch's cuDNN
    execution plans are cached per thread) is built once, not once a
    batch."""

    def __init__(self):
        self.jobs: queue.SimpleQueue = queue.SimpleQueue()
        threading.Thread(target=self._serve, daemon=True,
                         name="vsc-dispatch").start()

    def _serve(self):
        while True:
            self.jobs.get()()


_dispatchers = threading.local()


def run_with_deadline(fn, timeout: float):
    """Run ``fn()`` on the caller's dispatch thread (a daemon thread each
    calling thread keeps for its calls); its value, or TimeoutError once
    the deadline passes (the wedged thread is abandoned, and the next call
    starts a fresh one, so the caller can still exit 100). Exceptions from
    ``fn`` propagate unchanged. ``fn`` runs in a copy of the caller's
    context, so the spans it records (``utils/profiling``) have the
    caller's "dispatch" span as parent."""
    out: list = []
    err: list = []
    done = threading.Event()

    def job(ctx):
        try:
            out.append(ctx.run(fn))
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            err.append(e)
        finally:
            done.set()

    with span("dispatch"):
        worker = getattr(_dispatchers, "worker", None)
        if worker is None:
            worker = _dispatchers.worker = _Dispatcher()
        worker.jobs.put(functools.partial(job, contextvars.copy_context()))
        finished = done.wait(timeout)
    if not finished:
        _dispatchers.worker = None
        raise TimeoutError(
            f"device dispatch exceeded its {timeout:.0f}s deadline")
    if err:
        raise err[0]
    return out[0]


def check_accelerator_health(device=None, timeout: float | None = None) -> bool:
    """Known-answer test sum([1,2,3]*2) == 12 on ``device`` (default: CUDA
    device 0 if present, else the CPU) within a deadline."""
    global _probe_succeeded_once
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if timeout is None:
        timeout = _WARM_TIMEOUT if _probe_succeeded_once else _DEFAULT_TIMEOUT
    result: list[bool] = []

    def worker():
        try:
            result.append(_run_probe(device))
        except Exception:
            result.append(False)

    t = threading.Thread(target=worker, daemon=True, name="vsc-health-probe")
    t.start()
    t.join(timeout)
    if t.is_alive() or not result or not result[0]:
        return False
    _probe_succeeded_once = True
    return True
