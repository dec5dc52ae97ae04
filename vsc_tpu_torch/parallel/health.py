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
import os
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


def run_with_deadline(fn, timeout: float):
    """Run ``fn()`` on a daemon thread; its value, or TimeoutError once the
    deadline passes (the wedged thread is abandoned so the caller can still
    exit 100). Exceptions from ``fn`` propagate unchanged. The thread runs
    in a copy of the caller's context, so the spans ``fn`` records
    (``utils/profiling``) have the caller's "dispatch" span as parent."""
    out: list = []
    err: list = []

    def worker():
        try:
            out.append(fn())
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            err.append(e)

    with span("dispatch"):
        t = threading.Thread(target=contextvars.copy_context().run,
                             args=(worker,), daemon=True, name="vsc-dispatch")
        t.start()
        t.join(timeout)
    if t.is_alive():
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
