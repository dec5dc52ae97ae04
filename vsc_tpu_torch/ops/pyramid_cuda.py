"""
Masked push-pull pyramid below the handoff level — CUDA kernel wrapper
======================================================================

Replaces ``vsc_tpu/ops/pyramid_pallas.py:pyramid_fill_below``: quarter
[4, N, h, w] float32 (r, g, b pooled img * valid, then the pooled valid)
-> [3, N, h, w] float32 push-pull estimate, the whole level ladder down to
1 x 1 and back in one launch. Its plain version is the torch ladder
(``ops/inpaint.py`` ``_push_pull_hw``), level for level bit-identical.
Kernel source: ``csrc/pyramid.cu``.
"""

from __future__ import annotations

import torch

from vsc_tpu_torch.ops import _cuda
from vsc_tpu_torch.ops.inpaint import _push_pull_hw

__all__ = ["pyramid_fill_below", "pyramid_fill_below_plain"]


def pyramid_fill_below_plain(quarter):
    return _push_pull_hw(quarter[:3], quarter[3])


def _workspace_floats(h: int, w: int) -> int:
    """Floats of the four planes of every level below the input."""
    n = 0
    while h > 1 or w > 1:
        h, w = (h + 1) // 2, (w + 1) // 2
        n += 4 * h * w
    return n


def pyramid_fill_below(quarter):
    """CPU tensors: the plain version; CUDA tensors: the kernel."""
    K, N, h, w = quarter.shape
    if K != 4:
        raise ValueError(f"pyramid_fill_below: need [4, N, h, w], got "
                         f"{tuple(quarter.shape)}")
    if quarter.device.type == "cpu":
        return pyramid_fill_below_plain(quarter)
    _cuda.require_cuda("pyramid_fill_below", quarter)
    if quarter.dtype != torch.float32:
        raise ValueError(f"pyramid_fill_below: need float32, got "
                         f"{quarter.dtype}")
    dev = quarter.device
    out = torch.empty((3, N, h, w), dtype=torch.float32, device=dev)
    per_frame = max(_workspace_floats(h, w), 1)
    ws = torch.empty((N, per_frame), dtype=torch.float32, device=dev)
    code = _cuda.library().vsc_pyramid(
        quarter.data_ptr(), out.data_ptr(), ws.data_ptr(), N, h, w, per_frame,
        _cuda.stream_ptr(dev))
    _cuda.check(code, "vsc_pyramid")
    _cuda.LAUNCHES["pyramid"] += 1
    return out
