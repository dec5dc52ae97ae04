"""
Masked push-pull pyramid — CUDA kernel wrapper
==============================================

Replaces ``vsc_tpu/ops/pyramid_pallas.py:pyramid_fill_below`` and the
torch glue levels the JAX package runs above its handoff
(``VSC_TPU_PYR_KMAX``): quarter [4, N, h, w] float32 (r, g, b pooled
img * valid, then the pooled valid) -> [3, N, h, w] float32 push-pull
estimate, the whole level ladder down to 1 x 1 and back. Its plain version
is the torch ladder (``ops/inpaint.py`` ``_push_pull_hw``), level for
level bit-identical. Kernel source:
``csrc/pyramid.cu`` (three launches: a down pass and an up pass over
32 x 32 regions on every SM, the small levels between them in one block
per frame), counted as one. The wrapper keeps the name of the Pallas
entry it replaces, though nothing is left above it.
"""

from __future__ import annotations

import ctypes

import torch

from vsc_tpu_torch.ops import _cuda
from vsc_tpu_torch.ops.inpaint import _push_pull_hw

__all__ = ["pyramid_fill_below", "pyramid_fill_below_plain"]


def pyramid_fill_below_plain(quarter):
    return _push_pull_hw(quarter[:3], quarter[3])


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
    lib = _cuda.library()
    n_ws = ctypes.c_longlong()
    _cuda.check(lib.vsc_pyramid_workspace(N, h, w, ctypes.byref(n_ws)),
                "vsc_pyramid_workspace")
    out = torch.empty((3, N, h, w), dtype=torch.float32, device=dev)
    ws = torch.empty((n_ws.value,), dtype=torch.float32, device=dev)
    code = lib.vsc_pyramid(quarter.data_ptr(), out.data_ptr(), ws.data_ptr(),
                           N, h, w, n_ws.value, _cuda.stream_ptr(dev))
    _cuda.check(code, "vsc_pyramid")
    _cuda.LAUNCHES["pyramid"] += 1
    return out
