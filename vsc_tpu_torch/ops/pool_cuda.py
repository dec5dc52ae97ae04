"""
Pyramid prepass pools — CUDA kernel wrappers and plain versions
===============================================================

Replaces ``vsc_tpu/ops/pool_pallas.py`` and, at frame sizes its kernels
refuse, the jnp pool glue of ``vsc_tpu/ops/inpaint.py``:

  avgpool4_eye4  [4, B, H, W] uint8 (r, g, b, valid), any H, W >= 1 ->
      [4, B, ceil(ceil(H/2)/2), ceil(ceil(W/2)/2)] float32 means of
      (rgb * valid, valid) over two 2x2 levels, each edge-padding an odd
      side first: the quarter stack of the planar-u8 branch, in one launch
  avgpool2_eye4  the same, one level, H and W even
  avgpool2       [N, H, W] float32 -> [N, H/2, W/2], H and W even

All are bit-exact against the plain 2x2 ladder (``ops/inpaint.py``
``_avgpool2_hw``), which is what the plain versions run. Kernel source:
``csrc/pool.cu``; one launch counter, ``pool``, for the three kernels, and
``_cuda.ROUTE_LAUNCHES["pool_edge"]`` for the ``avgpool4_eye4`` launches
whose H or W is not a multiple of 4 (an edge clamp fires).
"""

from __future__ import annotations

import torch

from vsc_tpu_torch.ops import _cuda
from vsc_tpu_torch.ops.inpaint import _avgpool2_hw

__all__ = ["avgpool2_eye4", "avgpool4_eye4", "avgpool2",
           "avgpool_eye4_plain", "avgpool2_plain"]


def avgpool_eye4_plain(eye4, f: int):
    """The plain version of the eye4 pools (f = 2 or 4)."""
    msk = eye4[3].to(torch.float32)
    x = torch.cat([eye4[:3].to(torch.float32) * msk, msk[None]])
    for _ in range(f.bit_length() - 1):
        x = _avgpool2_hw(x)
    return x


def avgpool2_plain(planes):
    return _avgpool2_hw(planes)


def _eye4(eye4, f: int):
    if eye4.dim() != 4 or eye4.shape[0] != 4 or 0 in eye4.shape:
        raise ValueError(f"avgpool{f}_eye4: need a non-empty [4, B, H, W], "
                         f"got {tuple(eye4.shape)}")
    K, B, H, W = eye4.shape
    if f == 2 and (H % 2 or W % 2):
        raise ValueError(f"avgpool2_eye4: need even H, W, got "
                         f"{tuple(eye4.shape)}")
    if eye4.dtype != torch.uint8:
        raise ValueError(f"avgpool{f}_eye4: need uint8, got {eye4.dtype}")
    if eye4.device.type == "cpu":
        return avgpool_eye4_plain(eye4, f)
    _cuda.require_cuda(f"avgpool{f}_eye4", eye4)
    qh, qw = (-(-n // f) for n in (H, W))
    out = torch.empty((4, B, qh, qw), dtype=torch.float32, device=eye4.device)
    code = _cuda.library().vsc_pool_eye4(
        eye4.data_ptr(), out.data_ptr(), B, H, W, f,
        _cuda.stream_ptr(eye4.device))
    _cuda.check(code, "vsc_pool_eye4")
    _cuda.LAUNCHES["pool"] += 1
    if f == 4 and (H | W) & 3:
        _cuda.ROUTE_LAUNCHES["pool_edge"] += 1
    return out


def avgpool2_eye4(eye4):
    """[4, B, H, W] uint8, H and W even -> [4, B, H/2, W/2] float32."""
    return _eye4(eye4, 2)


def avgpool4_eye4(eye4):
    """[4, B, H, W] uint8, any H, W >= 1 -> [4, B, ceil(H/4), ceil(W/4)]
    float32, equal to two 2x2 levels that each edge-pad an odd side."""
    return _eye4(eye4, 4)


def avgpool2(planes):
    """[N, H, W] float32, H and W even -> [N, H/2, W/2] float32."""
    N, H, W = planes.shape
    if H % 2 or W % 2:
        raise ValueError(f"avgpool2: need even H, W, got {tuple(planes.shape)}")
    if planes.device.type == "cpu":
        return avgpool2_plain(planes)
    _cuda.require_cuda("avgpool2", planes)
    if planes.dtype != torch.float32:
        raise ValueError(f"avgpool2: need float32, got {planes.dtype}")
    out = torch.empty((N, H // 2, W // 2), dtype=torch.float32,
                      device=planes.device)
    code = _cuda.library().vsc_pool2(planes.data_ptr(), out.data_ptr(), N, H,
                                     W, _cuda.stream_ptr(planes.device))
    _cuda.check(code, "vsc_pool2")
    _cuda.LAUNCHES["pool"] += 1
    return out
