"""
Residual add + LayerScale + LayerNorm — CUDA kernel wrapper and plain version
=============================================================================

Between the ViT's sublayers (``models/vit.py``) the stream ``x`` takes the
sublayer's output ``y`` through its LayerScale, and the next sublayer reads
the LayerNorm of the result::

    x_new = x + gamma * y
    h     = LayerNorm(x_new) * weight + bias

This does both in one pass: it reads ``x`` and ``y`` and writes ``x_new``
and ``h``, where the LayerScale multiply, the residual add and the
LayerNorm each take a pass of their own as separate ATen kernels. No
Pallas site: the JAX package leaves the step to XLA's fusion. Arithmetic in
float32: ``x_new`` rounded once to the tensors' dtype, the LayerNorm taken
on that stored ``x_new`` (what the next residual and the hooks see), ``h``
rounded once. Kernel source: ``csrc/residual_norm.cu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vsc_tpu_torch.ops import _cuda

__all__ = ["residual_norm", "residual_norm_plain", "residual_norm_supported",
           "MAX_D"]

MAX_D = 4096        # the widest row the kernel holds in registers


def residual_norm_supported(x) -> bool:
    """The kernel's range: bf16 or float32 with a last dimension D that is
    a multiple of 8 up to ``MAX_D`` (ViT-L's 1024 and the tiny test
    configs' 32 both are). Elsewhere the ViT keeps the separate ops."""
    D = x.shape[-1] if x.ndim else 0
    return (x.dtype in (torch.float32, torch.bfloat16) and D % 8 == 0
            and 8 <= D <= MAX_D)


def residual_norm_plain(x, y, gamma, weight, bias, eps: float):
    """The plain version, in the kernel's order of roundings: ``x + y *
    gamma`` in float32 rounded once to x.dtype, then ``F.layer_norm`` in
    float32 on that rounded stream, rounded once. In float32 it is
    ``x + LayerScale(y)`` then ``nn.LayerNorm`` bit for bit."""
    x_new = (x.float() + y.float() * gamma.float()).to(x.dtype)
    h = F.layer_norm(x_new.float(), (x.shape[-1],), weight.float(),
                     bias.float(), eps)
    return x_new, h.to(x.dtype)


def residual_norm(x, y, gamma, weight, bias, eps: float):
    """x, y [..., D]; gamma, weight, bias [D] -> (x_new, h), two new
    tensors of x's shape and dtype; x and y are not written. CPU tensors:
    the plain version; CUDA tensors: the kernel, which takes contiguous,
    16-byte aligned tensors of one dtype (bf16 or float32) with D a
    multiple of 8 up to ``MAX_D``, and raises ValueError on anything else."""
    D = x.shape[-1]
    tensors = (x, y, gamma, weight, bias)
    if tuple(y.shape) != tuple(x.shape) or any(
            tuple(t.shape) != (D,) for t in tensors[2:]):
        raise ValueError(f"residual_norm: x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}, gamma / weight / bias "
                         f"{[tuple(t.shape) for t in tensors[2:]]}")
    if all(t.device.type == "cpu" for t in tensors):
        return residual_norm_plain(x, y, gamma, weight, bias, eps)
    _cuda.require_cuda("residual_norm", *tensors)
    if not residual_norm_supported(x) or any(t.dtype != x.dtype
                                             for t in tensors):
        raise ValueError(f"residual_norm: the kernel takes bf16 or float32 "
                         f"tensors of one dtype with D a multiple of 8 up "
                         f"to {MAX_D}, got D {D}, "
                         f"{[t.dtype for t in tensors]}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("residual_norm: the kernel takes 16-byte aligned "
                         "tensors")
    x_new, h = torch.empty_like(x), torch.empty_like(x)
    code = _cuda.library().vsc_residual_norm(
        x.data_ptr(), y.data_ptr(), gamma.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), x_new.data_ptr(), h.data_ptr(), x.numel() // D, D,
        eps, int(x.dtype == torch.bfloat16), _cuda.stream_ptr(x.device))
    _cuda.check(code, "vsc_residual_norm")
    _cuda.LAUNCHES["residual_norm"] += 1
    return x_new, h
