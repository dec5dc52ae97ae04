"""
2x2 / stride-2 ConvTranspose — CUDA kernel wrapper and plain version
====================================================================

Replaces ``vsc_tpu/ops/deconv_pallas.py:deconv2x2_pallas``, which the JAX
DepthPro reaches at every ``ConvT2x2`` site under
``VSC_TPU_PALLAS_DECONV=1`` (``vsc_tpu/models/depthpro.py:200-220``); the
port's ``models/depthpro.ConvT2x2`` takes the same route. Each output pixel
depends on one input pixel::

    out[n, o, 2i+a, 2j+b] = bias[o] + sum_c x[n, c, i, j] * w[c, o, a, b]

in PyTorch's NCHW layout with its ``[C, O, 2, 2]`` weight, accumulated in
float32, the bias added in float32, one rounding to the input dtype.
Kernel source: ``csrc/deconv.cu`` (no library call computes its body).
"""

from __future__ import annotations

import torch

from vsc_tpu_torch.ops import _cuda

__all__ = ["deconv2x2", "deconv2x2_plain", "deconv2x2_supported"]


def deconv2x2_supported(x, features: int) -> bool:
    """The JAX package's route guard (``deconv_pallas.py:40-48``) on the
    port's NCHW input: channels and features multiples of 128, H and W
    multiples of 8. Every DepthPro site at a production input size passes
    it."""
    if x.ndim != 4:
        return False
    _, C, H, W = x.shape
    return (C % 128 == 0 and features % 128 == 0
            and W % 8 == 0 and H % 8 == 0)


def deconv2x2_plain(x, weight, bias=None):
    """The plain version: the per-pixel [C] x [C, 4O] product in float32,
    the bias, the interleave, one cast to ``x.dtype``."""
    N, C, H, W = x.shape
    O = weight.shape[1]
    y = torch.einsum("nchw,coab->nohawb", x.float(), weight.float())
    if bias is not None:
        y = y + bias.float()[None, :, None, None, None, None]
    return y.reshape(N, O, 2 * H, 2 * W).to(x.dtype)


def deconv2x2(x, weight, bias=None):
    """x [N, C, H, W], weight [C, O, 2, 2], bias [O] or None -> [N, O, 2H,
    2W] in x.dtype. CPU tensors: the plain version; CUDA tensors: the
    kernel (float32 or bfloat16; x, weight and bias of one dtype)."""
    N, C, H, W = x.shape
    if weight.shape[0] != C or tuple(weight.shape[2:]) != (2, 2):
        raise ValueError(f"deconv2x2: weight {tuple(weight.shape)} does not "
                         f"fit x {tuple(x.shape)}")
    O = weight.shape[1]
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return deconv2x2_plain(x, weight, bias)
    tensors = (x, weight) + ((bias,) if bias is not None else ())
    _cuda.require_cuda("deconv2x2", *tensors)
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or any(t.dtype != x.dtype for t in tensors)):
        raise ValueError(f"deconv2x2: the kernel takes float32 or bfloat16 "
                         f"x, weight and bias of one dtype, got "
                         f"{[t.dtype for t in tensors]}")
    if C % 8 or O % 32 or (H * W) % 4 or any(t.data_ptr() % 16
                                             for t in (x, weight)):
        raise ValueError(f"deconv2x2: the kernel takes C % 8 == 0, O % 32 "
                         f"== 0, H * W % 4 == 0 and 16-byte aligned x and "
                         f"weight, got x {tuple(x.shape)}, O {O}")
    out = torch.empty((N, O, 2 * H, 2 * W), dtype=x.dtype, device=x.device)
    code = _cuda.library().vsc_deconv2x2(
        x.data_ptr(), weight.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        N, C, H, W, O, int(x.dtype == torch.bfloat16),
        _cuda.stream_ptr(x.device))
    _cuda.check(code, "vsc_deconv2x2")
    _cuda.LAUNCHES["deconv"] += 1
    return out
