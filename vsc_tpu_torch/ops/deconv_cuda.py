"""
2x2 / stride-2 ConvTranspose — CUDA kernel wrapper and plain version
====================================================================

Replaces ``vsc_tpu/ops/deconv_pallas.py:deconv2x2_pallas``, which the JAX
DepthPro reaches at every ``ConvT2x2`` site under
``VSC_TPU_PALLAS_DECONV=1`` (``vsc_tpu/models/depthpro.py:200-220``); the
port's ``models/depthpro.ConvT2x2`` takes the same route. Each output pixel
depends on one input pixel::

    out[n, o, 2i+a, 2j+b] = bias[o] + sum_c x[n, c, i, j] * w[c, o, a, b]

on PyTorch's [N, C, H, W] shape with its ``[C, O, 2, 2]`` weight,
accumulated in float32, the bias added in float32, one rounding to the
input dtype. The kernel reads channels-last memory, which is what the
port's DepthPro hands every site, and writes a channels-last output, as
``conv_transpose2d`` does for such an input. Kernel source:
``csrc/deconv.cu`` (no library call computes its body).
"""

from __future__ import annotations

import torch

from vsc_tpu_torch.ops import _cuda

__all__ = ["deconv2x2", "deconv2x2_plain", "deconv2x2_supported",
           "pack_weight"]


def deconv2x2_supported(x, features: int) -> bool:
    """The JAX package's route guard (``deconv_pallas.py:40-48``): channels
    and features multiples of 128, H and W multiples of 8, with C, H and W
    read from the [N, C, H, W] shape whatever the memory format. Every
    DepthPro site at a production input size passes it."""
    if x.ndim != 4:
        return False
    _, C, H, W = x.shape
    return (C % 128 == 0 and features % 128 == 0
            and W % 8 == 0 and H % 8 == 0)


def _nhwc_batch_stride(x):
    """x's batch stride in elements where each of its images lies in
    channels-last memory (a dense [H, W, C]), else None. The batch may be
    spaced wider than an image: the slice of a token sequence that drops
    its cls token (models/depthpro._tokens_to_map) leaves it so."""
    N, C, H, W = x.shape
    if N == 0 or not x[0].permute(1, 2, 0).is_contiguous():
        return None
    sb = x.stride(0) if N > 1 else H * W * C
    return sb if sb >= H * W * C else None


def _channels_last(x) -> bool:
    """conv_transpose2d's rule: a channels-last output for an input whose
    images are channels-last and that is not also NCHW-contiguous."""
    return _nhwc_batch_stride(x) is not None and not x.is_contiguous()


def deconv2x2_plain(x, weight, bias=None):
    """The plain version: the per-pixel [C] x [C, 4O] product in float32,
    the bias, the interleave, one cast to ``x.dtype``; the output in the
    memory format ``conv_transpose2d`` gives for ``x``."""
    N, C, H, W = x.shape
    O = weight.shape[1]
    y = torch.einsum("nchw,coab->nohawb", x.float(), weight.float())
    if bias is not None:
        y = y + bias.float()[None, :, None, None, None, None]
    y = y.reshape(N, O, 2 * H, 2 * W).to(x.dtype)
    return (y.contiguous(memory_format=torch.channels_last)
            if _channels_last(x) else y)


def pack_weight(weight):
    """torch's [C, O, 2, 2] weight -> the kernel's [4O, C]: row
    a*2O + b*O + o holds w[:, o, a, b], so for each output-row phase a the
    2O columns (b, o) of one pixel are one contiguous span of the
    channels-last output."""
    C, O = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(4 * O, C).contiguous()


def deconv2x2(x, weight, bias=None, packed=None):
    """x [N, C, H, W], weight [C, O, 2, 2], bias [O] or None -> [N, O, 2H,
    2W] in x.dtype. ``packed`` is ``pack_weight(weight)`` where the caller
    keeps it (models/depthpro.ConvT2x2 does), else it is packed here. CPU
    tensors: the plain version; CUDA tensors: the kernel (float32 or
    bfloat16; x, weight and bias of one dtype), which reads x in
    channels-last memory only (each image a dense [H, W, C], any batch
    stride; it raises otherwise, e.g. on NCHW memory) and returns a
    channels-last output."""
    N, C, H, W = x.shape
    if weight.shape[0] != C or tuple(weight.shape[2:]) != (2, 2):
        raise ValueError(f"deconv2x2: weight {tuple(weight.shape)} does not "
                         f"fit x {tuple(x.shape)}")
    O = weight.shape[1]
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return deconv2x2_plain(x, weight, bias)
    tensors = (x, weight) + ((bias,) if bias is not None else ())
    _cuda.require_cuda("deconv2x2", *tensors, contiguous=False)
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or any(t.dtype != x.dtype for t in tensors)):
        raise ValueError(f"deconv2x2: the kernel takes float32 or bfloat16 "
                         f"x, weight and bias of one dtype, got "
                         f"{[t.dtype for t in tensors]}")
    sb = _nhwc_batch_stride(x)
    if sb is None:
        raise ValueError("deconv2x2: the kernel reads x in channels-last "
                         "memory (x.contiguous(memory_format="
                         "torch.channels_last))")
    if C % 8 or O % 64 or sb % 8 or x.data_ptr() % 16:
        raise ValueError(f"deconv2x2: the kernel takes C % 8 == 0, O % 64 "
                         f"== 0 and a 16-byte aligned x and batch stride, "
                         f"got x {tuple(x.shape)} (batch stride {sb}), O {O}")
    if packed is None:
        packed = pack_weight(weight)
    if (packed.shape != (4 * O, C) or packed.dtype != x.dtype
            or packed.device != x.device or not packed.is_contiguous()):
        raise ValueError("deconv2x2: packed is not pack_weight(weight)")
    if bias is not None:
        bias = bias.contiguous()
    out = torch.empty((N, O, 2 * H, 2 * W), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    code = _cuda.library().vsc_deconv2x2(
        x.data_ptr(), packed.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        N, C, H, W, O, sb, int(x.dtype == torch.bfloat16),
        _cuda.stream_ptr(x.device))
    _cuda.check(code, "vsc_deconv2x2")
    _cuda.LAUNCHES["deconv"] += 1
    return out
