"""
qkv-native short-sequence attention — CUDA kernel wrapper and plain version
===========================================================================

Replaces ``vsc_tpu/ops/attention_pallas.py:qkv_short_seq_attention`` (the
ViT attention of ``vsc_tpu/models/vit.py``): full-row softmax attention
read straight from the fused qkv projection. The JAX kernel reads a
per-head interleaved projection (a TPU lane-tiling choice); the port keeps
PyTorch's plain [q | k | v] layout and the kernel reads it through strides.
Kernel source: ``csrc/attention.cu`` (bf16, head dim 64).
"""

from __future__ import annotations

import torch

from vsc_tpu_torch.ops import _cuda

__all__ = ["qkv_attention", "qkv_attention_plain"]

HEAD_DIM = 64


def qkv_attention_plain(qkv, num_heads: int, scale: float):
    """qkv [N, T, 3D] ([q | k | v]) -> [N, T, D]: f32 logits * scale, max
    subtract, exp, f32 row sum, p cast to the input dtype before PV with f32
    accumulation, divided by the row sum."""
    N, T, D3 = qkv.shape
    D = D3 // 3
    Dh = D // num_heads

    def heads(x):
        return x.reshape(N, T, num_heads, Dh).transpose(1, 2).float()

    q, k, v = (heads(x) for x in qkv.split(D, dim=-1))
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    logits = logits - logits.amax(dim=-1, keepdim=True)
    p32 = torch.exp(logits)
    denom = p32.sum(dim=-1, keepdim=True)
    out = torch.matmul(p32.to(qkv.dtype).float(), v)
    out = (out / denom).to(qkv.dtype)
    return out.transpose(1, 2).reshape(N, T, D)


def qkv_attention(qkv, num_heads: int, scale: float):
    """CPU tensors: the plain version; CUDA tensors: the kernel (bf16,
    head dim 64)."""
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, num_heads, scale)
    _cuda.require_cuda("qkv_attention", qkv)
    N, T, D3 = qkv.shape
    if qkv.dtype != torch.bfloat16 or D3 != 3 * num_heads * HEAD_DIM:
        raise ValueError(f"qkv_attention: the kernel takes bfloat16 "
                         f"[N, T, 3 * heads * {HEAD_DIM}], got "
                         f"{tuple(qkv.shape)} {qkv.dtype} with "
                         f"{num_heads} heads")
    if qkv.data_ptr() % 16:
        # the kernel reads q, k and v rows as 16-byte vectors
        raise ValueError("qkv_attention: qkv must start on a 16-byte "
                         "boundary")
    out = torch.empty((N, T, D3 // 3), dtype=qkv.dtype, device=qkv.device)
    code = _cuda.library().vsc_qkv_attention(
        qkv.data_ptr(), out.data_ptr(), N, T, num_heads, float(scale),
        _cuda.stream_ptr(qkv.device))
    _cuda.check(code, "vsc_qkv_attention")
    _cuda.LAUNCHES["attention"] += 1
    return out
