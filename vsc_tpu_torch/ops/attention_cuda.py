"""
Short-sequence attention — CUDA kernel wrappers and plain versions
==================================================================

Two kernels, the two Pallas kernels of ``vsc_tpu/ops/attention_pallas.py``
(the ViT attention of ``vsc_tpu/models/vit.py``), both full-row softmax
attention with one semantics (f32 logits * scale, row max, exp, f32 row
sum, p rounded to the input dtype, PV accumulated in f32, divided by the
row sum):

  qkv_attention        replaces ``qkv_short_seq_attention``: read straight
                       from the fused qkv projection. The JAX kernel reads a
                       per-head interleaved projection (a TPU lane-tiling
                       choice); the port keeps PyTorch's plain [q | k | v]
                       layout and reads it through strides. Kernel source:
                       ``csrc/attention.cu`` (bf16, head dim 64).
  short_seq_attention  replaces ``short_seq_attention``: separate q, k, v
                       [B, T, H, Dh], here strided views of the fused
                       projection (no copies). Kernel source:
                       ``csrc/attention_split.cu`` (float32 or bf16, head
                       dims 16, 32, ..., 128).

``attention_route`` picks between them by dtype and head dim: the qkv
kernel for bf16 at head dim 64 (the production DepthPro), the split kernel
for every other pair it takes, an error for the rest. The JAX package sends
head dim 64 in float32 to its qkv kernel too (its lane group exists for any
dtype); the port sends it to the split kernel, which computes the same
function.
"""

from __future__ import annotations

import torch

from vsc_tpu_torch.ops import _cuda

__all__ = ["qkv_attention", "qkv_attention_plain", "short_seq_attention",
           "short_seq_attention_plain", "attention_route", "SPLIT_HEAD_DIMS"]

HEAD_DIM = 64
SPLIT_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
_SPLIT_DTYPES = (torch.float32, torch.bfloat16)


def attention_route(dtype, head_dim: int) -> str:
    """"qkv" (bf16, head dim 64: ``qkv_attention``) or "split" (float32 or
    bf16 at a head dim of ``SPLIT_HEAD_DIMS``: ``short_seq_attention``);
    raises ValueError for anything else."""
    if dtype == torch.bfloat16 and head_dim == HEAD_DIM:
        return "qkv"
    if dtype in _SPLIT_DTYPES and head_dim in SPLIT_HEAD_DIMS:
        return "split"
    raise ValueError(f"attention: no kernel takes {dtype} at head dim "
                     f"{head_dim} (qkv kernel: bfloat16 at {HEAD_DIM}; split "
                     f"kernel: float32 or bfloat16 at {SPLIT_HEAD_DIMS})")


def short_seq_attention_plain(q, k, v, scale: float):
    """q, k, v [B, T, H, Dh] -> [B, T, H, Dh], the semantics above."""
    qf, kf, vf = (x.transpose(1, 2).float() for x in (q, k, v))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    logits = logits - logits.amax(dim=-1, keepdim=True)
    p32 = torch.exp(logits)
    denom = p32.sum(dim=-1, keepdim=True)
    out = torch.matmul(p32.to(q.dtype).float(), vf)
    return (out / denom).to(q.dtype).transpose(1, 2).contiguous()


def short_seq_attention(q, k, v, scale: float):
    """q, k, v [B, T, H, Dh] (views with a unit last stride and one set of
    batch / token / head strides, e.g. of the fused qkv projection) ->
    contiguous [B, T, H, Dh]. CPU tensors: the plain version; CUDA tensors:
    the kernel (float32 or bf16, Dh in ``SPLIT_HEAD_DIMS``)."""
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return short_seq_attention_plain(q, k, v, scale)
    B, T, H, Dh = q.shape
    for x in (q, k, v):
        if not x.is_cuda:
            raise ValueError(f"short_seq_attention: expected CUDA tensors, "
                             f"got a tensor on {x.device}")
        if (x.shape != q.shape or x.dtype != q.dtype
                or x.stride() != q.stride() or x.stride(-1) != 1):
            raise ValueError("short_seq_attention: q, k and v need one "
                             "shape, dtype and set of strides, with a unit "
                             "last stride")
    if q.dtype not in _SPLIT_DTYPES or Dh not in SPLIT_HEAD_DIMS:
        raise ValueError(f"short_seq_attention: the kernel takes float32 or "
                         f"bfloat16 at head dims {SPLIT_HEAD_DIMS}, got "
                         f"{q.dtype} at {Dh}")
    out =torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    sb, st, sh, _ = q.stride()
    code = _cuda.library().vsc_split_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H,
        Dh, sb, st, sh, float(scale), int(q.dtype == torch.bfloat16),
        _cuda.stream_ptr(q.device))
    _cuda.check(code, "vsc_split_attention")
    _cuda.LAUNCHES["attention_split"] += 1
    return out


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
