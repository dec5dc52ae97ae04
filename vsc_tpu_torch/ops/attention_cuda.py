"""
Short- and long-sequence attention — CUDA kernel wrappers and plain versions
============================================================================

Three kernels. Two are the Pallas kernels of
``vsc_tpu/ops/attention_pallas.py`` (the ViT attention of
``vsc_tpu/models/vit.py``), both full-row softmax attention with one
semantics (f32 logits * scale, row max, exp, f32 row sum, p rounded to the
input dtype, PV accumulated in f32, divided by the row sum):

  qkv_attention        replaces ``qkv_short_seq_attention``: read straight
                       from the fused qkv projection. The JAX kernel reads a
                       per-head interleaved projection (a TPU lane-tiling
                       choice); the port keeps PyTorch's plain [q | k | v]
                       layout and reads it through strides. Kernel source:
                       ``csrc/attention.cu`` (bf16, head dim 64, at most
                       ``QKV_MAX_T`` tokens: each head's K and V and every
                       query row's logits stay on chip).
  short_seq_attention  replaces ``short_seq_attention``: separate q, k, v
                       [B, T, H, Dh], here strided views of the fused
                       projection (no copies). Kernel source:
                       ``csrc/attention_split.cu`` (float32 or bf16, head
                       dims 16, 32, ..., 128, any T): up to
                       ``SPLIT_RESIDENT_T`` tokens on its resident route (a
                       block's [64, T] f32 logits stay in shared memory),
                       beyond on its two-pass route (the logits computed
                       twice, once for the row max), which gives the same
                       bits.

The third has no Pallas site of its own; it takes the bf16 head-dim-64
case past the qkv kernel's range (Depth Anything V2's 2,443 tokens):

  flash_attention      one pass over the keys in tiles of ``FLASH_KEYS``
                       with the online softmax (the row max and sum carried
                       from tile to tile, p rounded to bf16 at the running
                       max), read from the fused qkv like the qkv kernel.
                       Kernel source: ``csrc/attention_flash.cu`` (bf16,
                       head dim 64, any T). Its plain version
                       ``flash_attention_plain`` repeats its order; the
                       function is the one above within bf16's rounding of
                       p.

``attention``, the one entry the ViT calls, runs the kernel that
``attention_route`` picks by dtype, head dim and token count: the qkv
kernel for bf16 at head dim 64 (the production DepthPro at input 1536) up
to ``QKV_MAX_T`` tokens, the flash kernel for bf16 at head dim 64 beyond,
the split kernel for every other case it takes, an error for the rest.
The JAX package sends head dim 64 in float32 to its qkv kernel too
(its lane group exists for any dtype, and it pads T to a multiple of 8 at
any size); the port sends it to the split kernel, which computes the same
function. ``_cuda.ROUTE_LAUNCHES`` counts the split kernel's launches by
route and the flash kernel's as "flash".
"""

from __future__ import annotations

import torch

from vsc_tpu_torch.ops import _cuda

__all__ = ["attention", "qkv_attention", "qkv_attention_plain",
           "short_seq_attention", "short_seq_attention_plain",
           "flash_attention", "flash_attention_plain", "attention_route",
           "split_route", "SPLIT_HEAD_DIMS", "QKV_MAX_T", "SPLIT_RESIDENT_T",
           "FLASH_KEYS"]

HEAD_DIM = 64
QKV_MAX_T = 640     # the qkv kernel's key range (csrc/attention.cu kTmax)
SPLIT_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
# the split kernel's resident route's key range (csrc/attention_split.cu
# kTmax); its two-pass route takes any T
SPLIT_RESIDENT_T = 640
FLASH_KEYS = 128    # the flash kernel's key tile (attention_flash.cu kKeys)
_SPLIT_DTYPES = (torch.float32, torch.bfloat16)


def split_route(tokens: int) -> str:
    """The split kernel's route at ``tokens`` keys: "split" (resident) up
    to ``SPLIT_RESIDENT_T``, "split_two_pass" beyond."""
    return "split" if tokens <= SPLIT_RESIDENT_T else "split_two_pass"


def attention_route(dtype, head_dim: int, tokens: int | None = None) -> str:
    """The kernel that runs attention at this dtype and head dim: "qkv"
    (bf16, head dim 64, at most ``QKV_MAX_T`` tokens: ``qkv_attention``'s
    own kernel), "flash" (bf16, head dim 64, more tokens:
    ``flash_attention``) or the split kernel (float32 or bf16 at a head dim
    of ``SPLIT_HEAD_DIMS``, at any token count), as ``split_route(tokens)``
    names its route ("split" without ``tokens``); raises ValueError for
    anything else."""
    if dtype == torch.bfloat16 and head_dim == HEAD_DIM:
        return "qkv" if tokens is None or tokens <= QKV_MAX_T else "flash"
    if dtype in _SPLIT_DTYPES and head_dim in SPLIT_HEAD_DIMS:
        return "split" if tokens is None else split_route(tokens)
    raise ValueError(f"attention: no kernel takes {dtype} at head dim "
                     f"{head_dim} (qkv and flash kernels: bfloat16 at "
                     f"{HEAD_DIM}; split kernel: float32 or bfloat16 at "
                     f"{SPLIT_HEAD_DIMS})")


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
    the kernel (float32 or bf16, Dh in ``SPLIT_HEAD_DIMS``, pointers and
    strides on 16-byte boundaries) on the route ``split_route(T)`` names."""
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
    two_pass = split_route(T) == "split_two_pass"
    size = q.element_size()
    if any(x.data_ptr() % 16 for x in (q, k, v)) or any(
            s * size % 16 for s in q.stride()[:3]):
        # the kernel copies q, k and v rows as 16-byte vectors
        raise ValueError("short_seq_attention: q, k and v must start on "
                         "16-byte boundaries, with strides of whole 16-byte "
                         "units")
    out = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    sb, st, sh, _ = q.stride()
    code = _cuda.library().vsc_split_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H,
        Dh, sb, st, sh, float(scale), int(q.dtype == torch.bfloat16),
        int(two_pass), _cuda.stream_ptr(q.device))
    _cuda.check(code, "vsc_split_attention")
    _cuda.LAUNCHES["attention_split"] += 1
    _cuda.ROUTE_LAUNCHES["split_two_pass" if two_pass else "split"] += 1
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


def attention(qkv, num_heads: int, scale: float):
    """qkv [B, T, 3D] ([q | k | v], PyTorch's fused projection) -> [B, T,
    D] on the kernel ``attention_route`` names for its dtype, head dim and
    T: ``qkv_attention`` or ``flash_attention`` on the contiguous qkv, or
    ``short_seq_attention`` on strided q, k, v views of it (no copies). On
    CPU tensors each runs its plain version."""
    B, T, D3 = qkv.shape
    Dh = D3 // (3 * num_heads)
    route = attention_route(qkv.dtype, Dh, T)
    if route == "qkv":
        return qkv_attention(qkv.contiguous(), num_heads, scale)
    if route == "flash":
        return flash_attention(qkv.contiguous(), num_heads, scale)
    q, k, v = qkv.view(B, T, 3, num_heads, Dh).unbind(2)
    return short_seq_attention(q, k, v, scale).reshape(B, T, -1)


def qkv_attention(qkv, num_heads: int, scale: float):
    """CPU tensors: the plain version; CUDA tensors: the kernel (bf16, head
    dim 64, at most ``QKV_MAX_T`` tokens)."""
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, num_heads, scale)
    _cuda.require_cuda("qkv_attention", qkv)
    N, T, D3 = qkv.shape
    if (qkv.dtype != torch.bfloat16 or D3 != 3 * num_heads * HEAD_DIM
            or T > QKV_MAX_T):
        raise ValueError(f"qkv_attention: the kernel takes bfloat16 "
                         f"[N, T, 3 * heads * {HEAD_DIM}] with T at most "
                         f"{QKV_MAX_T}, got {tuple(qkv.shape)} {qkv.dtype} "
                         f"with {num_heads} heads")
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


def flash_attention_plain(qkv, num_heads: int, scale: float,
                          keys: int = FLASH_KEYS):
    """qkv [N, T, 3D] ([q | k | v]) -> [N, T, D] in the flash kernel's
    order: the keys in tiles of ``keys``; per tile f32 logits * scale, the
    running row max m raised to the tile's, the running sum and output
    scaled by exp(m_old - m_new), p = exp(s - m) summed in f32 and cast to
    the input dtype before PV with f32 accumulation; divided by the sum at
    the end."""
    N, T, D3 = qkv.shape
    D = D3 // 3
    Dh = D // num_heads

    def heads(x):
        return x.reshape(N, T, num_heads, Dh).transpose(1, 2).float()

    q, k, v = (heads(x) for x in qkv.split(D, dim=-1))
    m = torch.full((N, num_heads, T, 1), -torch.inf, device=qkv.device)
    total = torch.zeros_like(m)
    acc = torch.zeros((N, num_heads, T, Dh), device=qkv.device)
    for k0 in range(0, T, keys):
        s = torch.matmul(q, k[:, :, k0:k0 + keys].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p32 = torch.exp(s - m_new)
        total = total * alpha + p32.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p32.to(qkv.dtype).float(),
                                         v[:, :, k0:k0 + keys])
        m = m_new
    out = (acc / total).to(qkv.dtype)
    return out.transpose(1, 2).reshape(N, T, D)


def flash_attention(qkv, num_heads: int, scale: float):
    """qkv [N, T, 3D] ([q | k | v], head dim 64) -> [N, T, D]. CPU
    tensors: the plain version; CUDA tensors: the kernel (bf16, contiguous
    qkv on a 16-byte boundary, any T)."""
    if qkv.device.type == "cpu":
        return flash_attention_plain(qkv, num_heads, scale)
    _cuda.require_cuda("flash_attention", qkv)
    N, T, D3 = qkv.shape
    if qkv.dtype != torch.bfloat16 or D3 != 3 * num_heads * HEAD_DIM:
        raise ValueError(f"flash_attention: the kernel takes bfloat16 "
                         f"[N, T, 3 * heads * {HEAD_DIM}], got "
                         f"{tuple(qkv.shape)} {qkv.dtype} with "
                         f"{num_heads} heads")
    if qkv.data_ptr() % 16:
        # the kernel reads q, k and v rows as 16-byte vectors
        raise ValueError("flash_attention: qkv must start on a 16-byte "
                         "boundary")
    out = torch.empty((N, T, D3 // 3), dtype=qkv.dtype, device=qkv.device)
    code = _cuda.library().vsc_flash_attention(
        qkv.data_ptr(), out.data_ptr(), N, T, num_heads, float(scale),
        _cuda.stream_ptr(qkv.device))
    _cuda.check(code, "vsc_flash_attention")
    _cuda.LAUNCHES["attention_flash"] += 1
    _cuda.ROUTE_LAUNCHES["flash"] += 1
    return out
