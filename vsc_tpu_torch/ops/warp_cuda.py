"""
Forward stereo warp — CUDA kernel wrapper and plain version
===========================================================

Replaces ``vsc_tpu/ops/warp_pallas.py:_warp_planes`` (entries
``forward_warp_stereo_pallas``, channel-last float32 image, and
``forward_warp_stereo_pallas_planar_u8``, planar [B, 3, H, W] uint8 image):
both eyes of the gather warp, emitted as the [4, B, H, W] uint8 (r, g, b,
valid) stacks the postprocess consumes. Colors are floor(clip(., 0, 255))
of the winning source pixel; the winner rule is ops/warp.py's, bit for bit.
Kernel source: ``csrc/warp.cu`` (a scatter of each source to its two
possible targets with a 64-bit max, templated on the color loader).
``forward_warp_pair_planar`` writes both eyes straight into the [4, 2B, H,
W] pair the planar-u8 branch goes on with (left eye first).
"""

from __future__ import annotations

import torch

from vsc_tpu_torch.ops import _cuda

__all__ = ["forward_warp_eyes", "forward_warp_eyes_plain",
           "forward_warp_eyes_planar", "forward_warp_eyes_planar_plain",
           "forward_warp_pair_planar"]


def _stack_eye(img, mask):
    q = torch.floor(torch.clamp(img, 0.0, 255.0))
    return torch.cat([torch.movedim(q, -1, 0), mask[None]],
                     dim=0).to(torch.uint8)


def forward_warp_eyes_plain(image, depth, max_disparity: float):
    """image [B, H, W, 3] float32, depth [B, H, W] float32 in [0, 1] ->
    (eye_l, eye_r), each [4, B, H, W] uint8."""
    from vsc_tpu_torch.ops.warp import forward_warp_stereo
    left, lm, right, rm = forward_warp_stereo(image, depth, max_disparity)
    return _stack_eye(left, lm), _stack_eye(right, rm)


def forward_warp_eyes(image, depth, max_disparity: float):
    """CPU tensors: the plain version; CUDA tensors: the kernel."""
    if image.device.type == "cpu" and depth.device.type == "cpu":
        return forward_warp_eyes_plain(image, depth, max_disparity)
    _cuda.require_cuda("forward_warp", image, depth)
    B, H, W, C = image.shape
    if (C != 3 or tuple(depth.shape) != (B, H, W)
            or image.dtype != torch.float32 or depth.dtype != torch.float32):
        raise ValueError(f"forward_warp: need image [B,H,W,3] and depth "
                         f"[B,H,W] float32, got {tuple(image.shape)} "
                         f"{image.dtype}, {tuple(depth.shape)} {depth.dtype}")
    eye_l = torch.empty((4, B, H, W), dtype=torch.uint8, device=image.device)
    eye_r = torch.empty_like(eye_l)
    code = _cuda.library().vsc_warp(
        depth.data_ptr(), image.data_ptr(), eye_l.data_ptr(),
        eye_r.data_ptr(), B * H, W, B * H * W, float(max_disparity),
        _cuda.stream_ptr(image.device))
    _cuda.check(code, "vsc_warp")
    _cuda.LAUNCHES["warp"] += 1
    return eye_l, eye_r


def forward_warp_eyes_planar_plain(image_cf, depth, max_disparity: float):
    """image_cf [B, 3, H, W] uint8, depth [B, H, W] float32 ->
    (eye_l, eye_r), each [4, B, H, W] uint8."""
    return forward_warp_eyes_plain(
        torch.movedim(image_cf, 1, -1).to(torch.float32), depth,
        max_disparity)


def _check_planar(name, image_cf, depth):
    _cuda.require_cuda(name, image_cf, depth)
    B, C, H, W = image_cf.shape
    if (C != 3 or tuple(depth.shape) != (B, H, W)
            or image_cf.dtype != torch.uint8 or depth.dtype != torch.float32):
        raise ValueError(f"{name}: need image [B,3,H,W] uint8 and depth "
                         f"[B,H,W] float32, got {tuple(image_cf.shape)} "
                         f"{image_cf.dtype}, {tuple(depth.shape)} "
                         f"{depth.dtype}")
    return B, H, W


def _launch_planar(image_cf, depth, max_disparity, eye_l_ptr, eye_r_ptr,
                   cstride):
    B, _, H, W = image_cf.shape
    code = _cuda.library().vsc_warp_planar_u8(
        depth.data_ptr(), image_cf.data_ptr(), eye_l_ptr, eye_r_ptr, B, H, W,
        cstride, float(max_disparity), _cuda.stream_ptr(image_cf.device))
    _cuda.check(code, "vsc_warp_planar_u8")
    _cuda.LAUNCHES["warp"] += 1


def forward_warp_eyes_planar(image_cf, depth, max_disparity: float):
    """The planar-u8 entry. CPU tensors: the plain version; CUDA tensors:
    the kernel."""
    if image_cf.device.type == "cpu" and depth.device.type == "cpu":
        return forward_warp_eyes_planar_plain(image_cf, depth, max_disparity)
    B, H, W = _check_planar("forward_warp_planar", image_cf, depth)
    eye_l = torch.empty((4, B, H, W), dtype=torch.uint8,
                        device=image_cf.device)
    eye_r = torch.empty_like(eye_l)
    _launch_planar(image_cf, depth, max_disparity, eye_l.data_ptr(),
                   eye_r.data_ptr(), B * H * W)
    return eye_l, eye_r


def forward_warp_pair_planar(image_cf, depth, max_disparity: float):
    """image_cf [B, 3, H, W] uint8, depth [B, H, W] float32 -> the pair
    [4, 2B, H, W] uint8 of both eyes (``pair[:, :B]`` left, ``pair[:, B:]``
    right). CPU tensors: the plain version's eyes, concatenated; CUDA
    tensors: the kernel, writing each eye into its half in place."""
    if image_cf.device.type == "cpu" and depth.device.type == "cpu":
        return torch.cat(forward_warp_eyes_planar_plain(
            image_cf, depth, max_disparity), dim=1)
    B, H, W = _check_planar("forward_warp_pair_planar", image_cf, depth)
    pair = torch.empty((4, 2 * B, H, W), dtype=torch.uint8,
                       device=image_cf.device)
    _launch_planar(image_cf, depth, max_disparity, pair.data_ptr(),
                   pair[:, B:].data_ptr(), 2 * B * H * W)
    return pair
