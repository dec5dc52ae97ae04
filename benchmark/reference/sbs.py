"""
Plain SBS, the benchmark's reference for the stereo layer
=========================================================

A frozen copy of the planar-u8 branch of ``vsc_tpu_torch/ops/stereo.py``
as of commit 0b643e2 (the branch ``StereoParams()``'s super_sampling 3
takes at any real frame size, and any integer super-sampling on frames of
more than 43 columns), written with the plain versions of its kernels from
``ops/{warp,blur_cuda,upsample_cuda,inpaint,postprocess_cuda,finish_cuda,
filters}.py`` of that commit: the gather warp, the shift-and-accumulate
blur, the integer u8 upsample, the 2x2 pool ladder and push-pull, the
postprocess's bilateral / sweeps / polish, the unsharp and box finish. It
imports nothing of the program and runs one frame at a time.

  1. Lanczos4 pre-stretch by (2 max_disparity + |convergence|) / W,
     rounded like cv2's u8 output
  2. per-frame min-max depth normalization
  3. bilinear super-sampling (RGB straight to u8)
  4-5. gaussian edge softening and depth gamma
  6. forward warp of both eyes to (r, g, b, valid) u8 stacks
  7. quarter-resolution push-pull estimate; bilateral, hole dilation,
     frontier sweeps, estimate, polish
  8-10. convergence crop, unsharp, area downscale, floor to u8, SBS pack

``precision`` "bfloat16" is the control: every float stage's output
rounded to bfloat16, the step below float32 that would tempt a later
change.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.nn import functional as F

from reference.resize import resize

__all__ = ["sbs_shapes", "crop_offsets", "generate_sbs", "params_dict",
           "DEFAULT_PARAMS"]

DEFAULT_PARAMS = {"max_disparity": 50.0, "convergence": -10.0,
                  "super_sampling": 3.0, "edge_softness": 20.0,
                  "artifact_smoothing": 1.0, "depth_gamma": 0.2,
                  "sharpen": 14.0}

SIGMA_COLOR = 30.0
FILL_RADIUS = 2
SWEEPS = 3
POLISH_RADIUS = 3


def params_dict(p=None) -> dict:
    out = dict(DEFAULT_PARAMS)
    out.update(p or {})
    return {k: float(v) for k, v in out.items()}


def sbs_shapes(height: int, width: int, p: dict) -> dict:
    total = 2.0 * p["max_disparity"] + abs(p["convergence"])
    sw = int(width * (1.0 + total / width))
    up_h = int(height * p["super_sampling"])
    up_w = int(sw * p["super_sampling"])
    ratio = up_w / sw
    return {"stretched_w": sw, "up_h": up_h, "up_w": up_w,
            "scale_ratio": ratio, "crop_w": int(width * ratio)}


def crop_offsets(height: int, width: int, p: dict):
    s = sbs_shapes(height, width, p)
    base = (s["stretched_w"] - width) // 2
    shift = int(round(p["convergence"]))
    ratio = s["scale_ratio"]
    left, right = int((base + shift) * ratio), int((base - shift) * ratio)
    hi = s["up_w"] - s["crop_w"]
    return max(0, min(left, hi)), max(0, min(right, hi)), s["crop_w"]


def disc_offsets(radius: int):
    return [(dy, dx, 1.0 / math.hypot(dy, dx))
            for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if (dy, dx) != (0, 0) and dy * dy + dx * dx <= radius * radius + 1]


def bilateral_geometry(smoothing: float):
    if smoothing <= 0:
        return 0, []
    d = max(5, min(int(smoothing * 4), 15))
    r = d // 2
    ss = smoothing * 25.0
    return r, [(dy, dx, math.exp(-0.5 * (dy * dy + dx * dx) / (ss * ss)))
               for dy in range(-r, r + 1) for dx in range(-r, r + 1)
               if (dy, dx) != (0, 0) and dy * dy + dx * dx <= r * r]


def margin(smoothing: float) -> int:
    return bilateral_geometry(smoothing)[0] + 1 + FILL_RADIUS * SWEEPS \
        + POLISH_RADIUS


def planar_u8(height: int, width: int, p: dict) -> bool:
    """Whether the program takes the branch this reference covers."""
    s = sbs_shapes(height, width, p)
    if not (p["super_sampling"] > 1.0
            and float(s["scale_ratio"]).is_integer()):
        return False
    need = margin(p["artifact_smoothing"])
    return (s["crop_w"] >= 129 and s["up_h"] >= 5
            and -(-need // 4) * 4 < s["up_h"]
            and -(-need // 64) * 64 < s["up_w"])


@functools.lru_cache(maxsize=64)
def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    w = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (w / w.sum()).astype(np.float32)


def reflect_index(n: int, before: int, after: int, device):
    return torch.as_tensor(np.pad(np.arange(n), (before, after),
                                  mode="reflect")).to(device)


def _blur(x, ksize: int, sigma: float, gamma=None):
    """[N, H, W] float32, reflect-101 borders, rows then columns."""
    _, H, W = x.shape
    r = ksize // 2
    k = gaussian_kernel1d(ksize, sigma)
    xp = x.index_select(1, reflect_index(H, r, r, x.device))
    xp = xp.index_select(2, reflect_index(W, r, r, x.device))
    rows = None
    for t in range(ksize):
        term = float(k[t]) * xp[:, t:t + H, :]
        rows = term if rows is None else rows + term
    out = None
    for t in range(ksize):
        term = float(k[t]) * rows[:, :, t:t + W]
        out = term if out is None else out + term
    if gamma is not None:
        out = torch.clamp(out, 0.001, 1.0) ** gamma
    return out


def _int_taps(n: int, f: int, device):
    o = torch.arange(n * f, device=device)
    num = 2 * o - (f - 1)
    x0 = torch.div(num, 2 * f, rounding_mode="floor")
    k = num - x0 * 2 * f
    return (torch.clamp(x0, 0, n - 1), torch.clamp(x0 + 1, 0, n - 1),
            (2 * f - k).to(torch.int32), k.to(torch.int32))


def _upsample_u8(x, f: int):
    """[N, H, W] integer-valued float -> [N, H f, W f] u8, the exact floor
    of the bilinear value computed in integers."""
    _, H, W = x.shape
    r0, r1, wr0, wr1 = _int_taps(H, f, x.device)
    c0, c1, wc0, wc1 = _int_taps(W, f, x.device)
    xi = x.to(torch.int32)
    rows = xi.index_select(1, r0) * wr0[:, None] + xi.index_select(1, r1) \
        * wr1[:, None]
    s = rows.index_select(2, c0) * wc0 + rows.index_select(2, c1) * wc1
    return torch.div(s, (2 * f) ** 2, rounding_mode="floor").to(torch.uint8)


def _warp(image, depth, max_disparity: float):
    """image [B, H, W, C] float32, depth [B, H, W] in [0, 1] -> both eyes
    as (image, mask) by the gather rule: ceil class 2 + z over floor class
    z, nearest depth first, the first shift in scan order on a tie."""
    B, H, W, C = image.shape
    D = int(math.floor(max_disparity)) + 1
    P = D + 2
    disp_p = F.pad(depth * max_disparity, (P, P))
    depth_p = F.pad(depth, (P, P))
    valid_p = F.pad(torch.ones_like(depth), (P, P))
    image_p = F.pad(image, (0, 0, P, P))
    ninf = float("-inf")

    def sh(a, s):
        return a[:, :, P - s:P - s + W]

    def one(sign):
        best_key = torch.full((B, H, W), ninf, device=image.device)
        best_img = torch.zeros_like(image)
        best_wgt = torch.zeros((B, H, W), device=image.device)
        for s in (range(0, D + 2) if sign > 0 else range(-D, 2)):
            d_s = sh(disp_p, s) * sign
            z_s = sh(depth_p, s)
            v_s = sh(valid_p, s)
            k = torch.floor(d_s)
            frac = d_s - k
            is_floor = (k == s) & (v_s > 0)
            is_ceil = (k == s - 1) & (frac > 0.3) & (v_s > 0)
            key = torch.where(is_ceil, 2.0 + z_s,
                              torch.where(is_floor, z_s, ninf))
            wgt = torch.where(is_ceil, frac, 1.0 - frac)
            take = key > best_key
            best_key = torch.where(take, key, best_key)
            best_wgt = torch.where(take, wgt, best_wgt)
            best_img = torch.where(take[..., None], sh(image_p, s), best_img)
        mask = ((best_wgt > 0.1) & (best_key > ninf)).to(torch.float32)
        q = torch.floor(torch.clamp(best_img, 0.0, 255.0))
        return torch.cat([torch.movedim(q, -1, 0), mask[None]]).to(
            torch.uint8)

    return one(+1), one(-1)


def _avgpool2_hw(x):
    H, W = x.shape[-2], x.shape[-1]
    if (H | W) & 1:
        iy = torch.clamp(torch.arange(H + (H & 1), device=x.device), 0, H - 1)
        ix = torch.clamp(torch.arange(W + (W & 1), device=x.device), 0, W - 1)
        x = x.index_select(-2, iy).index_select(-1, ix)
    xh = (x[..., 0::2, :] + x[..., 1::2, :]) * 0.5
    return (xh[..., 0::2] + xh[..., 1::2]) * 0.5


def _push_pull(img, msk):
    levels = []
    while max(msk.shape[-2], msk.shape[-1]) > 1:
        levels.append((img, msk))
        img, msk = _avgpool2_hw(img), _avgpool2_hw(msk)
    filled = img / torch.clamp(msk, min=1e-8)
    for img_l, msk_l in reversed(levels):
        h, w = img_l.shape[-2], img_l.shape[-1]
        iy = torch.clamp(torch.arange(h, device=img.device) // 2,
                         max=filled.shape[-2] - 1)
        ix = torch.clamp(torch.arange(w, device=img.device) // 2,
                         max=filled.shape[-1] - 1)
        up = filled.index_select(-2, iy).index_select(-1, ix)
        filled = torch.where(msk_l > 1e-8,
                             img_l / torch.clamp(msk_l, min=1e-8), up)
    return filled


def _quarter_estimate(eye4):
    """[4, B, H, W] u8 -> [3, B, ~H/4, ~W/4] float32 push-pull estimate."""
    msk = eye4[3].to(torch.float32)
    x = torch.cat([eye4[:3].to(torch.float32) * msk, msk[None]])
    x = _avgpool2_hw(_avgpool2_hw(x))
    return _push_pull(x[:3], x[3])


def _bilateral(rgb, smoothing: float):
    _, B, H, W = rgb.shape
    rb, offs = bilateral_geometry(smoothing)
    x = rgb.index_select(2, reflect_index(H, rb, rb, rgb.device))
    x = x.index_select(3, reflect_index(W, rb, rb, rgb.device))
    inv2sc = -0.5 / (SIGMA_COLOR * SIGMA_COLOR)
    num = rgb + 0.0
    den = torch.ones((B, H, W), device=rgb.device)
    for dy, dx, sw in offs:
        s = x[..., rb + dy:rb + dy + H, rb + dx:rb + dx + W]
        cd = (torch.abs(s[0] - rgb[0]) + torch.abs(s[1] - rgb[1])
              + torch.abs(s[2] - rgb[2]))
        wgt = sw * torch.exp(inv2sc * (cd * cd))
        num = num + wgt * s
        den = den + wgt
    return torch.floor(torch.clamp(torch.round(num / den), 0.0, 255.0))


def _shift(x, dy: int, dx: int):
    H, W = x.shape[-2:]
    p = max(abs(dy), abs(dx))
    xp = F.pad(x, (p, p, p, p))
    return xp[..., p + dy:p + dy + H, p + dx:p + dx + W]


def _postprocess(eye4, smooth_q, smoothing: float, q):
    _, B, H, W = eye4.shape
    dev = eye4.device
    M = margin(smoothing)
    Hd, Wd = H + 2 * M, W + 2 * M
    chans = eye4[:3].to(torch.float32)
    if smoothing > 0:
        chans = _bilateral(chans, smoothing)
    chans = chans.index_select(2, reflect_index(H, M, M, dev))
    chans = chans.index_select(3, reflect_index(W, M, M, dev))
    inimg = torch.zeros((Hd, Wd), device=dev)
    inimg[M:M + H, M:M + W] = 1.0
    valid = F.pad((eye4[3] > 0).to(torch.float32), (M, M, M, M))
    hole_raw = inimg * (1.0 - valid)
    hole = hole_raw
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                hole = torch.maximum(hole, _shift(hole_raw, dy, dx))
    keep = 1.0 - hole * inimg
    known = keep * inimg
    v = chans * known
    for _ in range(SWEEPS):
        acc3 = torch.zeros_like(v)
        acck = torch.zeros_like(known)
        for dy, dx, w in disc_offsets(FILL_RADIUS):
            wk = w * _shift(known, dy, dx)
            acc3 = acc3 + wk * _shift(v, dy, dx)
            acck = acck + wk
        reach = (acck > 1e-8).to(torch.float32)
        upd = (1.0 - known) * reach
        v = q(v * (1.0 - upd) + (acc3 * (1.0 / torch.clamp(acck, min=1e-8)))
              * upd)
        known = torch.maximum(known, reach)
    iy = torch.clamp((torch.arange(Hd, device=dev) - M) // 4, 0,
                     smooth_q.shape[2] - 1)
    ix = torch.clamp((torch.arange(Wd, device=dev) - M) // 4, 0,
                     smooth_q.shape[3] - 1)
    smooth = smooth_q.index_select(2, iy).index_select(3, ix)
    val = torch.where(keep > 0, chans, torch.where(known > 0, v, smooth))
    polish = disc_offsets(POLISH_RADIUS)
    wsum = sum(w for _, _, w in polish)
    acc = torch.zeros_like(val)
    for dy, dx, w in polish:
        acc = acc + w * _shift(val, dy, dx)
    val = q(torch.where(keep > 0, val, acc / wsum))
    out = val[..., M:M + H, M:M + W]
    return torch.round(torch.clamp(out, 0.0, 255.0)).to(torch.uint8)


def _finish(planes, ratio: int, strength: float, out_h: int, out_w: int,
            crop_w: int, offsets, q):
    lo, ro = offsets
    half = planes.shape[1] // 2
    x = torch.cat([planes[:, :half, :, lo:lo + crop_w],
                   planes[:, half:, :, ro:ro + crop_w]], dim=1).float()
    H = x.shape[2]
    k = gaussian_kernel1d(5, 1.0)
    xp = x.index_select(2, reflect_index(H, 2, 2, x.device))
    xp = xp.index_select(3, reflect_index(crop_w, 2, 2, x.device))
    hconv = None
    for t in range(5):
        term = float(k[t]) * xp[..., t:t + crop_w]
        hconv = term if hconv is None else hconv + term
    blur = None
    for t in range(5):
        term = float(k[t]) * hconv[:, :, t:t + H, :]
        blur = term if blur is None else blur + term
    sharp = q(torch.clamp(x + strength * (x - q(blur)), 0.0, 255.0))
    K, N = sharp.shape[:2]
    r = ratio
    s = sharp[:, :, :out_h * r, :out_w * r].reshape(K, N, out_h, r, out_w * r)
    rows = s[:, :, :, 0]
    for i in range(1, r):
        rows = rows + s[:, :, :, i]
    c = rows.reshape(K, N, out_h, out_w, r)
    total = c[..., 0]
    for j in range(1, r):
        total = total + c[..., j]
    res = q(total / float(r * r))
    return torch.floor(torch.clamp(res, 0.0, 255.0)).to(torch.uint8)


def _quantize(x, max_value: float):
    return torch.clamp(torch.floor(x + 0.5), 0.0, max_value)


def _normalize(depth):
    lo = depth.amin(dim=(1, 2), keepdim=True)
    hi = depth.amax(dim=(1, 2), keepdim=True)
    rng = hi - lo
    out = (depth - lo) / torch.clamp(rng, min=1e-12)
    return torch.where(rng < 1e-6, torch.zeros_like(depth), out)


@torch.no_grad()
def _one(rgb, depth, p: dict, q):
    """One frame: rgb [1, H, W, 3] u8, depth [1, H, W] u8 ->
    [1, H, 2W, 3] u8."""
    _, H, W, _ = rgb.shape
    s = sbs_shapes(H, W, p)
    SW, UH, UW = s["stretched_w"], s["up_h"], s["up_w"]
    f = int(s["scale_ratio"])
    rgb_st = _quantize(resize(rgb.float(), H, SW, "lanczos4",
                              channel_last=True), 255.0)
    depth_st = _quantize(resize(depth.float(), H, SW, "lanczos4"), 255.0)
    depth_n = q(_normalize(depth_st))
    depth_n = q(resize(depth_n, UH, UW, "bilinear"))
    x_cf = torch.movedim(rgb_st, -1, 1)
    if UH % H == 0 and UW % SW == 0 and UH // H == UW // SW:
        rgb_up = _upsample_u8(x_cf.reshape(-1, H, SW), UH // H).reshape(
            1, 3, UH, UW)
    else:
        rgb_up = torch.floor(torch.clamp(resize(x_cf, UH, UW, "bilinear"),
                                         0.0, 255.0)).to(torch.uint8)
    gam = p["depth_gamma"] if p["depth_gamma"] != 1.0 else None
    if p["edge_softness"] > 0:
        k = max(5, min(int(p["edge_softness"] * 6) | 1, 31))
        depth_n = q(_blur(depth_n, k, p["edge_softness"], gamma=gam))
    elif gam is not None:
        depth_n = q(torch.clamp(depth_n, 0.001, 1.0) ** gam)
    lo, ro, crop_w = crop_offsets(H, W, p)
    left, right = _warp(torch.movedim(rgb_up, 1, -1).float(), depth_n,
                        p["max_disparity"])
    pair = torch.cat([left, right], dim=1)
    del left, right
    smooth_q = q(_quarter_estimate(pair))
    out = _postprocess(pair, smooth_q, p["artifact_smoothing"], q)
    del pair
    fin = _finish(out, f, p["sharpen"], H, W, crop_w, (lo, ro), q)
    return torch.movedim(torch.cat([fin[:, :1], fin[:, 1:]], dim=3), 0, -1)


def generate_sbs(rgb, depth, params=None, precision: str = "float32"):
    """rgb [B, H, W, 3] u8, depth [B, H, W] u8 (tensors, any device) ->
    [B, H, 2W, 3] u8 on the same device, one frame at a time."""
    p = params_dict(params)
    H, W = rgb.shape[1], rgb.shape[2]
    if not planar_u8(H, W, p):
        raise ValueError(f"the reference covers the planar-u8 branch; "
                         f"{H} x {W} at {p} is not on it")
    if precision == "float32":
        def q(x):
            return x
    elif precision == "bfloat16":
        def q(x):
            return x.to(torch.bfloat16).to(torch.float32)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.cat([_one(rgb[i:i + 1], depth[i:i + 1], p, q)
                      for i in range(rgb.shape[0])])
