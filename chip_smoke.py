#!/usr/bin/env python3
"""
Chip smoke test of the PyTorch/CUDA port (vsc_tpu_torch) on one GPU
===================================================================

Drives the port's streaming main path on the card and checks it:

  1. card and build: CUDA present, card name + power limit, the kernels
     built from csrc/ with nvcc;
  2. kernel vs plain: each hand-written kernel against its plain PyTorch
     version on the card, at the slice's 1080p shapes (super_sampling 1 for
     blur, warp, postprocess and attention; super_sampling 3 for every SBS
     kernel: upsample, blur, planar-u8 warp, pools, pyramid, postprocess on
     the eye pair, finish, and the split route's bilateral; DepthPro's
     deconv sites and the split-q/k/v attention at its f32 and bf16
     shapes), under its bound, with both times, the time of one PyTorch call
     that computes the same function where there is one (SDPA,
     conv_transpose2d) and the least time the card could take (bytes at
     3.35 TB/s or operations at the peak for their type, whichever is
     larger); then the super_sampling 3 kernels again at 2160 x 3840 and
     the SBS stage at that size;
  3. the slice: ``render_sbs`` (full-width DepthPro from a seed, bf16, then
     SBS) on 1080p batches at ``StereoParams()`` defaults (super_sampling 3,
     the planar-u8 branch), then a shorter run at super_sampling 1 (the
     compat branch); launch counters reset just before each run and read
     just after; a torch.profiler pass over one default batch (device
     busy/idle share, device time by kernel group); an SBS-level check of
     the card against the CPU plain path on a small input at 1 and 3; then
     the JAX package's three opt-in routes to its last kernels, 2 batches
     each with the counters reset around each: the split bilateral
     (VSC_TPU_PP_SPLIT=1, SBS equal to the default route's), the deconv
     kernel (VSC_TPU_PALLAS_DECONV=1, u8 depth against the cuDNN route's
     under a bound that a deliberately broken deconv exceeds) and float32
     DepthPro (VSC_TPU_DEPTH_DTYPE=float32, the split-q/k/v attention);
  4. the CLI: ``stream_convert.run`` on a short synthetic clip, when the
     media engine and tqdm are present.

Prints one JSON line of per-kernel results, the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``. Exits nonzero without printing a result
when there is no CUDA device or the port's sources are missing.

    python3 chip_smoke.py                   # all phases, as the check runs it
    python3 chip_smoke.py --phases 1,2      # build + kernel checks only
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH = 2        # frames per dispatch in the slice phase
BATCHES = 8      # timed dispatches at the defaults, after one warm-up
BATCHES_SS1 = 2  # dispatches of the shorter super_sampling 1 run

# (counter, route, source, replaced Pallas call)
KERNELS = [
    ("blur", "cuda", "vsc_tpu_torch/csrc/blur.cu",
     "vsc_tpu/ops/blur_pallas.py:116"),
    ("warp", "cuda", "vsc_tpu_torch/csrc/warp.cu",
     "vsc_tpu/ops/warp_pallas.py:326"),
    ("postprocess", "cuda", "vsc_tpu_torch/csrc/postprocess.cu",
     "vsc_tpu/ops/postprocess_pallas.py:463"),
    ("attention", "cuda", "vsc_tpu_torch/csrc/attention.cu",
     "vsc_tpu/ops/attention_pallas.py:111"),
    ("upsample", "cuda", "vsc_tpu_torch/csrc/upsample.cu",
     "vsc_tpu/ops/upsample_pallas.py:181"),
    ("pool", "cuda", "vsc_tpu_torch/csrc/pool.cu",
     "vsc_tpu/ops/pool_pallas.py:91, vsc_tpu/ops/pool_pallas.py:131"),
    ("pyramid", "cuda", "vsc_tpu_torch/csrc/pyramid.cu",
     "vsc_tpu/ops/pyramid_pallas.py:105"),
    ("finish", "cuda", "vsc_tpu_torch/csrc/finish.cu",
     "vsc_tpu/ops/finish_pallas.py:195"),
    ("bilateral", "cuda", "vsc_tpu_torch/csrc/bilateral.cu",
     "vsc_tpu/ops/bilateral_pallas.py:239"),
    ("deconv", "cuda", "vsc_tpu_torch/csrc/deconv.cu",
     "vsc_tpu/ops/deconv_pallas.py:106"),
    ("attention_split", "cuda", "vsc_tpu_torch/csrc/attention_split.cu",
     "vsc_tpu/ops/attention_pallas.py:185"),
]

# The least time the card could take for a kernel's work (NVIDIA H100 SXM,
# data sheet at 700 W): each input byte read once and each output byte
# written once at the memory rate, or the operations the function needs on
# these inputs at the peak rate of their type, whichever is larger.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16_tensor": 989e12}


def least_time(nbytes: float, **ops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max((n / PEAK_OPS_S[k] for k, n in ops.items()), default=0.0)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bilateral_ops(smoothing: float, pixels: int) -> float:
    """~20 f32 operations (3 sub, 3 abs, 2 add, 3 mul, exp, 6 for num and
    den) per tap of the bilateral disc and ~6 per pixel."""
    from vsc_tpu_torch.ops.postprocess_cuda import bilateral_geometry
    _, taps = bilateral_geometry(smoothing)
    return pixels * (20.0 * len(taps) + 6.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what) -> None:
    """A failed check fails the run (kept under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over reps launches (CUDA events, after one
    warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# kernel-name patterns -> group, first match wins
CONV_GROUP = r"fprop|dgrad|wgrad|cudnn|conv|nchwToNhwc"
GROUPS = [
    ("attention kernel", r"qkv_attention_kernel"),
    ("split attention kernel", r"split_attention_kernel"),
    ("deconv kernel", r"deconv2x2_kernel"),
    ("SBS kernels (blur, warp, postprocess, bilateral)",
     r"::(blur|warp|prep|sweep|finish|bilateral|quarter)_kernel[<(]"),
    ("super-sampling kernels (upsample, pool, pyramid, finish)",
     r"::(upsample|pool_eye4|pool2|pyramid|sharpen_downscale)_kernel[<(]"),
    ("convolutions (cuDNN)", CONV_GROUP),
    ("GEMMs (cuBLAS)", r"nvjet|gemm|cutlass"),
    ("copies and memsets", r"^Memcpy|^Memset|copy_kernel|CatArray"),
    ("other ATen kernels (elementwise, LayerNorm, GELU, gathers)",
     r"at::native"),
]


def profile_device(fn):
    """Device time of one call of fn() from torch.profiler's device events
    only (kernels, copies, memsets; the aten:: rows that launch them are
    host events and are left out). Busy = the union of their intervals
    inside the host window around fn() and its synchronize; idle = the
    rest of that window."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_window"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    win = next(e for e in events if e.name == "chip_smoke_window"
               and e.device_type == DeviceType.CPU)
    w0, w1 = win.time_range.start, win.time_range.end
    # the window also shows up as a device-side annotation: not a kernel
    dev = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1),
                  e.name) for e in events
                 if e.device_type == DeviceType.CUDA
                 and e.name != "chip_smoke_window")
    busy, end = 0.0, w0
    for a, b, _ in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    per_kernel = {}
    for a, b, name in dev:
        g = next((gn for gn, pat in GROUPS if re.search(pat, name)), "other")
        groups[g] += max(b - a, 0.0) / 1e3
        per_kernel[name] = per_kernel.get(name, 0.0) + max(b - a, 0.0) / 1e3
    return dict(window_ms=(w1 - w0) / 1e3, busy_ms=busy / 1e3,
                events=len(dev), groups=groups, per_kernel=per_kernel)


def log_profile(what: str, fn, group: str | None = None) -> None:
    """Device time of one call of fn() by kernel group, the top kernels,
    and with ``group`` (a GROUPS pattern) the top kernels of that group."""
    import re
    prof = profile_device(fn)
    per_kernel = sorted(prof["per_kernel"].items(), key=lambda kv: -kv[1])
    tot = sum(prof["groups"].values())
    log(f"phase 3: profile of {what}: window "
        f"{prof['window_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms "
        f"({100 * prof['busy_ms'] / prof['window_ms']:.1f} %, idle "
        f"{100 - 100 * prof['busy_ms'] / prof['window_ms']:.1f} %), "
        f"{prof['events']} device events")
    log("phase 3: device time by group: " + "; ".join(
        f"{g} {t:.2f} ms ({100 * t / tot:.1f} %)"
        for g, t in sorted(prof["groups"].items(), key=lambda kv: -kv[1])
        if t > 0))
    log("phase 3: top kernels: " + "; ".join(
        f"{t:.2f} ms {n[:70]}" for n, t in per_kernel[:8]))
    if group is not None:
        log(f"phase 3: top kernels matching {group!r}: " + "; ".join(
            f"{t:.2f} ms {n[:70]}"
            for n, t in [kv for kv in per_kernel
                         if re.search(group, kv[0])][:6]))


def smooth_depth(B, H, W, dev, seed):
    """Scene-like nearness in [0, 1]: ramps + a disc + mild noise."""
    import torch
    g = torch.Generator(dev).manual_seed(seed)
    yy = torch.linspace(0, 1, H, device=dev)[:, None]
    xx = torch.linspace(0, 1, W, device=dev)[None, :]
    base = 0.6 * yy + 0.2 * torch.sin(6.0 * xx)
    disc = ((yy - 0.5) ** 2 + (xx - 0.4) ** 2 < 0.05).float() * 0.3
    d = (base + disc)[None].expand(B, H, W)
    d = d + 0.01 * torch.rand((B, H, W), generator=g, device=dev)
    d = d - d.amin(dim=(1, 2), keepdim=True)
    return (d / d.amax(dim=(1, 2), keepdim=True)).contiguous()


def frames_u8(B, dev, seed, H=1080, W=1920):
    """Structured u8 frames: gradients, stripes, a bright block, noise."""
    import torch
    g = torch.Generator(dev).manual_seed(seed)
    yy = torch.arange(H, device=dev)[:, None].float()
    xx = torch.arange(W, device=dev)[None, :].float()
    r = 128 + 100 * torch.sin(xx / 37.0) * torch.cos(yy / 53.0)
    gch = 255 * yy / H + 0 * xx
    b = 255 * (1 - xx / W) + 0 * yy
    img = torch.stack([r, gch, b], dim=-1)[None].repeat(B, 1, 1, 1)
    for i in range(B):
        img[i, 300 + 40 * i:600, 500 + 60 * i:900] = 230.0
    img = img + 8 * torch.randn((B, H, W, 3), generator=g, device=dev)
    return img.clamp(0, 255).to(torch.uint8)


def phase_card_and_build():
    import torch
    from vsc_tpu_torch.ops import _cuda
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    log(f"phase 1: kernels built and loaded in {build_s:.1f} s "
        f"(nvcc {', '.join(f'{s:.1f}' for s in _cuda.BUILD_SECONDS) or 'cached'} s)")
    return card


def phase_kernels(B: int):
    """Each kernel vs its plain version at the slice's shapes."""
    import torch
    from vsc_tpu_torch.ops import stereo
    from vsc_tpu_torch.ops.attention_cuda import (qkv_attention,
                                                  qkv_attention_plain)
    from vsc_tpu_torch.ops.blur_cuda import (gaussian_blur_planes,
                                             gaussian_blur_planes_plain)
    from vsc_tpu_torch.ops.inpaint import _pyramid_fill
    from vsc_tpu_torch.ops.postprocess_cuda import (postprocess_eye,
                                                    postprocess_eye_plain)
    from vsc_tpu_torch.ops.warp_cuda import (forward_warp_eyes,
                                             forward_warp_eyes_plain)
    dev = torch.device("cuda")
    p = stereo.StereoParams(super_sampling=1.0)
    s = stereo.sbs_shapes(1080, 1920, p)
    SW = s["stretched_w"]
    k = max(5, min(int(p.edge_softness * 6) | 1, 31))
    res = {}

    # 1. blur: depth [B, 1080, SW], k = 31, sigma 20, gamma 0.2
    depth = smooth_depth(B, 1080, SW, dev, 1)
    got = gaussian_blur_planes(depth, k, p.edge_softness, p.depth_gamma)
    want = gaussian_blur_planes_plain(depth, k, p.edge_softness, p.depth_gamma)
    err = float((got - want).abs().max())
    res["blur"] = dict(
        max_abs_err=err, bound="atol 1e-4 (tests/test_blur_pallas.py)",
        ms=time_ms(lambda: gaussian_blur_planes(depth, k, p.edge_softness,
                                                p.depth_gamma)),
        plain_ms=time_ms(lambda: gaussian_blur_planes_plain(
            depth, k, p.edge_softness, p.depth_gamma)))
    check(err <= 1e-4, f"blur disagrees: {err}")

    # 2. warp: rgb [B, 1080, SW, 3] integer-valued, the blurred depth
    g = torch.Generator(dev).manual_seed(2)
    rgb = torch.floor(torch.rand((B, 1080, SW, 3), generator=g, device=dev)
                      * 256)
    dn = got
    eyes = forward_warp_eyes(rgb, dn, p.max_disparity)
    eyes_p = forward_warp_eyes_plain(rgb, dn, p.max_disparity)
    err = max(float((a.int() - b.int()).abs().max())
              for a, b in zip(eyes, eyes_p))
    res["warp"] = dict(
        max_abs_err=err, bound="exact (u8 colors and masks)",
        holes=float(1 - eyes[1][3].float().mean()),
        ms=time_ms(lambda: forward_warp_eyes(rgb, dn, p.max_disparity)),
        plain_ms=time_ms(lambda: forward_warp_eyes_plain(
            rgb, dn, p.max_disparity), reps=2))
    check(err == 0, f"warp disagrees: {err}")

    # 3. postprocess: the right eye (most holes), its quarter-res estimate
    eye4 = eyes[1]
    img = torch.movedim(eye4[:3], 0, -1).float()
    smooth_q = torch.movedim(_pyramid_fill(
        img, eye4[3].float()[..., None], coarse_factor=4,
        return_coarse=True), -1, 0).contiguous()
    a = postprocess_eye(eye4, smooth_q, p.artifact_smoothing).int()
    b = postprocess_eye_plain(eye4, smooth_q, p.artifact_smoothing).int()
    d = (a - b).abs()
    err, frac = float(d.max()), float((d > 0).float().mean())
    res["postprocess"] = dict(
        max_abs_err=err, frac_differing=frac,
        bound="<= 1 code on < 0.1% of pixels "
              "(tests/test_postprocess_pallas.py)",
        ms=time_ms(lambda: postprocess_eye(eye4, smooth_q,
                                           p.artifact_smoothing)),
        plain_ms=time_ms(lambda: postprocess_eye_plain(
            eye4, smooth_q, p.artifact_smoothing), reps=2))
    check(err <= 1 and frac < 1e-3, f"postprocess disagrees: {err} {frac}")

    # 4. attention: qkv [35B + B, 577, 3072] bf16, 16 heads
    N = 36 * B
    qkv = torch.randn((N, 577, 3072), generator=g, device=dev).to(
        torch.bfloat16)
    scale = 1.0 / 8.0
    o = qkv_attention(qkv, 16, scale).float()
    o_p = qkv_attention_plain(qkv, 16, scale).float()
    err = float((o - o_p).abs().max())
    mean_err = float((o - o_p).abs().mean())

    def sdpa():
        q, kk, v = (x.reshape(N, 577, 16, 64).transpose(1, 2)
                    for x in qkv.split(1024, dim=-1))
        return torch.nn.functional.scaled_dot_product_attention(
            q, kk, v, scale=scale)
    res["attention"] = dict(
        max_abs_err=err, mean_abs_err=mean_err,
        bound="max 8e-3, mean 1e-5: bf16 output (~0.07 in size) and "
              "bf16-rounded p that can flip with the f32 summation order",
        ms=time_ms(lambda: qkv_attention(qkv, 16, scale)),
        plain_ms=time_ms(lambda: qkv_attention_plain(qkv, 16, scale),
                         reps=2),
        library_ms=time_ms(sdpa),
        # two products on the tensor cores, ~5 f32 operations per logit
        **least_time(nbytes(qkv) + nbytes(qkv) // 3,     # qkv in, [N, T, D] out
                bf16_tensor=4.0 * 577 * 577 * 64 * N * 16,
                f32=5.0 * 577 * 577 * N * 16))
    check(err <= 8e-3 and mean_err <= 1e-5,
          f"attention disagrees: max {err}, mean {mean_err}")
    for name, r in res.items():
        log(f"phase 2: {name}: max_abs_err {r['max_abs_err']:.3g} "
            f"[{r['bound']}], kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms"
            + (f", sdpa {r['library_ms']:.3f} ms" if "library_ms" in r
               else ""))
    return res


def phase_ss_kernels(B: int, H: int = 1080, W: int = 1920):
    """Every SBS kernel of the super_sampling 3 branch (upsample, blur,
    planar-u8 warp, pools, pyramid, postprocess on the pair, finish, and
    the split route's bilateral where its guard takes the pair) vs its
    plain version, at the shapes of H x W frames (1080p and 2160 x 3840 as
    the check runs it), fed by the chain it sits in (each stage's kernel
    output is the next stage's input)."""
    import torch
    import torch.nn.functional as F
    from vsc_tpu_torch.ops import stereo
    from vsc_tpu_torch.ops.bilateral_cuda import (bilateral_pool_planar,
                                                  bilateral_pool_plain,
                                                  bilateral_pool_supported)
    from vsc_tpu_torch.ops.blur_cuda import (gaussian_blur_planes,
                                             gaussian_blur_planes_plain)
    from vsc_tpu_torch.ops.finish_cuda import (sharpen_downscale_planar,
                                               sharpen_downscale_plain)
    from vsc_tpu_torch.ops.inpaint import PYR_KMAX, _avgpool2_hw, _edge_even
    from vsc_tpu_torch.ops.pool_cuda import (avgpool2, avgpool2_eye4,
                                             avgpool2_plain,
                                             avgpool_eye4_plain)
    from vsc_tpu_torch.ops.postprocess_cuda import (postprocess_eye,
                                                    postprocess_eye_plain)
    from vsc_tpu_torch.ops.pyramid_cuda import (pyramid_fill_below,
                                                pyramid_fill_below_plain)
    from vsc_tpu_torch.ops.resize import resize
    from vsc_tpu_torch.ops.upsample_cuda import (upsample_bilinear_int,
                                                 upsample_bilinear_int_plain)
    from vsc_tpu_torch.ops.warp_cuda import (forward_warp_eyes_planar,
                                             forward_warp_eyes_planar_plain)
    dev = torch.device("cuda")
    p = stereo.StereoParams()
    s = stereo.sbs_shapes(H, W, p)
    SW, UH, UW, f = s["stretched_w"], s["up_h"], s["up_w"], 3
    lo, ro, crop_w = stereo._crop_offsets(H, W, p)
    res = {}

    def exact(name, got, want, bound="exact", **extra):
        err = float((got.float() - want.float()).abs().max())
        res[name] = dict(max_abs_err=err, bound=bound, **extra)
        return err

    # upsample: stretched RGB planes [3B, 1080, SW] (u8 values) -> u8, and
    # the normalized depth [B, 1080, SW] -> f32
    rgb = frames_u8(B, dev, 5, H, W).float()
    rgb_st = stereo._quantize_like(resize(rgb, H, SW, "lanczos4",
                                          channel_last=True), 255.0)
    x_cf = torch.movedim(rgb_st, -1, 1).reshape(-1, H, SW).contiguous()
    depth = smooth_depth(B, H, SW, dev, 1)
    # (bilinear: ~6 f32 operations per output element)
    up = upsample_bilinear_int(x_cf, f, quantize_u8=True)
    e_u8 = exact("upsample_u8", up, upsample_bilinear_int_plain(x_cf, f, True),
                 ms=time_ms(lambda: upsample_bilinear_int(x_cf, f, True)),
                 plain_ms=time_ms(lambda: upsample_bilinear_int_plain(
                     x_cf, f, True), reps=2),
                 **least_time(nbytes(x_cf, up), f32=6.0 * up.numel()))
    up_d = upsample_bilinear_int(depth, f)
    e_f32 = exact("upsample_f32", up_d, upsample_bilinear_int_plain(depth, f),
                  ms=time_ms(lambda: upsample_bilinear_int(depth, f)),
                  plain_ms=time_ms(lambda: upsample_bilinear_int_plain(
                      depth, f), reps=2),
                  library_ms=time_ms(lambda: F.interpolate(
                      depth[:, None], scale_factor=f, mode="bilinear",
                      align_corners=False)),
                  **least_time(nbytes(depth, up_d), f32=6.0 * up_d.numel()))
    check(e_u8 == 0 and e_f32 == 0, f"upsample disagrees: {e_u8} {e_f32}")

    # the blur of the up-res depth, then the planar-u8 warp on it
    k = max(5, min(int(p.edge_softness * 6) | 1, 31))
    blur_args = (up_d, k, p.edge_softness, p.depth_gamma)
    dn = gaussian_blur_planes(*blur_args)
    err = exact("blur", dn, gaussian_blur_planes_plain(*blur_args),
                bound="atol 1e-4 (tests/test_blur_pallas.py)",
                ms=time_ms(lambda: gaussian_blur_planes(*blur_args)),
                plain_ms=time_ms(lambda: gaussian_blur_planes_plain(
                    *blur_args), reps=2),
                # two k-tap passes (multiply-add each) and the gamma
                **least_time(nbytes(up_d, dn),
                             f32=(4.0 * k + 4.0) * dn.numel()))
    check(err <= 1e-4, f"blur disagrees: {err}")
    img_cf = up.reshape(B, 3, UH, UW)
    eyes = forward_warp_eyes_planar(img_cf, dn, p.max_disparity)
    eyes_p = forward_warp_eyes_planar_plain(img_cf, dn, p.max_disparity)
    err = max(exact("warp_planar_u8", a, b) for a, b in zip(eyes, eyes_p))
    res["warp_planar_u8"].update(
        max_abs_err=err, holes=float(1 - eyes[1][3].float().mean()),
        ms=time_ms(lambda: forward_warp_eyes_planar(img_cf, dn,
                                                    p.max_disparity)),
        plain_ms=time_ms(lambda: forward_warp_eyes_planar_plain(
            img_cf, dn, p.max_disparity), reps=2),
        # ~8 operations per candidate shift, floor(max_disparity) + 3
        # candidates per pixel and eye
        **least_time(nbytes(img_cf, dn, *eyes), f32=8.0 * 2 * (
            int(p.max_disparity) + 3) * dn.numel()))
    check(err == 0, f"planar-u8 warp disagrees: {err}")
    del eyes_p
    pair = torch.cat(eyes, dim=1)
    del eyes

    # pools: eye4 f = 2 (6090 % 4 != 0), edge-even, f32 2x2; an odd W'
    # (2160 x 3840: 11847) takes the torch glue, as the JAX package does
    if UH % 2 == 0 and UW % 2 == 0:
        # (~5 operations per input pixel of the masked pool, ~1 per input
        # element of the f32 pool)
        x2 = avgpool2_eye4(pair)
        e1 = exact("pool_eye4", x2, avgpool_eye4_plain(pair, 2),
                   ms=time_ms(lambda: avgpool2_eye4(pair)),
                   plain_ms=time_ms(lambda: avgpool_eye4_plain(pair, 2),
                                    reps=2),
                   **least_time(nbytes(pair, x2), f32=5.0 * pair[0].numel()))
        xe = _edge_even(x2)
        K, N, h, w = xe.shape
        planes = xe.reshape(K * N, h, w)
        x4 = avgpool2(planes)
        e2 = exact("pool_f32", x4, avgpool2_plain(planes),
                   ms=time_ms(lambda: avgpool2(planes)),
                   plain_ms=time_ms(lambda: avgpool2_plain(planes), reps=2),
                   library_ms=time_ms(lambda: F.avg_pool2d(planes, 2)),
                   **least_time(nbytes(planes, x4), f32=planes.numel()))
        check(e1 == 0 and e2 == 0, f"pools disagree: {e1} {e2}")
        q = x4.reshape(K, N, h // 2, w // 2)
    else:
        q = avgpool_eye4_plain(pair, 4)

    # pyramid below the handoff: glue levels down from the quarter
    while max(q.shape[-2:]) > PYR_KMAX:
        q = _avgpool2_hw(q)
    q = q.contiguous()
    filled = pyramid_fill_below(q)
    err = exact("pyramid", filled, pyramid_fill_below_plain(q),
                bound="exact (bit-identical levels)",
                ms=time_ms(lambda: pyramid_fill_below(q)),
                plain_ms=time_ms(lambda: pyramid_fill_below_plain(q), reps=2),
                # pools and combines over the ladder: ~10 per input element
                **least_time(nbytes(q, filled), f32=10.0 * q.numel()))
    check(err == 0, f"pyramid disagrees: {err}")

    # the split route's bilateral + pool on the pair, where the JAX guard
    # takes it (an odd W', as at 2160 x 3840, keeps the fused route)
    sm = p.artifact_smoothing
    if bilateral_pool_supported(UH, UW, sm):
        filt, quarter = bilateral_pool_planar(pair, sm)
        filt_p, quarter_p = bilateral_pool_plain(pair, sm)
        d = (filt[:3].int() - filt_p[:3].int()).abs()
        err, frac = float(d.max()), float((d > 0).float().mean())
        e_rest = max(float((filt[3].int() - pair[3].int()).abs().max()),
                     float((quarter - quarter_p).abs().max()))
        del d, filt_p, quarter_p
        res["bilateral"] = dict(
            max_abs_err=max(err, e_rest), frac_differing=frac,
            bound="filtered <= 1 code on < 0.1% of pixels, valid plane and "
                  "quarter exact",
            ms=time_ms(lambda: bilateral_pool_planar(pair, sm)),
            plain_ms=time_ms(lambda: bilateral_pool_plain(pair, sm), reps=2),
            # (~4 operations per masked value of the quarter sums)
            **least_time(nbytes(pair, filt, quarter),
                         f32=bilateral_ops(sm, pair[0].numel())
                         + 16.0 * quarter.numel()))
        check(err <= 1 and frac < 1e-3 and e_rest == 0,
              f"bilateral disagrees: {err} {frac} {e_rest}")
        del filt, quarter
    else:
        log(f"phase 2: bilateral not checked at {H}x{W}: the split route's "
            f"guard refuses the {UH} x {UW} pair (JAX's guard too)")

    # finish on the postprocessed pair, each eye at its own offset
    smooth_q = stereo._pyramid_fill_planar_coarse(pair)
    pp_args = (pair, smooth_q, p.artifact_smoothing)
    out = postprocess_eye(*pp_args)
    d = (out.int() - postprocess_eye_plain(*pp_args).int()).abs()
    err, frac = float(d.max()), float((d > 0).float().mean())
    del d
    res["postprocess"] = dict(
        max_abs_err=err, frac_differing=frac,
        bound="<= 1 code on < 0.1% of pixels",
        ms=time_ms(lambda: postprocess_eye(*pp_args)),
        plain_ms=time_ms(lambda: postprocess_eye_plain(*pp_args), reps=2),
        # the bilateral on every pixel (the hole fill's work depends on the
        # holes and is left out: a lower bound)
        **least_time(nbytes(pair, smooth_q, out),
                     f32=bilateral_ops(sm, pair[0].numel())))
    check(err <= 1 and frac < 1e-3, f"postprocess disagrees: {err} {frac}")
    del pair, pp_args
    args = (out, f, float(p.sharpen), H, W, crop_w, (lo, ro))
    got = sharpen_downscale_planar(*args)
    want = sharpen_downscale_plain(*args)
    d = (got.int() - want.int()).abs()
    err = exact("finish", got, want, frac_differing=float(
                    (d > 0).float().mean()),
                ms=time_ms(lambda: sharpen_downscale_planar(*args)),
                plain_ms=time_ms(lambda: sharpen_downscale_plain(*args),
                                 reps=2),
                # each eye's crop read once; 5 + 5 taps, the unsharp and
                # the box: ~26 operations per cropped pixel
                **least_time(nbytes(got) + out[..., :crop_w].numel(),
                             f32=26.0 * out[..., :crop_w].numel()))
    check(err == 0, f"finish disagrees: {err}")
    log(f"phase 2: {H}x{W} super_sampling 3 shapes: upsample "
        f"{tuple(x_cf.shape)} and {tuple(depth.shape)} x{f}, pair "
        f"{tuple(out.shape[1:])}, pyramid {tuple(q.shape)}, finish crop "
        f"{crop_w} at ({lo}, {ro})")
    for name, r in res.items():
        log(f"phase 2: {name} ({H}x{W}, super_sampling 3): max_abs_err "
            f"{r['max_abs_err']:.3g}"
            + (f" on {r['frac_differing']:.2g} of pixels"
               if "frac_differing" in r else "")
            + f" [{r['bound']}], kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']})"
            + (f", library {r['library_ms']:.3f} ms" if "library_ms" in r
               else ""))
    return res


# DepthPro's ConvTranspose 2x2 sites per frame at input 1536 (input side,
# C -> O, bias, sites), vsc_tpu/models/depthpro.py:427-440, 465-469, 533:
# upsample_latent0 96/192/384 and latent1 96/192 (256), upsample0 96
# (512), upsample1 48 and upsample2 24 (1024), upsample_lowres 24 (1024,
# bias), fusion_4..1 48/96/192/384 (256), head_deconv 768 (128, bias)
DECONV_SITES = [(48, 256, 256, False, 1), (96, 256, 256, False, 3),
                (192, 256, 256, False, 3), (384, 256, 256, False, 2),
                (96, 512, 512, False, 1), (48, 1024, 1024, False, 1),
                (24, 1024, 1024, False, 1), (24, 1024, 1024, True, 1),
                (768, 128, 128, True, 1)]
DECONV_BF16_TOL = (1e-3, 8e-3)      # atol, rtol: one step of bf16's grid
DECONV_F32_TOL = (1e-4, 1e-5)       # atol, rtol: f32 sums in another order


def phase_depth_kernels(B: int):
    """The deconv kernel at every DepthPro site shape (bf16, batch B) and
    once in f32, and the split-q/k/v attention at [36B, 577, 16, 64] in f32
    (the float32 DepthPro's shape) and bf16, and at head dims 16 and 128,
    each against its plain version, with the library call's time."""
    import torch
    import torch.nn.functional as F
    from vsc_tpu_torch.ops.attention_cuda import (short_seq_attention,
                                                  short_seq_attention_plain)
    from vsc_tpu_torch.ops.deconv_cuda import deconv2x2, deconv2x2_plain
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(21)
    res = {}

    def deconv_site(S, C, O, has_bias, dtype):
        x = torch.randn((B, C, S, S), generator=g, device=dev).to(dtype)
        w = (torch.randn((C, O, 2, 2), generator=g, device=dev)
             / (4 * C) ** 0.5).to(dtype)
        b = (0.1 * torch.randn((O,), generator=g, device=dev)).to(
            dtype) if has_bias else None
        got, want = deconv2x2(x, w, b).float(), deconv2x2_plain(x, w, b).float()
        atol, rtol = DECONV_BF16_TOL if dtype == torch.bfloat16 else \
            DECONV_F32_TOL
        excess = float(((got - want).abs() - atol - rtol * want.abs()).max())
        ops = 2.0 * B * S * S * C * 4 * O
        r = dict(max_abs_err=float((got - want).abs().max()),
                 within=excess <= 0,
                 ms=time_ms(lambda: deconv2x2(x, w, b)),
                 plain_ms=time_ms(lambda: deconv2x2_plain(x, w, b), reps=2),
                 library_ms=time_ms(lambda: F.conv_transpose2d(
                     x, w, b, stride=2)),
                 **least_time(nbytes(x, w, b) + x.element_size() * B * O * 4
                              * S * S,
                              **({"bf16_tensor": ops}
                                 if dtype == torch.bfloat16 else
                                 {"f32": ops})))
        check(r["within"], f"deconv {S} {C}->{O} {dtype} disagrees: "
                           f"{r['max_abs_err']}")
        return r

    sites = []
    for S, C, O, has_bias, count in DECONV_SITES:
        r = deconv_site(S, C, O, has_bias, torch.bfloat16)
        sites.append((S, C, O, has_bias, count, r))
        log(f"phase 2: deconv {S}^2 {C}->{O}{' +bias' if has_bias else ''} "
            f"x{count} bf16 [{B} frames]: max_abs_err "
            f"{r['max_abs_err']:.3g} [atol {DECONV_BF16_TOL[0]} + rtol "
            f"{DECONV_BF16_TOL[1]}], kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, conv_transpose2d {r['library_ms']:.3f} "
            f"ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    r32 = deconv_site(96, 512, 512, False, torch.float32)
    log(f"phase 2: deconv 96^2 512->512 f32: max_abs_err "
        f"{r32['max_abs_err']:.3g} [atol {DECONV_F32_TOL[0]} + rtol "
        f"{DECONV_F32_TOL[1]}], kernel {r32['ms']:.3f} ms, plain "
        f"{r32['plain_ms']:.3f} ms, conv_transpose2d {r32['library_ms']:.3f} "
        f"ms, bound {r32['bound_ms']:.3f} ms ({r32['bound_by']})")
    # the row: every site of one batch, weighted by its count
    tot = {k: sum(c * r[k] for *_, c, r in sites)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    res["deconv"] = dict(
        tot, max_abs_err=max([r["max_abs_err"] for *_, r in sites]
                             + [r32["max_abs_err"]]),
        bound_by=max(sites, key=lambda t: t[4] * t[5]["bound_ms"])[5][
            "bound_by"])
    log(f"phase 2: deconv, the 14 sites of one {B}-frame batch: kernel "
        f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
        f"conv_transpose2d {tot['library_ms']:.3f} ms, bound "
        f"{tot['bound_ms']:.3f} ms")

    N = 36 * B
    for dtype, H, Dh in ((torch.float32, 16, 64), (torch.bfloat16, 16, 64),
                         (torch.float32, 64, 16), (torch.bfloat16, 8, 128)):
        qkv = torch.randn((N, 577, 3 * H * Dh), generator=g, device=dev).to(
            dtype)
        q, k, v = qkv.view(N, 577, 3, H, Dh).unbind(2)
        scale = Dh ** -0.5
        o = short_seq_attention(q, k, v, scale).float()
        o_p = short_seq_attention_plain(q, k, v, scale).float()
        err = float((o - o_p).abs().max())
        mean_err = float((o - o_p).abs().mean())
        f32 = dtype == torch.float32
        ok = err <= 2e-5 if f32 else (err <= 8e-3 and mean_err <= 1e-5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ops = 4.0 * 577 * 577 * Dh * N * H
        r = dict(max_abs_err=err, mean_abs_err=mean_err,
                 ms=time_ms(lambda: short_seq_attention(q, k, v, scale)),
                 plain_ms=time_ms(lambda: short_seq_attention_plain(
                     q, k, v, scale), reps=2),
                 library_ms=time_ms(
                     lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, scale=scale)),
                 **least_time(nbytes(qkv) + nbytes(qkv) // 3,
                              **({"f32": ops + 5.0 * 577 * 577 * N * H}
                                 if f32 else
                                 {"bf16_tensor": ops,
                                  "f32": 5.0 * 577 * 577 * N * H})))
        name = f"attention_split {str(dtype)[6:]} [{N}, 577, {H}, {Dh}]"
        log(f"phase 2: {name}: max_abs_err {err:.3g}, mean {mean_err:.3g} "
            f"[{'max 2e-5' if f32 else 'max 8e-3, mean 1e-5'}], kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, sdpa "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']})")
        check(ok, f"{name} disagrees: max {err}, mean {mean_err}")
        if f32 and Dh == 64:
            res["attention_split"] = r      # the float32 DepthPro's shape
        del qkv, q, k, v, o, o_p
    return res


def drive(frames, depth_fn, params):
    """One counted run of the main path: launch counters set to 0 just
    before, read just after. Returns (outputs, seconds per batch, counts)."""
    import torch
    from vsc_tpu_torch.ops import _cuda
    from vsc_tpu_torch.pipeline.stream_convert import render_sbs
    _cuda.reset_launches()
    outs, batch_s = [], []
    for f in frames:   # one synchronize per batch, as the CLI's copy-out has
        t0 = time.perf_counter()
        outs.append(render_sbs(f, depth_fn, params))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    return outs, batch_s, dict(_cuda.LAUNCHES)


def small_sbs_check(params, dev):
    """The SBS composition on the card vs the CPU plain path, 2 x 72 x 128,
    disparity and convergence scaled from 1920 to 128 columns."""
    import torch
    from vsc_tpu_torch.ops.stereo import StereoParams, generate_sbs
    g = torch.Generator().manual_seed(3)
    rgb = (torch.rand((2, 72, 128, 3), generator=g) * 255).to(torch.uint8)
    dsm = (smooth_depth(2, 72, 128, torch.device("cpu"), 4) * 255).to(
        torch.uint8)
    small = StereoParams(max_disparity=params.max_disparity * 128 / 1920,
                         convergence=params.convergence * 128 / 1920,
                         super_sampling=params.super_sampling)
    ref = generate_sbs(rgb, dsm, small).int()
    got = generate_sbs(rgb.to(dev), dsm.to(dev), small).cpu().int()
    diff = (got - ref).abs().float()
    mean, over1, top = (float(diff.mean()), float((diff > 1).float().mean()),
                        int(diff.max()))
    log(f"phase 3: small SBS card vs CPU plain at super_sampling "
        f"{params.super_sampling:g}: mean diff {mean:.4f}, >1 code "
        f"{over1:.5f}, max {top}")
    check(mean < 0.05 and over1 < 0.005 and top <= 16,
          "SBS on the card disagrees with the CPU plain path")


def phase_4k():
    """The super_sampling 3 branch at 2160 x 3840, batch 1: each new kernel
    against its plain version at those shapes (phase_ss_kernels), then
    generate_sbs on the card: output shape, type and a non-constant
    picture."""
    import torch
    from vsc_tpu_torch.ops.stereo import StereoParams, generate_sbs
    dev = torch.device("cuda")
    phase_ss_kernels(1, 2160, 3840)
    rgb = frames_u8(1, dev, 7, 2160, 3840)
    depth = (smooth_depth(1, 2160, 3840, dev, 8) * 255).to(torch.uint8)
    torch.cuda.reset_peak_memory_stats()
    t_sbs = time_ms(lambda: generate_sbs(rgb, depth, StereoParams()), reps=2)
    out = generate_sbs(rgb, depth, StereoParams())
    check(tuple(out.shape) == (1, 2160, 7680, 3) and out.dtype == torch.uint8,
          f"4K SBS output {tuple(out.shape)} {out.dtype}")
    check(float(out.float().std()) > 1.0, "4K SBS output is flat")
    log(f"phase 2: 2160x3840 SBS at the defaults: {tuple(out.shape)} u8, "
        f"{t_sbs:.1f} ms/frame, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def merge_kernel_results(ss1: dict, ss3: dict, depth: dict) -> dict:
    """One row per launch counter for the kernels line: times at the main
    path's (super_sampling 3) shapes where the kernel has a check there
    (super_sampling 1 times kept beside them), the largest error over every
    check of the kernel; a row of several checks (upsample, pool) sums
    their times and bounds, and has a library time only when every part
    has one."""
    rows = dict(ss1)
    rows.update(depth)
    parts = {"upsample": ("upsample_u8", "upsample_f32"),
             "pool": ("pool_eye4", "pool_f32"), "pyramid": ("pyramid",),
             "finish": ("finish",), "warp": ("warp_planar_u8",),
             "blur": ("blur",), "postprocess": ("postprocess",),
             "bilateral": ("bilateral",)}
    for name, keys in parts.items():
        row = {"max_abs_err": max([ss3[k]["max_abs_err"] for k in keys]
                                  + ([ss1[name]["max_abs_err"]]
                                     if name in ss1 else [])),
               "ms": sum(ss3[k]["ms"] for k in keys),
               "plain_ms": sum(ss3[k]["plain_ms"] for k in keys),
               "bound_ms": sum(ss3[k]["bound_ms"] for k in keys),
               "bound_by": max((ss3[k] for k in keys),
                               key=lambda r: r["bound_ms"])["bound_by"],
               "library_ms": (sum(ss3[k]["library_ms"] for k in keys)
                              if all("library_ms" in ss3[k] for k in keys)
                              else None)}
        if name in ss1:
            row.update(ss1_ms=ss1[name]["ms"], ss1_plain_ms=ss1[name]["plain_ms"])
        rows[name] = row
    return rows


ROUTE_BATCHES = 2     # batches of each opt-in route in phase 3
# u8 depth of the deconv route against the cuDNN route's, same frames
DECONV_DEPTH_MEAN = 0.5     # codes
DECONV_DEPTH_MAX = 16


class env_set:
    """Set one environment variable inside a with-block (restored after)."""

    def __init__(self, name: str, value: str):
        self.name, self.value = name, value

    def __enter__(self):
        self.saved = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.saved


def depth_diff(a, b) -> tuple[float, int]:
    d = (a.int() - b.int()).abs().float()
    return float(d.mean()), int(d.max())


def phase_routes(B: int, depth_fn, frames, params, t_depth: float,
                 t_sbs: float, card: str) -> dict:
    """The JAX package's opt-in routes to its last three kernels, each
    driven through render_sbs for ROUTE_BATCHES batches with the launch
    counters reset around the run. Returns each route's counts."""
    import torch
    from vsc_tpu_torch.models import depthpro
    from vsc_tpu_torch.ops.stereo import generate_sbs
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depth_fn
    from vsc_tpu_torch.pipeline.stream_convert import render_sbs
    dev = torch.device("cuda")
    n = ROUTE_BATCHES
    frames = frames[:n]

    def timing(name, bs, td, ts):
        log(f"phase 3: {name}: depth {td / B:.1f} ms/frame, SBS "
            f"{ts / B:.1f} ms/frame, end to end "
            f"{B * len(bs) / sum(bs):.3f} fps ({B * len(bs)} frames, host "
            f"clock; per batch "
            f"{' / '.join(f'{1e3 * x / B:.1f}' for x in bs)} ms/frame) on "
            f"{card} (default route: depth {t_depth / B:.1f}, SBS "
            f"{t_sbs / B:.1f} ms/frame)")

    # 1. split bilateral: every SBS frame equals the default route's on the
    # same depth
    depths = []

    def recording(x):
        depths.append(depth_fn(x))
        return depths[-1]

    with env_set("VSC_TPU_PP_SPLIT", "1"):
        for f in frames:                                    # warm-up
            render_sbs(f, depth_fn, params)
        torch.cuda.synchronize()
        outs, bs, l_split = drive(frames, recording, params)
        ts = time_ms(lambda: generate_sbs(frames[0], depths[0], params),
                     reps=10)
    log(f"phase 3: launches over {n} batches, VSC_TPU_PP_SPLIT=1: {l_split}")
    check(l_split["bilateral"] > 0 and l_split["postprocess"] > 0, l_split)
    same = [torch.equal(o, generate_sbs(f, d, params))
            for o, f, d in zip(outs, frames, depths)]
    log(f"phase 3: split route SBS equal to the default route's on "
        f"{sum(same)} of {len(same)} batches")
    check(all(same), "the split route's SBS differs from the default route's")
    timing("VSC_TPU_PP_SPLIT=1", bs, t_depth, ts)
    with env_set("VSC_TPU_PP_SPLIT", "1"):
        log_profile("one VSC_TPU_PP_SPLIT=1 batch",
                    lambda: render_sbs(frames[-1], depth_fn, params))

    # 2. deconv kernel at every ConvT2x2 site: u8 depth against the cuDNN
    # route's, and that bound against two broken deconvs
    ref = [depth_fn(f) for f in frames]
    with env_set("VSC_TPU_PALLAS_DECONV", "1"):
        for f in frames:                                    # warm-up
            render_sbs(f, depth_fn, params)
        torch.cuda.synchronize()
        depths.clear()
        _, bs, l_dec = drive(frames, recording, params)
        td = time_ms(lambda: depth_fn(frames[0]), reps=3)
        real = depthpro.deconv2x2
        broken = {
            "drops its last 8 input channels": lambda x, w, b: real(
                x[:, :-8].contiguous(), w[:-8].contiguous(), b),
            "swaps the row and column phases": lambda x, w, b: real(
                x, w.transpose(2, 3).contiguous(), b)}
        mutants = {}
        try:
            for what, fn in broken.items():
                depthpro.deconv2x2 = fn
                mutants[what] = depth_diff(depth_fn(frames[0]), ref[0])
        finally:
            depthpro.deconv2x2 = real
    log(f"phase 3: launches over {n} batches, VSC_TPU_PALLAS_DECONV=1: "
        f"{l_dec}")
    check(l_dec["deconv"] > 0, l_dec)
    stats = [depth_diff(a, b) for a, b in zip(depths, ref)]
    mean, top = max(m for m, _ in stats), max(t for _, t in stats)
    log(f"phase 3: deconv route u8 depth vs the cuDNN route's: mean diff "
        f"{mean:.4f}, max {top} codes [bound mean {DECONV_DEPTH_MEAN}, max "
        f"{DECONV_DEPTH_MAX}]; a deconv that "
        + "; that ".join(f"{w}: mean {m:.3f}, max {t}"
                         for w, (m, t) in mutants.items()))
    check(mean <= DECONV_DEPTH_MEAN and top <= DECONV_DEPTH_MAX,
          "the deconv route's depth differs from the cuDNN route's")
    check(all(m > DECONV_DEPTH_MEAN or t > DECONV_DEPTH_MAX
              for m, t in mutants.values()),
          f"the depth bound accepts a broken deconv: {mutants}")
    timing("VSC_TPU_PALLAS_DECONV=1", bs, td, t_sbs)
    with env_set("VSC_TPU_PALLAS_DECONV", "1"):
        log_profile("one VSC_TPU_PALLAS_DECONV=1 batch",
                    lambda: render_sbs(frames[-1], depth_fn, params),
                    group=CONV_GROUP)

    # 3. float32 DepthPro: the split-q/k/v attention at head dim 64
    with env_set("VSC_TPU_DEPTH_DTYPE", "float32"):
        t0 = time.perf_counter()
        fn32 = build_depth_fn("depthpro", 1536, 1080, 1920, False,
                              device=dev, seed=0)
        render_sbs(frames[0], fn32, params)                 # warm-up
        torch.cuda.synchronize()
        log(f"phase 3: float32 DepthPro built and warmed in "
            f"{time.perf_counter() - t0:.1f} s")
        _, bs, l32 = drive(frames, fn32, params)
        d32 = fn32(frames[0])
        td = time_ms(lambda: fn32(frames[0]), reps=2)
    log(f"phase 3: launches over {n} batches, VSC_TPU_DEPTH_DTYPE=float32: "
        f"{l32}")
    check(l32["attention_split"] > 0 and l32["attention"] == 0, l32)
    check(d32.dtype == torch.uint8 and int(d32.max()) > int(d32.min()),
          "float32 depth is constant")
    m32, t32 = depth_diff(d32, ref[0])
    log(f"phase 3: float32 u8 depth vs bf16 (same seed): mean diff "
        f"{m32:.3f}, max {t32} codes")
    timing("VSC_TPU_DEPTH_DTYPE=float32", bs, td, t_sbs)
    log_profile("one VSC_TPU_DEPTH_DTYPE=float32 batch",
                lambda: render_sbs(frames[-1], fn32, params))
    del fn32
    return {"bilateral": l_split["bilateral"], "deconv": l_dec["deconv"],
            "attention_split": l32["attention_split"]}


def phase_slice(B: int, batches: int, card: str):
    import torch
    from vsc_tpu_torch.ops.stereo import StereoParams, generate_sbs
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depth_fn
    from vsc_tpu_torch.pipeline.stream_convert import render_sbs
    dev = torch.device("cuda")
    params = StereoParams()                       # super_sampling 3
    ss1 = StereoParams(super_sampling=1.0)
    t0 = time.perf_counter()
    depth_fn = build_depth_fn("depthpro", 1536, 1080, 1920, False,
                              device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"phase 3: full-width DepthPro (seed 0, bf16) built in "
        f"{time.perf_counter() - t0:.1f} s")
    frames = [frames_u8(B, dev, 10 + i) for i in range(batches)]
    render_sbs(frames[0], depth_fn, params)              # warm-up
    render_sbs(frames[0], depth_fn, ss1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path at the defaults
    outs, batch_s, launches = drive(frames, depth_fn, params)
    log(f"phase 3: launches over {batches} batches of {B} at the defaults "
        f"(super_sampling 3): {launches}")
    for o in outs:
        check(tuple(o.shape) == (B, 1080, 3840, 3), o.shape)
        check(o.dtype == torch.uint8, o.dtype)
    check(all(launches[k] > 0 for k, *_ in KERNELS[:8]), launches)
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the compat branch, shorter
    outs1, batch_s1, launches1 = drive(frames[:BATCHES_SS1], depth_fn, ss1)
    log(f"phase 3: launches over {BATCHES_SS1} batches at super_sampling 1: "
        f"{launches1}")
    for o in outs1:
        check(tuple(o.shape) == (B, 1080, 3840, 3), o.shape)
    check(all(launches1[k] > 0
              for k in ("blur", "warp", "postprocess", "attention")),
          launches1)
    depth = depth_fn(frames[0])
    check(depth.dtype == torch.uint8 and int(depth.max()) > int(depth.min()),
          "depth is constant")

    # breakdown (outside the counted runs)
    t_depth = time_ms(lambda: depth_fn(frames[0]), reps=3)
    t_sbs = time_ms(lambda: generate_sbs(frames[0], depth, params), reps=10)
    t_sbs1 = time_ms(lambda: generate_sbs(frames[0], depth, ss1), reps=10)
    for name, bs, t in (("super_sampling 3", batch_s, t_sbs),
                        ("super_sampling 1", batch_s1, t_sbs1)):
        per_frame = sorted(1e3 * x / B for x in bs)
        log(f"phase 3: {name}: depth {t_depth / B:.1f} ms/frame, SBS "
            f"{t / B:.1f} ms/frame, end to end {B * len(bs) / sum(bs):.3f} "
            f"fps ({B * len(bs)} frames, host clock; per batch "
            f"{per_frame[0]:.1f} / {per_frame[len(per_frame) // 2]:.1f} / "
            f"{per_frame[-1]:.1f} ms/frame min / median / max) on {card}")
    log(f"phase 3: peak device memory at the defaults {peak:.2f} GiB")
    log_profile("one default batch",
                lambda: render_sbs(frames[-1], depth_fn, params),
                group=CONV_GROUP)

    small_sbs_check(ss1, dev)
    small_sbs_check(params, dev)
    launches.update(phase_routes(B, depth_fn, frames, params, t_depth, t_sbs,
                                 card))
    return launches


def phase_cli():
    missing = []
    try:
        import tqdm  # noqa: F401
    except ImportError:
        missing.append("tqdm")
    from vsc_tpu_torch.native import vscmedia_path
    engine = vscmedia_path()
    try:   # a binary whose libav libraries are absent cannot even start
        usable = engine is not None and subprocess.run(
            [str(engine)], capture_output=True, timeout=60).returncode != 127
    except OSError:
        usable = False
    if not usable:
        missing.append("the vscmedia media engine (libav)")
    if missing:
        log(f"phase 4: not run: missing {' and '.join(missing)}")
        return
    from vsc_tpu_torch.config import (create_default_config, get_path,
                                      load_config, save_config)
    from vsc_tpu_torch.io.media import make_test_video
    from vsc_tpu_torch.io.probe import probe_video
    from vsc_tpu_torch.pipeline import stream_convert
    with tempfile.TemporaryDirectory() as tmp:
        video = Path(tmp) / "clip.mkv"
        make_test_video(video, width=320, height=180, frames=12,
                        framerate="24/1", with_audio=True)
        wf = Path(tmp) / "workflow"
        for sub in ("frames", "depth_maps", "sbs", "chunks"):
            (wf / sub).mkdir(parents=True)
        save_config(wf, create_default_config(video))
        config = load_config(wf)
        config["stereo"]["super_sampling"] = 1.0
        config["encoding"] = {"crf": 30, "preset": "ultrafast"}
        save_config(wf, config)
        t0 = time.perf_counter()
        ok = stream_convert.run(wf, config, batch_size=2, chunk_size=8,
                                model_name="depthpro", input_size=1536)
        check(ok, "stream_convert.run failed")
        info = probe_video(get_path(wf, config, "output_video"))
        check(info["width"] == 640 and info["height"] == 180, info)
        log(f"phase 4: stream_convert.run on a 12-frame 320x180 clip: "
            f"{info['width']}x{info['height']} {info['vcodec']}, "
            f"{time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--phases", default="1,2,3,4")
    args = ap.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")}

    if not (REPO / "vsc_tpu_torch" / "csrc").is_dir():
        print("ERROR: vsc_tpu_torch sources not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("ERROR: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ERROR: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_card_and_build()
    kern = {}
    if 2 in phases:
        kern = merge_kernel_results(phase_kernels(BATCH),
                                    phase_ss_kernels(BATCH),
                                    phase_depth_kernels(BATCH))
        phase_4k()
    launches = phase_slice(BATCH, BATCHES, card) if 3 in phases else {}
    if 4 in phases:
        phase_cli()
    check(not any(m.split(".")[0] in ("jax", "flax", "vsc_tpu")
                  for m in sys.modules),
          "the port pulled in jax or the JAX package")

    line = {"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": launches.get(name, 0),
         **{k: kern.get(name, {}).get(k)
            for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                      "bound_by", "library_ms")}}
        for name, route, src, rep in KERNELS]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
