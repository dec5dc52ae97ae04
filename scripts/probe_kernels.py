"""Where the time of a hand-written kernel goes, on the card.

Builds copies of a kernel's source outside the port's library (nvcc into
build/probe/, one process per copy, all started together), loads each with
ctypes and times it at the default path's shapes (1080p, super_sampling 3,
batch 2):

- blur (``vsc_tpu_torch/csrc/blur.cu``): [2, 3240, 6090] f32, k = 31,
  sigma 20, with the gamma (0.2) and without it;
- finish (``csrc/finish.cu``): the [3, 4, 3240, 6090] u8 pair, each eye
  cropped at the defaults' offsets, ratio 3, u8 out;
- upsample (``csrc/upsample.cu``): [6, 1080, 2030] RGB to u8 and
  [2, 1080, 2030] depth to f32, factor 3;
- pyramid (``csrc/pyramid.cu``): the whole ladder of the [4, 4, 810, 1523]
  f32 quarter (a third of it in holes);
- bilateral (``csrc/bilateral.cu``): the [4, 4, 3240, 6090] u8 pair at the
  defaults' smoothing (radius 2): chip_smoke phase 2's warped pair, and
  scene-like colors and uniform noise under 16 % scattered holes.

Each kernel's variants are text substitutions of its source, each of which
must match the source exactly once (a variant whose text is not found is
skipped, so one table serves the kernel as it is and the designs it
replaced, given with ``--source``), or a source of their own under
``scripts/probe_variants/`` that includes the kernel's:

- ``kernel``: the source as it is;
- blur ``vertical only`` / ``horizontal only``: the other pass's taps
  replaced by a copy, so what is left is that pass, the staging and the
  output;
- finish ``no vertical taps`` / ``no horizontal taps``: that pass keeps
  its first tap only (the vertical pass its first add), so what is left
  is the other pass, the loads, the sharpen and the box; ``exponent-trick
  conversion``: bytes to floats as 0x4B0000bb - 2^23 (a byte permute and
  a subtraction), not by the I2F conversion; ``launch bounds``: launch
  bounds of the block's threads (ptxas then aims at fewer registers and
  spills a few bytes at some ratios); ``bounded to 64 registers``: launch
  bounds that ask for 1024 threads an SM; ``blocks of 128 threads`` (not
  64); ``tiles of 8 / 32 rows`` (not 16); ``packed stores``: each u8
  output row written 4 bytes a store (the bytes gathered by two
  ``__shfl_down_sync``), not a byte a thread; ``rows staged in shared
  memory`` (``probe_variants/finish_staged.cu``): each block stages its
  rows with aligned 16-byte loads, five rows between two barriers, and
  each thread reads its bytes from there; ``ratio a constant``: for the
  design the kernel replaced (its source given with ``--source``), the
  ratio made a compile-time 3 where it was a run-time argument;
- upsample ``no global stores``: the output never leaves the warps'
  stages; ``lanes store their own values``: no stage, each lane stores
  its outputs itself, one element at a time; ``strips of 4 rows``: a
  warp takes 4 source rows, not 2; ``launch bounds``: as for the
  finish; ``blocks of 8 warps``: 8 warps a block, not 4;
- pyramid ``output 2 x 2 pixels a thread``: the up pass writes each
  thread's own 2 x 2 pixels in place, not each output row of a region as
  one coalesced run from a staged tile; ``top pass only``, ``wide passes
  only``, ``down pass only``: the other launches left out; ``empty ladder
  of 18 cluster barriers, clusters of 8`` / ``16``
  (``probe_variants/cluster_ladder.cu``): one cluster per frame and
  nothing but 18 ``cluster.sync()``s, the latency floor of a design whose
  small levels run in a cluster, a barrier between levels;
- bilateral ``exp per tap``: each tap's color weight from expf, not from
  the block's table; ``num raised before the division``: num first
  raised to den * 2^-30 (no result moves; a tiny numerator otherwise
  sends the IEEE division down its slow path); ``no quarter``: the quarter's sums left
  out; ``no division``, ``unit weights`` (no distance, table or space
  weight), ``no taps`` (ablations).

The ablations (no taps, no stores, own stores, one pass, passes left out,
the cluster ladder, no quarter) compute wrong output and are only timed;
every other variant is first checked bit for bit against the plain
version (the bilateral's colors within 1 code on < 0.1 % of pixels, its
valid plane and quarter exact). Times are CUDA events over 20 launches
after a warm-up, each variant timed twice in the order a, b, ..., b, a;
then, for the kernel as it is, the device time of each of its launches
(torch.profiler over 5 calls).
Run from the repository root on a machine with a card and nvcc:

    python3 scripts/probe_kernels.py [--kernel NAME|all] [--source PATH ...]

``--source`` adds another copy of a kernel with the same C entry and
arguments (for example the parent commit's, unpacked elsewhere), labelled
by its path and built against the headers beside it; it is taken for the
kernel its file is named after.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import profile_device  # noqa: E402
from vsc_tpu_torch.ops import stereo  # noqa: E402
from vsc_tpu_torch.ops.bilateral_cuda import bilateral_pool_plain  # noqa: E402
from vsc_tpu_torch.ops.blur_cuda import gaussian_blur_planes_plain  # noqa: E402
from vsc_tpu_torch.ops.filters import gaussian_kernel1d  # noqa: E402
from vsc_tpu_torch.ops.finish_cuda import _taps, sharpen_downscale_plain  # noqa: E402
from vsc_tpu_torch.ops.postprocess_cuda import bilateral_tables  # noqa: E402
from vsc_tpu_torch.ops.pyramid_cuda import pyramid_fill_below_plain  # noqa: E402
from vsc_tpu_torch.ops.upsample_cuda import (  # noqa: E402
    _weights, upsample_bilinear_int_plain)

CSRC = REPO / "vsc_tpu_torch" / "csrc"
VARIANTS = Path(__file__).resolve().parent / "probe_variants"
OUT = REPO / "build" / "probe"
NVCC = "/usr/local/cuda/bin/nvcc"
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclass(frozen=True)
class Kernel:
    entry: str        # the C entry every copy exports
    args: list        # its ctypes argument types
    cases: Callable   # dev -> [(label, run(entry) -> output, plain output)]
    subs: dict        # variant -> [(text, replacement), ...]
    # variant -> its own source, or (source, [(text, replacement), ...])
    files: dict = field(default_factory=dict)
    unchecked: tuple = ()   # ablations: timed, not checked
    agrees: Callable = torch.equal   # (output, plain output) -> bool


def blur_cases(dev) -> list:
    N, H, W, k, sigma, gamma = 2, 3240, 6090, 31, 20.0, 0.2
    x = torch.rand((N, H, W), generator=torch.Generator(dev).manual_seed(0),
                   device=dev)
    taps = np.ascontiguousarray(gaussian_kernel1d(k, sigma), np.float32)
    out = torch.empty_like(x)
    res = []
    for g in (1, 0):
        def run(fn, g=g):
            code = fn(x.data_ptr(), out.data_ptr(),
                      taps.ctypes.data_as(ctypes.c_void_p), N, H, W, k, gamma,
                      g, torch.cuda.current_stream().cuda_stream)
            assert code == 0, code
            return out
        res.append((f"[{N}, {H}, {W}] f32, k {k}, gamma "
                    f"{'on' if g else 'off'}", run,
                    gaussian_blur_planes_plain(x, k, sigma, gamma if g
                                               else None)))
    return res


def finish_cases(dev) -> list:
    H, W = 1080, 1920
    p = stereo.StereoParams()
    s = stereo.sbs_shapes(H, W, p)
    lo, ro, crop_w = stereo._crop_offsets(H, W, p)
    N, UH, UW, r = 4, s["up_h"], s["up_w"], 3
    x = torch.randint(0, 256, (3, N, UH, UW), device=dev, dtype=torch.uint8,
                      generator=torch.Generator(dev).manual_seed(0))
    out = torch.empty((3, N, H, W), dtype=torch.uint8, device=dev)
    taps = _taps()

    def run(fn):
        code = fn(x.data_ptr(), out.data_ptr(),
                  taps.ctypes.data_as(ctypes.c_void_p), N, UH, UW, crop_w,
                  lo, ro, N // 2, r, float(p.sharpen), H, W, 1,
                  torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return out
    return [(f"[3, {N}, {UH}, {UW}] u8, crop {crop_w} at ({lo}, {ro}), "
             f"ratio {r}", run,
             sharpen_downscale_plain(x, r, float(p.sharpen), H, W, crop_w,
                                     (lo, ro)))]


def upsample_cases(dev) -> list:
    H, W = 1080, 1920
    SW, f = stereo.sbs_shapes(H, W, stereo.StereoParams())["stretched_w"], 3
    wa, wb = _weights(f)
    g = torch.Generator(dev).manual_seed(0)
    res = []
    for u8, n in ((True, 6), (False, 2)):
        x = torch.rand((n, H, SW), generator=g, device=dev)
        x = torch.floor(x * 256) if u8 else x
        out = torch.empty((n, H * f, SW * f), device=dev,
                          dtype=torch.uint8 if u8 else torch.float32)

        def run(fn, x=x, out=out, n=n, u8=u8):
            code = fn(x.data_ptr(), out.data_ptr(), wa.ctypes.data,
                      wb.ctypes.data, n, H, SW, f, int(u8),
                      torch.cuda.current_stream().cuda_stream)
            assert code == 0, code
            return out
        res.append((f"[{n}, {H}, {SW}] -> {'u8' if u8 else 'f32'}, factor "
                    f"{f}", run, upsample_bilinear_int_plain(x, f, u8)))
    return res


def pyramid_cases(dev) -> list:
    N, h, w = 4, 810, 1523
    g = torch.Generator(dev).manual_seed(0)
    valid = torch.rand((N, h, w), generator=g, device=dev)
    valid = torch.where(valid < 0.2, torch.zeros_like(valid), valid)
    valid[:, : h // 2, : w // 3] = 0.0
    img = torch.rand((3, N, h, w), generator=g, device=dev) * 255 * valid
    q = torch.cat([img, valid[None]]).contiguous()
    out = torch.empty((3, N, h, w), device=dev)
    # room for every variant's workspace (and for a design that keeps a
    # frame's ladder at ws + n * ws_floats)
    ws = torch.empty((N * 4 * h * w,), device=dev)

    def run(fn):
        code = fn(q.data_ptr(), out.data_ptr(), ws.data_ptr(), N, h, w,
                  4 * h * w, torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return out
    return [(f"[4, {N}, {h}, {w}] f32", run, pyramid_fill_below_plain(q))]


def ss3_pair(dev, B: int = 2, H: int = 1080, W: int = 1920):
    """chip_smoke phase 2's eye pair at the defaults: its frames stretched
    and upsampled, warped by the blur of its up-res depth."""
    from chip_smoke import frames_u8, smooth_depth
    from vsc_tpu_torch.ops.blur_cuda import gaussian_blur_planes
    from vsc_tpu_torch.ops.resize import resize
    from vsc_tpu_torch.ops.upsample_cuda import upsample_bilinear_int
    from vsc_tpu_torch.ops.warp_cuda import forward_warp_pair_planar
    p = stereo.StereoParams()
    s = stereo.sbs_shapes(H, W, p)
    SW, f = s["stretched_w"], 3
    rgb = frames_u8(B, dev, 5, H, W).float()
    rgb_st = stereo._quantize_like(resize(rgb, H, SW, "lanczos4",
                                          channel_last=True), 255.0)
    x_cf = torch.movedim(rgb_st, -1, 1).reshape(-1, H, SW).contiguous()
    up = upsample_bilinear_int(x_cf, f, quantize_u8=True)
    up_d = upsample_bilinear_int(smooth_depth(B, H, SW, dev, 1), f)
    k = max(5, min(int(p.edge_softness * 6) | 1, 31))
    dn = gaussian_blur_planes(up_d, k, p.edge_softness, p.depth_gamma)
    return forward_warp_pair_planar(up.reshape(B, 3, s["up_h"], s["up_w"]),
                                    dn, p.max_disparity)


def bilateral_cases(dev) -> list:
    B, H, W = 4, 3240, 6090
    sm = stereo.StereoParams().artifact_smoothing
    rb, space_w, inv2sc = bilateral_tables(sm)
    g = torch.Generator(dev).manual_seed(0)
    yy = torch.arange(H, device=dev)[:, None].float()
    xx = torch.arange(W, device=dev)[None, :].float()
    scene = (128 + 100 * torch.sin(xx / 37.0) * torch.cos(yy / 53.0)
             + 8 * torch.randn((3, B, H, W), generator=g, device=dev))
    noise = 256 * torch.rand((3, B, H, W), generator=g, device=dev)
    valid = (torch.rand((B, H, W), generator=g, device=dev) > 0.16).float()
    res = []
    pairs = [("chip_smoke's warped pair", ss3_pair(dev))] + [
        (label, torch.cat([torch.floor(rgb.clamp(0, 255)) * valid,
                           valid[None]]).to(torch.uint8))
        for label, rgb in (("scene-like colors", scene),
                           ("uniform noise", noise))]
    del scene, noise
    for label, eye4 in pairs:
        out = torch.empty_like(eye4)
        quarter = torch.empty((4, B, H // 4, (W // 2 + 1) // 2), device=dev)

        def run(fn, eye4=eye4, out=out, quarter=quarter):
            code = fn(eye4.data_ptr(), out.data_ptr(), quarter.data_ptr(),
                      space_w.ctypes.data_as(ctypes.c_void_p), inv2sc, B, H,
                      W, rb, torch.cuda.current_stream().cuda_stream)
            assert code == 0, code
            return out, quarter
        res.append((f"[4, {B}, {H}, {W}] u8, {label}, radius {rb}", run,
                    bilateral_pool_plain(eye4, sm)))
    return res


def bilateral_agrees(got, want) -> bool:
    d = (got[0][:3].int() - want[0][:3].int()).abs()
    return (int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3
            and torch.equal(got[0][3], want[0][3])
            and torch.equal(got[1], want[1]))


PYRAMID_UP_TAIL = """\
  const int h = d.h[0], w = d.w[0];
  const int i = threadIdx.x / kSide1, j = threadIdx.x % kSide1;
  const int gy = by * kSide1 + i, gx = bx * kSide1 + j;
  if (gy >= d.h[1] || gx >= d.w[1]) return;
  const size_t plane = (size_t)d.N * h * w;
  float* o = out + (size_t)n * h * w;
  for (int a = 0; a < 2; ++a) {
    const int y = 2 * gy + a;
    if (y >= h) break;
    for (int b = 0; b < 2; ++b) {
      const int x = 2 * gx + b;
      if (x >= w) break;
      const float m = v[3][2 * a + b];
      for (int c = 0; c < 3; ++c)
        o[c * plane + (size_t)y * w + x] = fill(v[c][2 * a + b], m,
                                                s.lv[c][i][j]);
    }
  }
}"""
PYRAMID_UP_STAGED = """\
  // level 0 through a staged tile: a thread fills its 2 x 2 pixels, then
  // a warp writes each output row of the region as one coalesced run
  const int h = d.h[0], w = d.w[0];
  {
    const int i = threadIdx.x / kSide1, j = threadIdx.x % kSide1;
    for (int a = 0; a < 2; ++a)
      for (int b = 0; b < 2; ++b)
        for (int c = 0; c < 3; ++c)
          o0[c][2 * i + a][2 * j + b] =
              fill(v[c][2 * a + b], v[3][2 * a + b], s.lv[c][i][j]);
  }
  __syncthreads();
  const int lane = threadIdx.x % kRegion, x = bx * kRegion + lane;
  if (x >= w) return;
  const size_t plane = (size_t)d.N * h * w;
  float* o = out + (size_t)n * h * w + x;
  for (int r = threadIdx.x / kRegion; r < kRegion;
       r += kWideThreads / kRegion) {
    const int y = by * kRegion + r;
    if (y >= h) break;
    for (int c = 0; c < 3; ++c) o[c * plane + (size_t)y * w] = o0[c][r][lane];
  }
}"""
PYRAMID_DOWN = "pyramid_down_kernel<<<grid, kWideThreads, 0, s>>>(q, ws, d);"
PYRAMID_TOP = "pyramid_top_kernel<<<N, kTopThreads, 0, s>>>(ws, d);"
PYRAMID_UP = "pyramid_up_kernel<<<grid, kWideThreads, 0, s>>>(q, ws, out, d);"
BILATERAL_WEIGHT = "weight[(int)acc.distance(sh)]"
BILATERAL_FINISH = "acc.finish(o);"
BILATERAL_TAP = (
    "acc.add(__fmul_rn(t.w[i++], weight[(int)acc.distance(sh)]), sh);")

FINISH_U8_STORE = (
    "        if constexpr (kU8)\n"
    "          static_cast<uint8_t*>(out)[o] =\n"
    "              (uint8_t)floorf(fminf(fmaxf(res, 0.0f), 255.0f));\n"
    "        else")
UPSAMPLE_VECTOR_STORE = (
    "        *reinterpret_cast<uint4*>(base + k) =\n"
    "            *reinterpret_cast<const uint4*>(stage + k);")
UPSAMPLE_END_STORE = "if (e < (lane < 16 ? v0 : end)) base[e] = stage[e];"

KERNELS = {
    "blur": Kernel(
        entry="vsc_blur", args=[P, P, P, I, I, I, I, F, I, P],
        cases=blur_cases,
        subs={
            "vertical only": [(
                "accumulate<K>(acc[m], i, row[c0 + i], taps);",
                "if (i < kRunH) acc[m][i] = row[c0 + i];")],
            "horizontal only": [(
                "accumulate<K>(acc, i, __ldg(src + y * W + gx), taps);",
                "if (i < kRunV) acc[i] = __ldg(src + y * W + gx);")]},
        unchecked=("vertical only", "horizontal only")),
    "finish": Kernel(
        entry="vsc_finish", args=[P, P, P, I, I, I, I, I, I, I, I, F, I, I,
                                  I, P],
        cases=finish_cases,
        subs={
            "no vertical taps": [(
                "      blur = __fadd_rn(blur, p2[(s + 3) % 5][j]);\n"
                "      blur = __fadd_rn(blur, p1[(s + 4) % 5][j]);\n"
                "      blur = __fadd_rn(blur, p0[s][j]);", "")],
            "no horizontal taps": [(
                "acc = __fadd_rn(acc, __fmul_rn(k.t[tap(t)], v[j + t]));",
                ";")],
            "exponent-trick conversion": [(
                "  return (float)((w >> (8 * k)) & 0xffu);",
                "  return __fsub_rn(__uint_as_float(__byte_perm(w, "
                "0x4B000000u, 0x7440 | k)),\n                   8388608.0f);")],
            "launch bounds": [(
                "__global__ void sharpen_downscale_kernel(",
                "__global__ void __launch_bounds__(kThreads)\n"
                "sharpen_downscale_kernel(")],
            "bounded to 64 registers": [(
                "__global__ void sharpen_downscale_kernel(",
                "__global__ void __launch_bounds__(kThreads, 1024 / kThreads)"
                "\nsharpen_downscale_kernel(")],
            "blocks of 128 threads": [("constexpr int kThreads = 64;",
                                       "constexpr int kThreads = 128;")],
            "tiles of 8 rows": [("constexpr int kTileH = 16;",
                                 "constexpr int kTileH = 8;")],
            "tiles of 32 rows": [("constexpr int kTileH = 16;",
                                  "constexpr int kTileH = 32;")],
            # the block's whole warps meet the shuffles: out_w % 64 == 0
            # (the defaults' 1920), else a byte a thread as the kernel does
            "packed stores": [(FINISH_U8_STORE, (
                "        if constexpr (kU8) {\n"
                "          uint32_t b = (uint32_t)floorf(fminf(fmaxf(res, "
                "0.0f), 255.0f));\n"
                "          if (out_w % kThreads) {\n"
                "            static_cast<uint8_t*>(out)[o] = (uint8_t)b;\n"
                "          } else {\n"
                "            b |= __shfl_down_sync(~0u, b, 1) << 8;\n"
                "            b |= __shfl_down_sync(~0u, b, 2) << 16;\n"
                "            if ((threadIdx.x & 3) == 0)\n"
                "              *reinterpret_cast<uint32_t*>(\n"
                "                  static_cast<uint8_t*>(out) + o) = b;\n"
                "          }\n"
                "        } else"))],
            "ratio a constant": [
                ("extern __shared__ __align__(16) unsigned char smem[];",
                 "extern __shared__ __align__(16) unsigned char smem[];\n"
                 "  constexpr int r = 3;"),
                ("int nsplit, int r,\n", "int nsplit, int r_arg,\n")]},
        files={"rows staged in shared memory":
               VARIANTS / "finish_staged.cu"},
        unchecked=("no vertical taps", "no horizontal taps")),
    "upsample": Kernel(
        entry="vsc_upsample", args=[P, P, P, P, I, I, I, I, I, P],
        cases=upsample_cases,
        subs={
            "no global stores": [(UPSAMPLE_VECTOR_STORE, ";"),
                                 (UPSAMPLE_END_STORE, "")],
            "lanes store their own values": [
                ("stage[shift + F * (lane + 32 * v) + q] = o;",
                 "if (F * (lane + 32 * v) < len) "
                 "dst[g0 + F * (lane + 32 * v) + q] = o;"),
                (UPSAMPLE_END_STORE, ""),
                (UPSAMPLE_VECTOR_STORE, ";")],
            "strips of 4 rows": [("constexpr int kStrip = 2;",
                                  "constexpr int kStrip = 4;")],
            "launch bounds": [(
                "__global__ void upsample_kernel(",
                "__global__ void __launch_bounds__(kThreads)\n"
                "upsample_kernel(")],
            "blocks of 8 warps": [("constexpr int kWarps = 4;",
                                   "constexpr int kWarps = 8;")]},
        unchecked=("no global stores", "lanes store their own values")),
    "pyramid": Kernel(
        entry="vsc_pyramid", args=[P, P, P, I, I, I, ctypes.c_longlong, P],
        cases=pyramid_cases,
        subs={
            "output 2 x 2 pixels a thread": [
                (PYRAMID_UP_STAGED, PYRAMID_UP_TAIL)],
            "top pass only": [(PYRAMID_DOWN, ";"), (PYRAMID_UP, ";")],
            "wide passes only": [(PYRAMID_TOP, ";")],
            "down pass only": [(PYRAMID_TOP, ";"), (PYRAMID_UP, ";")]},
        files={
            "empty ladder of 18 cluster barriers, clusters of 8":
                VARIANTS / "cluster_ladder.cu",
            "empty ladder of 18 cluster barriers, clusters of 16":
                (VARIANTS / "cluster_ladder.cu",
                 [("constexpr int kCluster = 8;",
                   "constexpr int kCluster = 16;")])},
        unchecked=("top pass only", "wide passes only", "down pass only",
                   "empty ladder of 18 cluster barriers, clusters of 8",
                   "empty ladder of 18 cluster barriers, clusters of 16")),
    "bilateral": Kernel(
        entry="vsc_bilateral_pool", args=[P, P, P, P, F, I, I, I, I, P],
        cases=bilateral_cases,
        subs={
            "exp per tap": [(
                BILATERAL_WEIGHT,
                "vsc::color_weight(t.inv2sc, acc.distance(sh))")],
            "num raised before the division": [(BILATERAL_FINISH, (
                "for (int k = 0; k < 3; ++k) o[k] = floorf(fminf(fmaxf("
                "rintf(__fdiv_rn(fmaxf(acc.num[k], __fmul_rn(acc.den, "
                "0x1p-30f)), acc.den)), 0.0f), 255.0f));"))],
            "no quarter": [("  if (quarter != nullptr) {",
                            "  if (false) {")],
            "no division (ablation)": [(
                BILATERAL_FINISH,
                "for (int k = 0; k < 3; ++k) o[k] = acc.num[k];")],
            "unit weights (ablation)": [(BILATERAL_TAP,
                                         "acc.add(t.w[i++], sh);")],
            "no taps (ablation)": [(BILATERAL_TAP, "i++;")]},
        unchecked=("no quarter", "no division (ablation)",
                   "unit weights (ablation)", "no taps (ablation)"),
        agrees=bilateral_agrees),
}


def variants(name: str, path: Path) -> dict:
    """label -> (source, its include directory): the kernel at path and its
    variants."""
    kern = KERNELS[name]
    src = path.read_text()
    prefix = "" if path.parent == CSRC else f"{path}: "
    out = {prefix + "kernel": src}
    for var, subs in kern.subs.items():
        if any(src.count(text) != 1 for text, _ in subs):
            print(f"{path}: {var!r} skipped (its text is not in the source "
                  "once)", flush=True)
            continue
        v = src
        for text, repl in subs:
            v = v.replace(text, repl)
        out[prefix + var] = v
    if not prefix:
        for var, f in kern.files.items():
            f, subs = f if isinstance(f, tuple) else (f, [])
            v = f.read_text()
            for text, repl in subs:
                v = v.replace(text, repl)
            out[var] = v
    return {label: (v, path.parent) for label, v in out.items()}


def build(name: str, srcs: dict) -> dict:
    """label -> the C entry of its copy, nvcc'd in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, (src, inc)) in enumerate(srcs.items()):
        cu = OUT / f"{name}_{i}.cu"
        cu.write_text(src)
        procs[label] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-I", str(inc), "-Xcompiler", "-fPIC", "-shared", "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    entries = {}
    for i, (label, proc) in enumerate(procs.items()):
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} {label}: nvcc failed\n{err[-3000:]}")
        fn = getattr(ctypes.CDLL(str(OUT / f"{name}_{i}.so")),
                     KERNELS[name].entry)
        fn.argtypes = KERNELS[name].args
        entries[label] = fn
    return entries


def time_ms(fn, reps: int = 20) -> float:
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


def probe(name: str, sources: list, dev) -> None:
    srcs = {}
    for path in [CSRC / f"{name}.cu"] + sources:
        srcs.update(variants(name, path))
    entries = build(name, srcs)
    unchecked = KERNELS[name].unchecked
    for label, run, want in KERNELS[name].cases(dev):
        times = {v: [] for v in entries}
        for v in list(entries) + list(entries)[::-1]:
            got = run(entries[v])
            torch.cuda.synchronize()
            if (v.rsplit(": ", 1)[-1] not in unchecked
                    and not KERNELS[name].agrees(got, want)):
                raise SystemExit(f"{name} {v} differs from the plain version "
                                 f"({label})")
            times[v].append(time_ms(lambda fn=entries[v]: run(fn)))
        print(f"{name} probe: {label}, {torch.cuda.get_device_name(0)}",
              flush=True)
        for v, t in times.items():
            print(f"{name} {v}: {' / '.join(f'{x:.4f}' for x in t)} ms",
                  flush=True)
        # the kernel's own launches by name, device time (torch.profiler)
        reps = 5
        prof = profile_device(lambda: [run(entries["kernel"])
                                       for _ in range(reps)])
        print(f"{name} kernel, device time a call by launch: " + "; ".join(
            f"{n[:60]} {t / reps:.4f} ms"
            for n, t in prof["per_kernel"].items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=(*KERNELS, "all"), default="all")
    ap.add_argument("--source", action="append", type=Path, default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ERROR: no card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for name in KERNELS if args.kernel == "all" else (args.kernel,):
        probe(name, [s for s in args.source if s.stem == name], dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
