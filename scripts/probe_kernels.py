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
  [2, 1080, 2030] depth to f32, factor 3.

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
  finish; ``blocks of 8 warps``: 8 warps a block, not 4.

The ablations (no taps, no stores, own stores, one pass) compute wrong
output and are only timed; every other variant is first checked bit for
bit against the plain version. Times are CUDA events over 20 launches
after a warm-up, each variant timed twice in the order a, b, ..., b, a.
Run from the repository root on a machine with a card and nvcc:

    python3 scripts/probe_kernels.py [--kernel blur|finish|upsample|all]
                                     [--source PATH ...]

``--source`` adds another copy of a kernel with the same C entry and
arguments (for example the parent commit's, unpacked elsewhere), labelled
by its path; it is taken for the kernel its file is named after.
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
from vsc_tpu_torch.ops import stereo  # noqa: E402
from vsc_tpu_torch.ops.blur_cuda import gaussian_blur_planes_plain  # noqa: E402
from vsc_tpu_torch.ops.filters import gaussian_kernel1d  # noqa: E402
from vsc_tpu_torch.ops.finish_cuda import _taps, sharpen_downscale_plain  # noqa: E402
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
    files: dict = field(default_factory=dict)   # variant -> its own source
    unchecked: tuple = ()   # ablations: timed, not checked


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
}


def variants(name: str, path: Path) -> dict:
    """label -> source: the kernel at path and its variants."""
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
        out.update({var: f.read_text() for var, f in kern.files.items()})
    return out


def build(name: str, srcs: dict) -> dict:
    """label -> the C entry of its copy, nvcc'd in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, src) in enumerate(srcs.items()):
        cu = OUT / f"{name}_{i}.cu"
        cu.write_text(src)
        procs[label] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-I", str(CSRC), "-Xcompiler", "-fPIC", "-shared", "-o",
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
                    and not torch.equal(got, want)):
                raise SystemExit(f"{name} {v} differs from the plain version "
                                 f"({label})")
            times[v].append(time_ms(lambda fn=entries[v]: run(fn)))
        print(f"{name} probe: {label}, {torch.cuda.get_device_name(0)}",
              flush=True)
        for v, t in times.items():
            print(f"{name} {v}: {' / '.join(f'{x:.4f}' for x in t)} ms",
                  flush=True)


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
