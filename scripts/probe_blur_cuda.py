"""Where the time of vsc_tpu_torch/csrc/blur.cu goes, on the card.

Builds copies of the kernel source outside the port's library (nvcc into
build/probe/, one process per copy, all started together) and times them
at the default path's shape, [2, 3240, 6090] f32, k = 31, sigma 20:

- ``kernel``: the source as it is, with the gamma (0.2) and without it;
  each checked bit for bit against the plain version;
- ``vertical only``: the horizontal pass's taps replaced by a copy, so
  what is left is the vertical pass, the staging and the output (its
  output is wrong and only timed);
- ``horizontal only``: the vertical pass's taps replaced by a copy.

Times are CUDA events over 20 launches after a warm-up, each variant
timed twice in the order a, b, ..., b, a. Run from the repository root on
a machine with a card and nvcc:

    python3 scripts/probe_blur_cuda.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from vsc_tpu_torch.ops.blur_cuda import gaussian_blur_planes_plain  # noqa: E402
from vsc_tpu_torch.ops.filters import gaussian_kernel1d  # noqa: E402

SRC = REPO / "vsc_tpu_torch" / "csrc" / "blur.cu"
OUT = REPO / "build" / "probe"
NVCC = "/usr/local/cuda/bin/nvcc"
H_TAPS = "accumulate<K>(acc[m], i, row[c0 + i], taps);"
V_TAPS = "accumulate<K>(acc, i, __ldg(src + y * W + gx), taps);"


def variants() -> dict:
    src = SRC.read_text()
    for pat in (H_TAPS, V_TAPS):
        if src.count(pat) != 1:
            raise SystemExit(f"{pat!r} not found once in {SRC}: the kernel "
                             "source moved on, update this probe")
    return {"kernel": src,
            "vertical only": src.replace(
                H_TAPS, "if (i < kRunH) acc[m][i] = row[c0 + i];"),
            "horizontal only": src.replace(
                V_TAPS, "if (i < kRunV) acc[i] = __ldg(src + y * W + gx);")}


def build(srcs: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(srcs.items()):
        cu = OUT / f"blur_{i}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for i, (name, proc) in enumerate(procs.items()):
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{err[-3000:]}")
        lib = ctypes.CDLL(str(OUT / f"blur_{i}.so"))
        lib.vsc_blur.argtypes = [P, P, P, I, I, I, I, F, I, P]
        libs[name] = lib
    return libs


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


def main() -> int:
    if not torch.cuda.is_available():
        print("ERROR: no card", file=sys.stderr)
        return 2
    libs = build(variants())
    dev = torch.device("cuda")
    N, H, W, k, sigma, gamma = 2, 3240, 6090, 31, 20.0, 0.2
    x = torch.rand((N, H, W), generator=torch.Generator(dev).manual_seed(0),
                   device=dev)
    taps = np.ascontiguousarray(gaussian_kernel1d(k, sigma), np.float32)
    want = {1: gaussian_blur_planes_plain(x, k, sigma, gamma),
            0: gaussian_blur_planes_plain(x, k, sigma)}
    runs = [(name, g) for name in libs for g in (1, 0)]
    times = {r: [] for r in runs}
    for name, g in runs + runs[::-1]:
        out = torch.empty_like(x)

        def fn(lib=libs[name], out=out, g=g):
            code = lib.vsc_blur(
                x.data_ptr(), out.data_ptr(),
                taps.ctypes.data_as(ctypes.c_void_p), N, H, W, k, gamma, g,
                torch.cuda.current_stream().cuda_stream)
            assert code == 0, code
        fn()
        torch.cuda.synchronize()
        if name == "kernel" and not torch.equal(out, want[g]):
            raise SystemExit(f"the kernel (gamma {g}) differs from the plain "
                             "version")
        times[(name, g)].append(time_ms(fn))
    for (name, g), t in times.items():
        print(f"blur {name}, gamma {'on' if g else 'off'}: "
              f"{' / '.join(f'{v:.4f}' for v in t)} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
