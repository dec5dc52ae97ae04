"""Where the time of vsc_tpu_torch/csrc/attention_split.cu goes, on the card.

Builds instrumented copies of the kernel source outside the port's library
(nvcc into build/probe/, one process per copy, all started together) and
runs them at [72, 577, 16, 64], the float32 DepthPro's shape, in f32 and
bf16:

- ``base``: the source as it is;
- ``phases``: thread 0 of every block writes clock64() at the kernel's
  phase boundaries (start, first chunk landed, all QK^T chunks done, p
  formed (f32), all PV chunks done, output written); the script prints the
  mean cycles of each phase per block and the mean gap between one block's
  end and the next block's start on the same SM;
- ``no_copies``: only the first K/V chunk is copied into shared memory, so
  the time left is what the kernel takes without streaming K and V (its
  output is wrong and is not read).

Times are CUDA events over 10 launches (``chip_smoke.time_ms``), beside
SDPA on the same inputs. Run from the repository root on a machine with a
card and nvcc:

    python3 scripts/probe_split_attention_cuda.py
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import time_ms  # noqa: E402

SRC = REPO / "vsc_tpu_torch" / "csrc" / "attention_split.cu"
OUT = REPO / "build" / "probe"
NVCC = "/usr/local/cuda/bin/nvcc"
NB = 16384                      # blocks profiled (the first NB)

PROF = r"""
__device__ long long g_prof[%d * 8];
__device__ __forceinline__ void prof(int i) {
  if (threadIdx.x == 0) {
    const long long b = blockIdx.x + gridDim.x * (blockIdx.y +
                        (long long)gridDim.y * blockIdx.z);
    if (b < %d) {
      g_prof[b * 8 + i] = clock64();
      if (i == 0) {
        unsigned sm;
        asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(sm));
        g_prof[b * 8 + 7] = sm;
      }
    }
  }
}
""" % (NB, NB)
READ = ('\nextern "C" int vsc_prof_read(void* dst) { return (int)'
        'cudaMemcpyFromSymbol(dst, g_prof, sizeof(g_prof)); }\n')
# (pattern, replacement, matches): the phase marks of both kernels
PHASES = [
    (r"namespace \{\n", "namespace {\n" + PROF, 1),
    (r"(  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n)",
     r"\1  prof(0);\n", 2),
    (r"(    const (?:__nv_bfloat16|float)\* buf = ring \+ [^\n]*\n)",
     r"\1    if (s == 0) prof(1);\n", 2),
    (r"(      if \(s == nc\) \{        // the final row max[^\n]*\n)",
     r"\1        prof(2);\n", 1),
    (r"(    if \(s == nc\) \{\n)", r"\1      prof(2);\n", 1),
    (r"(      __syncthreads\(\);      // p of every row before[^\n]*\n)",
     r"\1      prof(3);\n", 1),
    (r"(  __syncthreads\(\);          // every warp is done with the logits)",
     r"  prof(4);\n\1", 1),
    (r"(  const float\* lsum = Qs \+ 4 \* kQ;\n)", r"  prof(4);\n\1", 1),
    (r"(x\.y\), l\)\);\n      \}\n    \}\n  \}\n)", r"\1  prof(5);\n", 1),
    (r"(orow\[e\] = __fdiv_rn\(acc\[i\]\[e\], l\);\n    \}\n  \}\n)",
     r"\1  prof(5);\n", 1),
]
NO_COPIES = [(r"(\n    load_rows_(?:bf16|f32)<DH>\(x < nc)",
              r"\n    if (x == 0) load_rows_DUMMY(x < nc", 2)]


def variant(name: str, edits) -> str:
    s = SRC.read_text()
    for pat, rep, count in edits:
        s, n = re.subn(pat, rep, s)
        if n != count:
            raise SystemExit(f"{name}: {pat!r} matched {n} times, not {count}"
                             " (the kernel source moved on: update PHASES)")
    if name == "no_copies":
        s = s.replace("load_rows_DUMMY(x < nc ? kb",
                      "load_rows_bf16<DH>(x < nc ? kb", 1)
        s = s.replace("load_rows_DUMMY(x < nc ? kb",
                      "load_rows_f32<DH>(x < nc ? kb", 1)
    return s + (READ if name == "phases" else "")


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in (("base", []), ("phases", PHASES),
                        ("no_copies", NO_COPIES)):
        src = OUT / f"split_{name}.cu"
        src.write_text(variant(name, edits))
        procs[name] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-o",
             str(OUT / f"split_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    P, I, Fl, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{err[-3000:]}")
        lib = ctypes.CDLL(str(OUT / f"split_{name}.so"))
        lib.vsc_split_attention.argtypes = [P, P, P, P, I, I, I, I, L, L, L,
                                            Fl, I, P]
        libs[name] = lib
    libs["phases"].vsc_prof_read.argtypes = [P]
    return libs


def phases(lib, fn, nblk: int, f32: bool) -> str:
    fn()
    torch.cuda.synchronize()
    buf = np.zeros(NB * 8, dtype=np.int64)
    assert lib.vsc_prof_read(buf.ctypes.data) == 0
    b = buf.reshape(NB, 8)[:min(nblk, NB)]
    marks = [(0, 1, "start"), (1, 2, "QK^T"), (2, 3, "max and p"),
             (3, 4, "PV"), (4, 5, "output")] if f32 else \
        [(0, 1, "start"), (1, 2, "QK^T"), (2, 4, "max and PV"),
         (4, 5, "output")]
    parts = [f"{what} {np.mean(b[:, j] - b[:, i]):.0f}"
             for i, j, what in marks]
    gaps = []
    for sm in np.unique(b[:, 7]):
        bb = b[b[:, 7] == sm]
        bb = bb[np.argsort(bb[:, 0])]
        gaps.extend(bb[1:, 0] - bb[:-1, 5])
    return (f"cycles per block: {', '.join(parts)}; total "
            f"{np.mean(b[:, 5] - b[:, 0]):.0f}; gap to the SM's next block "
            f"{np.mean(gaps):.0f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("ERROR: no card", file=sys.stderr)
        return 2
    libs = build()
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(1)
    N, T, H, Dh = 72, 577, 16, 64
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn((N, T, 3 * H * Dh), generator=g,
                          device=dev).to(dtype)
        q, k, v = qkv.view(N, T, 3, H, Dh).unbind(2)
        out = torch.empty((N, T, H, Dh), dtype=dtype, device=dev)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=Dh ** -0.5), reps=10)
        res = {}
        for name, lib in libs.items():
            def fn(lib=lib):
                code = lib.vsc_split_attention(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    N, T, H, Dh, *q.stride()[:3], Dh ** -0.5,
                    int(dtype == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
                assert code == 0, code
            res[name] = (time_ms(fn, reps=10), fn)
        print(f"{str(dtype)[6:]} [{N}, {T}, {H}, {Dh}]: base "
              f"{res['base'][0]:.3f} ms, with the phase marks "
              f"{res['phases'][0]:.3f}, without the K/V copies "
              f"{res['no_copies'][0]:.3f}, sdpa {sdpa:.3f}", flush=True)
        print("  " + phases(libs["phases"], res["phases"][1],
                            N * H * ((T + 63) // 64),
                            dtype == torch.float32), flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {clocks.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
