"""
CUDA kernel library: build, load, launch bookkeeping
====================================================

All hand-written kernels live in ``vsc_tpu_torch/csrc/*.cu`` and compile
with ``nvcc`` into ONE shared library with a plain C interface, loaded via
``ctypes`` (no PyTorch headers, so a build takes seconds). The build runs at
first use into ``build/vsc_tpu_torch/`` under the repository root, keyed by
a hash of the sources, so a stale library is never loaded.

Every C entry point returns a ``cudaError_t`` (0 = launched); ``check``
turns anything else into a RuntimeError. ``LAUNCHES`` counts launches per
kernel: each wrapper adds one right where it launches its kernel and
nowhere else, so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["LAUNCHES", "reset_launches", "library", "check", "stream_ptr",
           "require_cuda", "BUILD_SECONDS"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vsc_tpu_torch"
NVCC_TIMEOUT = 600.0

LAUNCHES = {"blur": 0, "warp": 0, "postprocess": 0, "attention": 0}
BUILD_SECONDS: list[float] = []   # wall time of the build, once it ran

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures (see the extern "C" functions in csrc/*.cu)
_SIGNATURES = {
    # x, out, taps(host), N, H, W, ksize, gamma, has_gamma, stream
    "vsc_blur": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # depth, image (channel-last), eye_l, eye_r, rows, W, max_disparity,
    # stream
    "vsc_warp": [_P, _P, _P, _P, _I, _I, _F, _P],
    # eye4, smooth_q, out, chans, v0, v1, k0, k1, keep, tables(host),
    # B, H, W, Hq, Wq, M, rb, stream
    "vsc_postprocess": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _P],
    # qkv, out, N, T, heads, scale, stream
    "vsc_qkv_attention": [_P, _P, _I, _I, _I, _F, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _build() -> Path:
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256()
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = _BUILD_DIR / f"libvsc_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp)]
    cmd += [str(p) for p in sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
    (_BUILD_DIR / "ptxas.log").write_text(proc.stderr)
    tmp.replace(out)
    BUILD_SECONDS.append(time.perf_counter() - t0)
    return out


def library():
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError_t {code})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Kernel wrappers take CPU tensors (plain version) or CUDA tensors
    (the kernel); anything else raises rather than falling back."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got a tensor "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
