"""
CUDA kernel library: build, load, launch bookkeeping
====================================================

All hand-written kernels live in ``vsc_tpu_torch/csrc/*.cu`` (device
functions shared between sources in ``csrc/*.cuh``) and compile
with ``nvcc`` (one process per source, all started together) into ONE shared
library with a plain C interface, loaded via ``ctypes`` (no PyTorch headers,
so a build takes seconds). The build runs at first use into
``build/vsc_tpu_torch/`` under the repository root, keyed by a hash of the
sources, so a stale library is never loaded.

Every C entry point returns a ``cudaError_t`` (0 = launched); ``check``
turns anything else into a RuntimeError. ``LAUNCHES`` counts launches per
kernel: each wrapper adds one right where it launches its kernel and
nowhere else, so a run can show that its main path went through them.
``ROUTE_LAUNCHES`` counts the split attention kernel's launches by route
(``ops/attention_cuda.split_route``'s names) and the flash attention
kernel's as "flash". ``DEVICE_COUNTERS`` names
the counters a kernel keeps on the card while tracing is on
(``utils/profiling``): ``device_counter`` hands the kernel its int64
counters, ``reset_launches`` drops them with the launch counts and
``utils/profiling.counters`` reads them; ``HOST_COUNTS`` holds the host
counters ``utils/profiling.count`` adds to, dropped with them.
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

__all__ = ["LAUNCHES", "ROUTE_LAUNCHES", "DEVICE_COUNTERS", "reset_launches",
           "device_counter", "library",
           "check", "stream_ptr", "require_cuda", "BUILD_SECONDS",
           "PTXAS_LOG"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vsc_tpu_torch"
PTXAS_LOG = _BUILD_DIR / "ptxas.log"    # nvcc -Xptxas -v of the last build
NVCC_TIMEOUT = 600.0

LAUNCHES = {"blur": 0, "warp": 0, "postprocess": 0, "attention": 0,
            "upsample": 0, "pool": 0, "pyramid": 0, "finish": 0,
            "bilateral": 0, "deconv": 0, "attention_split": 0,
            "attention_flash": 0}
ROUTE_LAUNCHES = {"split": 0, "split_two_pass": 0, "flash": 0}
# group -> the fields of its counters, in the kernel's order. A group's
# counters are COUNTER_SLOTS slots of COUNTER_STRIDE int64 (a 32-byte
# sector a slot) that the kernel's blocks add to in turn, so that their
# atomics do not queue on one address; the reading sums the slots
DEVICE_COUNTERS = {"postprocess": ("fast_tiles", "hole_tiles")}
COUNTER_SLOTS, COUNTER_STRIDE = 256, 4
_COUNTER_TENSORS: dict = {}     # (group, CUDA device index) -> int64 tensor
HOST_COUNTS: dict = {}          # "<group>.<field>" -> count (host counters)
BUILD_SECONDS: list[float] = []   # wall time of the build, once it ran

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures (see the extern "C" functions in csrc/*.cu)
_SIGNATURES = {
    # x, out, taps(host), N, H, W, ksize, gamma, has_gamma, stream
    "vsc_blur": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # depth, image (channel-last), eye_l, eye_r, rows, W, channel stride of
    # the eyes' planes, max_disparity, stream
    "vsc_warp": [_P, _P, _P, _P, _I, _I, _L, _F, _P],
    # depth, image [B, 3, H, W] u8, eye_l, eye_r, B, H, W, channel stride of
    # the eyes' planes, max_disparity, stream
    "vsc_warp_planar_u8": [_P, _P, _P, _P, _I, _I, _I, _L, _F, _P],
    # eye4, smooth_q, out, tables(host), B, H, W, Hq, Wq, rb, counters
    # (device_counter("postprocess", ...), or null), stream
    "vsc_postprocess": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # qkv, out, N, T, heads, scale, stream
    "vsc_qkv_attention": [_P, _P, _I, _I, _I, _F, _P],
    # qkv, out, N, T, heads, scale, stream
    "vsc_flash_attention": [_P, _P, _I, _I, _I, _F, _P],
    # x, out, wa(host), wb(host), N, H, W, f, quantize_u8, stream
    "vsc_upsample": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # eye4 u8, out f32, B, H, W, f, stream
    "vsc_pool_eye4": [_P, _P, _I, _I, _I, _I, _P],
    # planes f32, out f32, N, H, W, stream
    "vsc_pool2": [_P, _P, _I, _I, _I, _P],
    # quarter, out, workspace, N, h, w, workspace floats, stream
    "vsc_pyramid": [_P, _P, _P, _I, _I, _I, _L, _P],
    # N, h, w, out: the workspace floats vsc_pyramid needs
    "vsc_pyramid_workspace": [_I, _I, _I, ctypes.POINTER(_L)],
    # planes u8, out, taps(host), N, H, Wf, crop_w, off0, off1, nsplit,
    # ratio, strength, out_h, out_w, out_u8, stream
    "vsc_finish": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                   _I, _P],
    # eye4, out, quarter (or null), space weights(host), inv2sc, B, H, W,
    # radius, stream
    "vsc_bilateral_pool": [_P, _P, _P, _P, _F, _I, _I, _I, _I, _P],
    # x (channels-last), packed weight, bias (or null), out, N, C, H, W, O,
    # batch stride of x in elements, bf16, stream
    "vsc_deconv2x2": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _P],
    # q, k, v, out, B, T, heads, head dim, strides (batch, token, head) of
    # q/k/v in elements, scale, bf16, two-pass route, stream
    "vsc_split_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _F,
                            _I, _I, _P],
}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0
    _COUNTER_TENSORS.clear()
    HOST_COUNTS.clear()


def device_counter(group: str, device):
    """The address of ``group``'s counters on the CUDA ``device`` while
    tracing is on (made zero on first use), else None: the kernel's null
    pointer, which makes it count nothing."""
    from vsc_tpu_torch.utils.profiling import tracing
    if not tracing():
        return None
    import torch
    key = (group, device.index if device.index is not None
           else torch.cuda.current_device())
    t = _COUNTER_TENSORS.get(key)
    if t is None:
        t = _COUNTER_TENSORS[key] = torch.zeros(
            (COUNTER_SLOTS, COUNTER_STRIDE), dtype=torch.int64,
            device=torch.device("cuda", key[1]))
    return t.data_ptr()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands side by side; raise on the first failure. Returns
    each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errs, failed = [], None
    try:
        for c, proc in zip(cmds, procs):
            _, err = proc.communicate(timeout=NVCC_TIMEOUT)
            errs.append(err)
            if proc.returncode != 0 and failed is None:
                failed = f"{' '.join(c)} failed ({proc.returncode}):\n{err[-8000:]}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError(failed)
    return errs


def _build() -> Path:
    """One nvcc per source, all started together, then one link."""
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256()
    for p in sources + sorted(_CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    tag = h.hexdigest()[:16]
    out = _BUILD_DIR / f"libvsc_kernels_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [_BUILD_DIR / f"{p.stem}_{tag}.{os.getpid()}.o" for p in sources]
    t0 = time.perf_counter()
    logs = _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                      "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                      "-v", "-c", "-o", str(o), str(p)]
                     for p, o in zip(sources, objs)])
    PTXAS_LOG.write_text("".join(logs))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        _run_all([[nvcc, "-shared", "-o", str(tmp)] + [str(o) for o in objs]])
        tmp.replace(out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
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


def require_cuda(name: str, *tensors, contiguous: bool = True) -> None:
    """Kernel wrappers take CPU tensors (plain version) or CUDA tensors
    (the kernel); anything else raises rather than falling back. With
    ``contiguous`` the tensors must also be NCHW-contiguous."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got a tensor "
                             f"on {t.device}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
