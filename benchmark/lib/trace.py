"""
Reduction of a torch.profiler window to device records
======================================================

The traced run profiles a steady stretch of its window (a few steps of
the cell's loop, after a warm-up step the profiler itself needs). This
module turns the profiler's events into plain records that the per-layer
readers (``metrics/*.py``) take:

  device   [(start_us, end_us, name)] of every kernel, copy and memset
           on the card, clipped to the traced window
  host     [(start_us, end_us, name)] of the host's events (ATen ops,
           CUDA runtime calls), for naming idle gaps
  window   (start_us, end_us): the first traced step's start to the last
           one's end, on the host's clock as the profiler keeps it

and computes the busy time (the union of the device intervals), the
device time by kernel group and the longest idle gaps by what the host
was doing meanwhile.
"""

from __future__ import annotations

import re

__all__ = ["STEP", "GROUPS", "SBS_KERNEL_GROUPS", "group_of",
           "reduce_profile", "busy_us", "by_group", "idle_gaps",
           "kernel_time_us"]

STEP = "benchmark.step"

# kernel-name patterns -> readable group, first match wins
GROUPS = [
    ("qkv attention kernel", r"qkv_attention_kernel"),
    ("split attention kernel", r"split_attention_(bf16|f32)_kernel"),
    ("deconv kernel", r"deconv2x2_(bf16|f32)_kernel"),
    ("SBS blur kernel", r"\bblur_kernel"),
    ("SBS warp kernel", r"\bwarp_kernel"),
    ("SBS postprocess kernel", r"postprocess_tile_kernel"),
    ("SBS bilateral kernel", r"bilateral_tile_kernel"),
    ("SBS upsample kernel", r"\bupsample_kernel"),
    ("SBS pool kernels", r"\bpool(_eye4|2)_kernel"),
    ("SBS pyramid kernels", r"pyramid_(down|top|up)_kernel"),
    ("SBS finish kernel", r"sharpen_downscale_kernel"),
    ("convolutions (cuDNN)", r"fprop|dgrad|wgrad|cudnn|conv|nchwToNhwc"),
    ("GEMMs (cuBLAS)", r"nvjet|gemm|cutlass|xmma"),
    ("copy host to device", r"^Memcpy HtoD"),
    ("copy device to host", r"^Memcpy DtoH"),
    ("copies on the device and memsets",
     r"^Memcpy|^Memset|copy_kernel|CatArray"),
    ("index and gather kernels (ATen)", r"index|gather|scatter"),
    ("reductions (ATen)", r"reduce_kernel|Reduce"),
    ("elementwise kernels (ATen)", r"elementwise|vectorized|unrolled"),
    ("normalization and softmax (ATen)", r"norm|softmax|Norm|Softmax"),
]
_COMPILED = [(name, re.compile(pat)) for name, pat in GROUPS]

SBS_KERNEL_GROUPS = tuple(name for name, _ in GROUPS
                          if name.startswith("SBS "))


def group_of(name: str) -> str:
    for g, pat in _COMPILED:
        if pat.search(name):
            return g
    return "other device work"


def reduce_profile(prof, annotations=(STEP,)) -> dict:
    """The profiler's events -> {"device", "host", "window", "steps"}.
    ``steps`` counts the traced steps (host events named STEP)."""
    from torch.autograd import DeviceType
    events = prof.events()
    steps = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == STEP and e.device_type == DeviceType.CPU)
    if not steps:
        return {"device": [], "host": [], "window": None, "steps": 0}
    w0, w1 = steps[0][0], steps[-1][1]
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if b <= w0 or a >= w1:
            continue
        if e.device_type == DeviceType.CUDA:
            if e.name in annotations:
                continue        # record_function shows up on the device too
            dev.append((max(a, w0), min(b, w1), e.name))
        elif e.name not in annotations:
            host.append((a, b, e.name))
    dev.sort()
    return {"device": dev, "host": host, "window": (w0, w1),
            "steps": len(steps)}


def busy_us(device) -> float:
    """The union of the device intervals."""
    busy, end = 0.0, float("-inf")
    for a, b, _ in sorted(device):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def by_group(device) -> dict:
    """Device microseconds by kernel group (overlaps counted per kernel)."""
    out: dict[str, float] = {}
    for a, b, name in device:
        g = group_of(name)
        out[g] = out.get(g, 0.0) + max(b - a, 0.0)
    return out


def kernel_time_us(device, pattern: str) -> tuple[float, int]:
    """(device microseconds, launches) of the kernels whose name matches."""
    pat = re.compile(pattern)
    t, n = 0.0, 0
    for a, b, name in device:
        if pat.search(name):
            t += max(b - a, 0.0)
            n += 1
    return t, n


def idle_gaps(device, host, window, top: int = 10, named: int = 400) -> list:
    """The device's idle gaps inside ``window``, summed by the host event
    that covered each gap's middle (the innermost one), largest sum first:
    [(name, us)]. The ``named`` longest gaps are named; the rest are summed
    as "short gaps"."""
    import bisect
    w0, w1 = window
    gaps, end = [], w0
    for a, b, _ in sorted(device):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted(host)
    starts = [h[0] for h in host]
    sums: dict[str, float] = {}
    for i, (a, b) in enumerate(gaps):
        if i >= named:
            sums["short gaps"] = sums.get("short gaps", 0.0) + (b - a)
            continue
        mid = 0.5 * (a + b)
        best = None
        j = bisect.bisect_right(starts, mid)
        for ha, hb, name in reversed(host[max(0, j - 4000):j]):
            if hb >= mid and (best is None or hb - ha < best[1] - best[0]):
                best = (ha, hb, name)
        name = best[2] if best else "no host event"
        sums[name] = sums.get(name, 0.0) + (b - a)
    return sorted(sums.items(), key=lambda kv: -kv[1])[:top]
