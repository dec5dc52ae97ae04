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
     shapes; the pyramid also on a 2-row quarter of the same ladder depth,
     its latency floor), under its bound, with both times, the time of one
     PyTorch call that computes the same function where there is one (SDPA,
     conv_transpose2d) and the least time the card could take (bytes at
     3.35 TB/s or operations at the peak for their type, whichever is
     larger; the postprocess's operations include the fill and polish its
     pair's holes need, and the share of its tiles that take the hole path
     must lie strictly between 0 and 1, so both paths are checked); the
     attention past the qkv kernel's 640 tokens (DepthPro's 1025 at input
     2048, and 4097), bf16 on the flash kernel and float32 on the split
     kernel's two-pass route; the flash kernel at Depth Anything V2's
     shape ([8, 2443, 3072], a 1080p batch of 8) against its plain version
     in its own order and the full-row one, with the two-pass route's and
     SDPA's flash backend's times; then the
     super_sampling 3 kernels again at 2160 x 3840 and the SBS stage at
     that size;
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
     last one 1-frame batch of DepthPro at input 2048 (every attention on
     the flash kernel), counters reset around it;
  4. the CLI: ``stream_convert.run`` on a short synthetic clip, when the
     media engine and tqdm are present;
  5. the step workflow at 1080p through the step CLIs' ``main(argv)``, as a
     user runs it: ``workflow_init`` on a placeholder input, 12 frames
     written as PNGs (``frame_extractor`` only where the media engine
     starts), ``depth_map_generator`` (full-width DepthPro from seed 0,
     bf16, batch 8: one full and one padded batch; its PNGs equal
     ``build_depth_fn`` on the same batches bit for bit; a second run
     launches nothing), ``sbs_generator`` at the defaults (batch 4; its PNGs
     equal ``generate_sbs`` on the frames and the depth read back, bit for
     bit; every default-path SBS kernel launched), a 16-bit pass (uint16
     TIFF depth; a crop checked against the CPU plain path), and
     ``sbs_tester --grid``; each step's frames/s after a warm-up run on
     other frames, the device's busy share over each step (torch.profiler),
     and the SBS step with and without its per-dispatch health probe;
  6. the orchestrator: ``runtime/orchestrator``'s ``Orchestrator.run()`` at
     its defaults, as a user runs it, drives the step CLIs as child
     processes on the card over two 24-frame 1080p clips, with the seeded
     full-width DepthPro written as the npz weight cache the children load:
     every child exits 0, workflows.yaml reads DONE as JAX's would, video
     2's depth and SBS PNGs equal ``build_depth_fn`` and ``generate_sbs``
     bit for bit, each chunk decodes to its frames at 3840 x 1080, each
     depth child's torch.profiler trace shows the qkv attention kernel and
     each SBS child's the seven default SBS kernels; the run's frames/s,
     each child's start and exit, the gap from an exit to the next launch.
     Where vscmedia does not start (no libav), concat is not run, and the
     run stops once every chunk is written;
  7. ``parallel/`` on the one card, every mesh naming cuda:0 twice: (a) a
     (2 data x 1) mesh, full-width DepthPro through ``build_depth_fn`` and
     ``generate_sbs`` at the defaults on a 1080p batch of 2 placed by
     ``shard_batch``: each shard's depth equals the unsharded depth_fn on
     its frame (batch 1) and the SBS equals the unsharded batch's, bit for
     bit, with 48 qkv launches a shard and each SBS kernel launched twice
     its count in one unsharded call; (b) a (1 x 2) mesh, DepthPro tensor-
     and sequence-parallel (``seq_shard``): 96 qkv launches a 2-frame batch
     at 8 heads on [70 | 2, 577, 1536], the u8 depth within the
     float32-vs-bf16 difference of the same frames; (c) the dry run
     (``parallel/dryrun``) in-process and as two processes over gloo; (d)
     the time of (a) and (b) a batch beside the unsharded time, and the
     memory each holds: the cost of sharding on one card, not a speed-up;
  8. the 4K main path, 2160 x 3840 at ``StereoParams()`` and the CLIs'
     default batches (W' = 11847 is odd, so the pools run in torch glue and
     the split route is refused, as in the JAX package): (a) each kernel of
     the path against its plain version at batch 4, whose [4, 8, 6480,
     11847] pair holds more than 2^31 elements, with times and bounds; (b)
     ``generate_sbs`` on a batch of 4 equal, bit for bit, to its frames run
     one at a time; (c) the card against the CPU plain path on a strip of
     4K width (the plain path on a whole frame takes minutes on the host,
     projected from the strip's time); (d) ``render_sbs`` with full-width
     DepthPro on batches of 4: depth and SBS ms/frame, fps, launches a
     batch by kernel, peak memory above the weights, one torch.profiler
     pass; (e) the depth and SBS step CLIs' ``main(argv)`` at their default
     batches (8 and 4) on 8 4K PNGs, their PNGs bit-equal to
     ``build_depth_fn`` and ``generate_sbs``, frames/s and busy share, and
     a 16-bit pass (``frame_extractor`` on a 4K clip only where the media
     engine starts);
  9. the FOV head: the JAX package's default DepthPro (``DepthProConfig()``,
     a third ViT-L on the quarter-size image, ``fov_deg`` and the metric
     ``inverse_depth``) at full width on 1080p batches of 2 through
     ``build_depth_fn``'s resize and ``preprocess_frames``: (a) bf16,
     ``fov_deg`` finite, the canonical depth equal to the head-off model's
     on the same weights, ``fov_deg`` and ``inverse_depth`` on the kernels
     against the plain attention within the plain path's own
     bf16-vs-float32 difference, 72 qkv launches a batch (48 without the
     head; counters and torch.profiler), depth ms/frame with and without
     the head, weights and peak memory; (b) float32, 72 split-kernel
     launches, ``fov_deg`` within 1e-3 degrees of the plain path; (c) TP 2
     + ``seq_shard`` with the head on a (1 x 2) mesh naming cuda:0 twice,
     ``fov_deg`` and the u8 depth within the unsharded bf16-vs-float32
     difference;
 10. the bench: (a) each kernel of its path against its plain version at
     its batch-8 shapes (the SBS pair [4, 16, 3240, 6090], the qkv
     attention [288, 577, 3072]), and its SBS bound
     (``utils/flops.sbs_least_time``) equal to those kernels' bounds on the
     real tensors (the postprocess's at most: it leaves out the hole
     work); (b) as a user runs it: ``python -m vsc_tpu_torch.bench`` as a
     child process at its defaults (full-width DepthPro in bf16, batch 8,
     8 iterations, the SSIM gate and the extras on), its last line parsed
     and checked: ``quality_gate`` PASS with every ``ssim_*`` >= 0.99, no
     ``ssim_error`` or ``extras_error``, ``value`` > 0, ``depth_mfu_pct``
     and ``sbs_roofline_attained_pct`` in (0, 100], the two media readings
     skipped exactly where vscmedia does not start, and the launches of
     the bench's timed iterations (its stderr; counts reset after its
     warm-up): each default-path SBS kernel every iteration, the qkv
     attention 48 times an iteration, no opt-in route's kernel; then once
     more at ``BENCH_DEPTH=stub BENCH_EXTRAS=0``, the SBS reading on its
     own (no attention launch). The oracle frames (CPU) are computed by
     the first run and read from the shared disk cache by the second;
     their times are logged;
 11. Depth Anything V2 Large (seed 0, bf16) on the convert path as the
     streaming CLI runs it: ``build_depth_fn("depth-anything-v2")`` on the
     one-card data mesh, 1080p batches of 8 through ``shard_batch``,
     ``render_sbs`` and ``gather``; counters reset just before a batch: 24
     flash launches (one a ViT block), no qkv or split-kernel launch, every
     default SBS kernel; on a (1 x 1) data mesh the u8 depth equal to
     the CLI path's; depth and SBS ms a frame, a batch end to end on the
     main thread, on the CLI's dispatch thread and on a fresh thread each,
     all again with cuDNN off, peak memory, one torch.profiler pass.

Prints one JSON line of per-kernel results, the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``. Exits nonzero without printing a result
when there is no CUDA device or the port's sources are missing.

    python3 chip_smoke.py                   # all phases, as the check runs it
    python3 chip_smoke.py --phases 1,2      # build + kernel checks only
    python3 chip_smoke.py --phases 1,5      # build + the step workflow
    python3 chip_smoke.py --phases 1,6      # build + the orchestrator
    python3 chip_smoke.py --phases 1,7      # build + parallel/
    python3 chip_smoke.py --phases 1,8      # build + the 4K main path
    python3 chip_smoke.py --phases 1,9      # build + the FOV head
    python3 chip_smoke.py --phases 1,10     # build + the bench
    python3 chip_smoke.py --phases 1,11     # build + Depth Anything V2
"""

from __future__ import annotations

import argparse
import contextlib
import io
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
DAV2_BATCH = 8   # phase 11 (and the flash check): the CLIs' batch
DAV2_TOKENS = 2443   # Depth Anything V2 at 1080p: 37 x 66 patches + 1
DAV2_BATCHES = 6     # phase 11: timed batches after one warm-up

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
    # no Pallas site of its own: the JAX package runs every token count on
    # qkv_short_seq_attention, whose route past 640 tokens this kernel takes
    ("attention_flash", "cuda", "vsc_tpu_torch/csrc/attention_flash.cu",
     "vsc_tpu/ops/attention_pallas.py:111"),
]

def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def postprocess_ops(eye4, smoothing: float) -> float:
    """The postprocess's f32 operations on these inputs: the bilateral on
    every pixel, and on the hole pixels (in-image pixels within 1 of a
    pixel that is not valid) what the fill needs: each sweep on the hole
    pixels still unknown at its start (~8 operations per tap of the radius-2
    disc, ~6 for the update), the polish on every hole pixel (2 per tap and
    channel, one division)."""
    import torch
    import torch.nn.functional as F
    from vsc_tpu_torch.ops.inpaint import disc_offsets
    from vsc_tpu_torch.utils.flops import bilateral_ops
    from vsc_tpu_torch.ops.postprocess_cuda import (FILL_RADIUS,
                                                    POLISH_RADIUS, SWEEPS)
    fill, polish = disc_offsets(FILL_RADIUS), disc_offsets(POLISH_RADIUS)
    hole = F.max_pool2d((eye4[3] == 0).float()[:, None], 3, stride=1,
                        padding=1)
    known = 1.0 - hole
    r = FILL_RADIUS
    kernel = torch.zeros((1, 1, 2 * r + 1, 2 * r + 1), device=eye4.device)
    for dy, dx, _ in fill:
        kernel[0, 0, r + dy, r + dx] = 1.0
    swept = 0.0
    for _ in range(SWEEPS):
        swept += float((known == 0).sum())
        known = torch.maximum(known, (F.conv2d(known, kernel, padding=r)
                                      > 0).float())
    return (bilateral_ops(smoothing, eye4[0].numel())
            + swept * (8.0 * len(fill) + 6.0)
            + float(hole.sum()) * 3 * (2.0 * len(polish) + 1.0))


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what) -> None:
    """A failed check fails the run (kept under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps launches (CUDA events, after one
    warm-up call; 20 launches, so the host's time to reach the first one
    adds little to a kernel of a tenth of a millisecond)."""
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
    ("split attention kernel", r"split_attention_(bf16|f32)_kernel"),
    ("deconv kernel", r"deconv2x2_(bf16|f32)_kernel"),
    ("SBS kernels (blur, warp, postprocess, bilateral)",
     r"::(blur|warp|postprocess_tile|bilateral_tile)_kernel[<(]"),
    ("super-sampling kernels (upsample, pool, pyramid, finish)",
     r"::(upsample|pool_eye4|pool2|pyramid_(down|top|up)|sharpen_downscale)"
     r"_kernel[<(]"),
    ("convolutions (cuDNN)", CONV_GROUP),
    ("GEMMs (cuBLAS)", r"nvjet|gemm|cutlass"),
    ("copies and memsets", r"^Memcpy|^Memset|copy_kernel|CatArray"),
    ("other ATen kernels (elementwise, LayerNorm, GELU, gathers)",
     r"at::native"),
]


def profile_device(fn, window: str = "chip_smoke_window"):
    """Device time of one call of fn() from torch.profiler's device events
    only (kernels, copies, memsets; the aten:: rows that launch them are
    host events and are left out). Busy = the union of their intervals
    inside the host window around fn() and its synchronize (or inside the
    first host event named ``window`` that fn() records); idle = the rest
    of that window."""
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
    win = next(e for e in events if e.name == window
               and e.device_type == DeviceType.CPU)
    w0, w1 = win.time_range.start, win.time_range.end
    # the windows also show up as device-side annotations: not kernels
    dev = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1),
                  e.name) for e in events
                 if e.device_type == DeviceType.CUDA
                 and e.name not in ("chip_smoke_window", window))
    busy, end = 0.0, w0
    for a, b, _ in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    per_kernel, per_kernel_n = {}, {}
    for a, b, name in dev:
        g = next((gn for gn, pat in GROUPS if re.search(pat, name)), "other")
        groups[g] += max(b - a, 0.0) / 1e3
        per_kernel[name] = per_kernel.get(name, 0.0) + max(b - a, 0.0) / 1e3
        per_kernel_n[name] = per_kernel_n.get(name, 0) + 1
    return dict(window_ms=(w1 - w0) / 1e3, busy_ms=busy / 1e3,
                events=len(dev), groups=groups, per_kernel=per_kernel,
                per_kernel_n=per_kernel_n)


def device_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over reps calls: the sum of its device
    events (kernels, copies, memsets) under torch.profiler, after one
    warm-up call. Unlike time_ms it leaves out the host's launch cost,
    which sets time_ms for kernels shorter than ~0.1 ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    prof = profile_device(lambda: [fn() for _ in range(reps)])
    return sum(prof["per_kernel"].values()) / reps


def log_profile(what: str, fn, group: str | None = None,
                phase: int = 3) -> dict:
    """Device time of one call of fn() by kernel group, the top kernels,
    and with ``group`` (a GROUPS pattern) the top kernels of that group.
    Returns the device time by group (ms)."""
    import re
    prof = profile_device(fn)
    per_kernel = sorted(prof["per_kernel"].items(), key=lambda kv: -kv[1])
    tot = sum(prof["groups"].values())
    log(f"phase {phase}: profile of {what}: window "
        f"{prof['window_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms "
        f"({100 * prof['busy_ms'] / prof['window_ms']:.1f} %, idle "
        f"{100 - 100 * prof['busy_ms'] / prof['window_ms']:.1f} %), "
        f"{prof['events']} device events")
    log(f"phase {phase}: device time by group: " + "; ".join(
        f"{g} {t:.2f} ms ({100 * t / tot:.1f} %)"
        for g, t in sorted(prof["groups"].items(), key=lambda kv: -kv[1])
        if t > 0))
    log(f"phase {phase}: top kernels: " + "; ".join(
        f"{t:.2f} ms {n[:70]}" for n, t in per_kernel[:8]))
    if group is not None:
        log(f"phase {phase}: top kernels matching {group!r}: " + "; ".join(
            f"{t:.2f} ms {n[:70]}"
            for n, t in [kv for kv in per_kernel
                         if re.search(group, kv[0])][:6]))
    return prof["groups"]


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
    log_ptxas(_cuda.PTXAS_LOG)
    return card


def kernel_name(mangled: str) -> str:
    """The last identifier of a mangled nested name (_ZN<len><id>...)."""
    pos, name = mangled.find("_ZN") + 3, mangled
    while pos > 2 and pos < len(mangled) and mangled[pos].isdigit():
        end = pos
        while mangled[end].isdigit():
            end += 1
        name = mangled[end:end + int(mangled[pos:end])]
        pos = end + int(mangled[pos:end])
    return name


def log_ptxas(path: Path) -> None:
    """Registers and spill stores of each kernel (all its template
    instances) from the build's nvcc -Xptxas -v output."""
    import re
    if not path.exists():
        log("phase 1: no ptxas log (library built by an earlier run)")
        return
    regs, spills, name = {}, {}, None
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            spills[name] = max(spills.get(name, 0), int(m.group(1)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            regs.setdefault(name, []).append(int(m.group(1)))
    log("phase 1: ptxas (sm_90a): " + "; ".join(
        f"{k} {min(v)}{'' if min(v) == max(v) else f'-{max(v)}'} registers, "
        f"{spills.get(k, 0)} B spill" for k, v in sorted(regs.items())))


def attention_check(N: int, g) -> dict:
    """The qkv attention kernel against its plain version and SDPA on a
    random qkv [N, 577, 3072] bf16 at 16 heads (DepthPro's ViT blocks: N is
    36 a frame, 35 tiles and the image)."""
    import torch
    from vsc_tpu_torch.utils.flops import least_time
    from vsc_tpu_torch.ops.attention_cuda import (qkv_attention,
                                                  qkv_attention_plain)
    qkv = torch.randn((N, 577, 3072), generator=g, device=g.device).to(
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
    check(err <= 8e-3 and mean_err <= 1e-5,
          f"attention disagrees: max {err}, mean {mean_err}")
    return dict(
        max_abs_err=err, mean_abs_err=mean_err,
        bound="max 8e-3, mean 1e-5: bf16 output (~0.07 in size) and "
              "bf16-rounded p that can flip with the f32 summation order",
        ms=time_ms(lambda: qkv_attention(qkv, 16, scale)),
        plain_ms=time_ms(lambda: qkv_attention_plain(qkv, 16, scale),
                         reps=2),
        library_ms=time_ms(sdpa),
        # qkv in, [N, T, D] out; two products on the tensor cores, ~5 f32
        # operations per logit
        **least_time(nbytes(qkv) + nbytes(qkv) // 3,
                     bf16_tensor=4.0 * 577 * 577 * 64 * N * 16,
                     f32=5.0 * 577 * 577 * N * 16))


def phase_kernels(B: int):
    """Each kernel vs its plain version at the slice's shapes."""
    import torch
    from vsc_tpu_torch.ops import stereo
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
    res["attention"] = attention_check(36 * B, g)
    for name, r in res.items():
        log(f"phase 2: {name}: max_abs_err {r['max_abs_err']:.3g} "
            f"[{r['bound']}], kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms"
            + (f", sdpa {r['library_ms']:.3f} ms" if "library_ms" in r
               else ""))
    return res


# eye pixels the plain postprocess takes at once in phase_ss_kernels: the
# 1080p pair's four eye-frames (3240 x 6090 each)
PLAIN_PP_PIXELS = 4 * 3240 * 6090


def phase_ss_kernels(B: int, H: int = 1080, W: int = 1920, phase: int = 2):
    """Every SBS kernel of the super_sampling 3 branch (upsample, blur,
    planar-u8 warp, pools, pyramid, postprocess on the pair, finish, and
    the split route's bilateral where its guard takes the pair) vs its
    plain version, at the shapes of B frames of H x W (1080p at batch 2 and
    2160 x 3840 at batch 1 in phase 2, at batch 4 in phase 8), fed by the
    chain it sits in (each stage's kernel output is the next stage's
    input)."""
    import torch
    from vsc_tpu_torch.utils.flops import (bilateral_ops, issue_floor,
                                           least_time)
    import torch.nn.functional as F
    from vsc_tpu_torch.ops import stereo
    from vsc_tpu_torch.ops.bilateral_cuda import (bilateral_pool_planar,
                                                  bilateral_pool_plain,
                                                  bilateral_pool_supported)
    from vsc_tpu_torch.ops.blur_cuda import (gaussian_blur_planes,
                                             gaussian_blur_planes_plain)
    from vsc_tpu_torch.ops.finish_cuda import (sharpen_downscale_planar,
                                               sharpen_downscale_plain)
    from vsc_tpu_torch.ops.inpaint import _edge_even
    from vsc_tpu_torch.ops.pool_cuda import (avgpool2, avgpool2_eye4,
                                             avgpool2_plain,
                                             avgpool_eye4_plain)
    from vsc_tpu_torch.ops.postprocess_cuda import (TILE_H, TILE_W,
                                                    hole_tiles,
                                                    postprocess_eye,
                                                    postprocess_eye_plain)
    from vsc_tpu_torch.ops.pyramid_cuda import (pyramid_fill_below,
                                                pyramid_fill_below_plain)
    from vsc_tpu_torch.ops.resize import resize
    from vsc_tpu_torch.ops.upsample_cuda import (upsample_bilinear_int,
                                                 upsample_bilinear_int_plain)
    from vsc_tpu_torch.ops.warp_cuda import (forward_warp_eyes_planar_plain,
                                             forward_warp_pair_planar)
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
                  **least_time(nbytes(depth, up_d), f32=6.0 * up_d.numel()),
                  **issue_floor(6.0 * up_d.numel()))
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
                             f32=(4.0 * k + 4.0) * dn.numel()),
                **issue_floor((4.0 * k + 4.0) * dn.numel()))
    check(err <= 1e-4, f"blur disagrees: {err}")
    # the warp writes both eyes into the pair in place (the main path's
    # entry), held against the plain version's eyes side by side
    img_cf = up.reshape(B, 3, UH, UW)
    pair = forward_warp_pair_planar(img_cf, dn, p.max_disparity)
    want = torch.cat(forward_warp_eyes_planar_plain(img_cf, dn,
                                                    p.max_disparity), dim=1)
    err = exact("warp_planar_u8", pair, want,
                holes=float(1 - pair[3, B:].float().mean()),
                ms=time_ms(lambda: forward_warp_pair_planar(
                    img_cf, dn, p.max_disparity)),
                plain_ms=time_ms(lambda: forward_warp_eyes_planar_plain(
                    img_cf, dn, p.max_disparity), reps=2),
                # the scatter: ~10 operations to place a source's two
                # candidates and ~10 to read an output's winner back, per
                # eye (the gather it replaced: ~8 per candidate shift,
                # floor(max_disparity) + 3 shifts per pixel and eye)
                **least_time(nbytes(img_cf, dn, pair), f32=40.0 * dn.numel()))
    check(err == 0, f"planar-u8 warp disagrees: {err}")
    del want

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

    # the pyramid: the whole ladder from the quarter, as the path hands it
    # over; its latency floor is the same kernel on a 2-row quarter (the
    # same 11 levels at 1080p, 0.25 % of the bytes)
    q = q.contiguous()
    q_thin = q[..., :2, :].contiguous()
    filled = pyramid_fill_below(q)
    err = exact("pyramid", filled, pyramid_fill_below_plain(q),
                bound="exact (bit-identical levels)",
                ms=time_ms(lambda: pyramid_fill_below(q)),
                plain_ms=time_ms(lambda: pyramid_fill_below_plain(q), reps=2),
                latency_floor_ms=time_ms(lambda: pyramid_fill_below(q_thin)),
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
        bl_ops = bilateral_ops(sm, pair[0].numel()) + 16.0 * quarter.numel()
        del d, filt_p, quarter_p
        res["bilateral"] = dict(
            max_abs_err=max(err, e_rest), frac_differing=frac,
            bound="filtered <= 1 code on < 0.1% of pixels, valid plane and "
                  "quarter exact",
            ms=time_ms(lambda: bilateral_pool_planar(pair, sm)),
            plain_ms=time_ms(lambda: bilateral_pool_plain(pair, sm), reps=2),
            # (~4 operations per masked value of the quarter sums)
            **least_time(nbytes(pair, filt, quarter), f32=bl_ops),
            **issue_floor(bl_ops))
        check(err <= 1 and frac < 1e-3 and e_rest == 0,
              f"bilateral disagrees: {err} {frac} {e_rest}")
        del filt, quarter
    else:
        log(f"phase {phase}: bilateral not checked at {H}x{W}: the split "
            f"route's guard refuses the {UH} x {UW} pair (JAX's guard too)")

    # finish on the postprocessed pair, each eye at its own offset
    smooth_q = stereo._pyramid_fill_planar_coarse(pair)
    pp_args = (pair, smooth_q, p.artifact_smoothing)
    out = postprocess_eye(*pp_args)
    # the plain version on at most PLAIN_PP_PIXELS eye pixels at a time (it
    # works frame by frame and holds several f32 copies of what it is
    # given: the whole 4K pair of 4 does not fit on the card beside them)
    step = max(1, PLAIN_PP_PIXELS // (UH * UW))
    chunks = [slice(i, i + step) for i in range(0, 2 * B, step)]

    def pp_plain(c):
        return postprocess_eye_plain(pair[:, c], smooth_q[:, c], sm)
    err, n_diff = 0.0, 0
    for c in chunks:
        d = (out[:, c].int() - pp_plain(c).int()).abs()
        err, n_diff = max(err, float(d.max())), n_diff + int((d > 0).sum())
    frac = n_diff / out.numel()
    del d
    share = float(hole_tiles(pair[3]).float().mean())
    res["postprocess"] = dict(
        max_abs_err=err, frac_differing=frac, hole_tile_share=share,
        bound="<= 1 code on < 0.1% of pixels",
        ms=time_ms(lambda: postprocess_eye(*pp_args)),
        plain_ms=time_ms(lambda: [pp_plain(c) for c in chunks], reps=2),
        # the bilateral on every pixel, the fill and polish on the holes
        **least_time(nbytes(pair, smooth_q, out),
                     f32=postprocess_ops(pair, sm)))
    log(f"phase {phase}: postprocess ({H}x{W}, super_sampling 3): "
        f"{100 * share:.1f} % of its {TILE_H} x {TILE_W} tiles take the hole "
        f"path, {100 * float((pair[3] == 0).float().mean()):.2f} % of "
        f"pixels are holes")
    check(0.0 < share < 1.0, f"the pair's tiles do not take both paths: "
                             f"hole-tile share {share}")
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
                             f32=26.0 * out[..., :crop_w].numel()),
                **issue_floor(26.0 * out[..., :crop_w].numel()))
    check(err == 0, f"finish disagrees: {err}")
    log(f"phase {phase}: {H}x{W} super_sampling 3 shapes: upsample "
        f"{tuple(x_cf.shape)} and {tuple(depth.shape)} x{f}, pair "
        f"{tuple(out.shape[1:])}, pyramid {tuple(q.shape)}, finish crop "
        f"{crop_w} at ({lo}, {ro})")
    for name, r in res.items():
        log(f"phase {phase}: {name} ({H}x{W}, super_sampling 3): max_abs_err "
            f"{r['max_abs_err']:.3g}"
            + (f" on {r['frac_differing']:.2g} of pixels"
               if "frac_differing" in r else "")
            + f" [{r['bound']}], kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']})"
            + (f", no-FMA issue floor {r['issue_floor_ms']:.3f} ms"
               if "issue_floor_ms" in r else "")
            + (f", latency floor {r['latency_floor_ms']:.3f} ms (the same "
               f"kernel on a {tuple(q_thin.shape)} quarter)"
               if "latency_floor_ms" in r else "")
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
    """The deconv kernel at every DepthPro site shape (bf16, batch B, the
    channels-last input the model hands it; its output in the memory
    format conv_transpose2d returns) and once in f32, and the split-q/k/v
    attention at [36B, 577, 16, 64] in f32 (the float32 DepthPro's shape)
    and bf16, and at head dims 16 and 128, each against its plain version,
    with the library call's time."""
    import torch
    from vsc_tpu_torch.utils.flops import least_time
    import torch.nn.functional as F
    from vsc_tpu_torch.ops.attention_cuda import (short_seq_attention,
                                                  short_seq_attention_plain)
    from vsc_tpu_torch.ops.deconv_cuda import (deconv2x2, deconv2x2_plain,
                                               pack_weight)
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(21)
    res = {}

    def deconv_site(S, C, O, has_bias, dtype):
        # channels-last, as the port's DepthPro hands every site its input;
        # upsample_lowres reads the image encoder's tokens less the cls
        # token (its images one token apart)
        if (S, C, O, has_bias) == (24, 1024, 1024, True):
            x = torch.randn((B, 1 + S * S, C), generator=g, device=dev).to(
                dtype)[:, 1:].reshape(B, S, S, C).permute(0, 3, 1, 2)
        else:
            x = torch.randn((B, S, S, C), generator=g, device=dev).to(
                dtype).permute(0, 3, 1, 2)
        w = (torch.randn((C, O, 2, 2), generator=g, device=dev)
             / (4 * C) ** 0.5).to(dtype)
        b = (0.1 * torch.randn((O,), generator=g, device=dev)).to(
            dtype) if has_bias else None
        packed = pack_weight(w)      # ConvT2x2 keeps it between calls
        out = deconv2x2(x, w, b, packed=packed)
        lib = F.conv_transpose2d(x, w, b, stride=2)
        fmt = [t.is_contiguous(memory_format=torch.channels_last)
               and not t.is_contiguous() for t in (out, lib)]
        check(all(fmt), f"deconv {S} {C}->{O} {dtype}: channels-last of "
                        f"the kernel's and conv_transpose2d's output: {fmt}")
        got, want = out.float(), deconv2x2_plain(x, w, b).float()
        del out, lib
        atol, rtol = DECONV_BF16_TOL if dtype == torch.bfloat16 else \
            DECONV_F32_TOL
        excess = float(((got - want).abs() - atol - rtol * want.abs()).max())
        ops = 2.0 * B * S * S * C * 4 * O
        # device time: at most sites one call is shorter than its launch
        kern = lambda: deconv2x2(x, w, b, packed=packed)      # noqa: E731
        cudnn = lambda: F.conv_transpose2d(x, w, b, stride=2)  # noqa: E731
        r = dict(max_abs_err=float((got - want).abs().max()),
                 within=excess <= 0,
                 ms=device_ms(kern), wall_ms=time_ms(kern),
                 plain_ms=time_ms(lambda: deconv2x2_plain(x, w, b), reps=2),
                 library_ms=device_ms(cudnn), library_wall_ms=time_ms(cudnn),
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
            f"{DECONV_BF16_TOL[1]}], kernel {r['ms']:.3f} ms (wall "
            f"{r['wall_ms']:.3f}), plain {r['plain_ms']:.3f} ms, "
            f"conv_transpose2d {r['library_ms']:.3f} ms (wall "
            f"{r['library_wall_ms']:.3f}), bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']})")
    r32 = deconv_site(96, 512, 512, False, torch.float32)
    log(f"phase 2: deconv 96^2 512->512 f32: max_abs_err "
        f"{r32['max_abs_err']:.3g} [atol {DECONV_F32_TOL[0]} + rtol "
        f"{DECONV_F32_TOL[1]}], kernel {r32['ms']:.3f} ms, plain "
        f"{r32['plain_ms']:.3f} ms, conv_transpose2d {r32['library_ms']:.3f} "
        f"ms, bound {r32['bound_ms']:.3f} ms ({r32['bound_by']})")
    # the row: every site of one batch, weighted by its count
    keys = ("ms", "wall_ms", "plain_ms", "library_ms", "library_wall_ms",
            "bound_ms")
    tot = {k: sum(c * r[k] for *_, c, r in sites) for k in keys}
    res["deconv"] = dict(
        tot, max_abs_err=max([r["max_abs_err"] for *_, r in sites]
                             + [r32["max_abs_err"]]),
        bound_by=max(sites, key=lambda t: t[4] * t[5]["bound_ms"])[5][
            "bound_by"])
    log(f"phase 2: deconv, the 14 sites of one {B}-frame batch: kernel "
        f"{tot['ms']:.3f} ms device ({tot['wall_ms']:.3f} wall), plain "
        f"{tot['plain_ms']:.3f} ms, conv_transpose2d {tot['library_ms']:.3f} "
        f"ms device ({tot['library_wall_ms']:.3f} wall), bound "
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
    attention_two_pass(B)
    res["attention_flash"] = flash_check(g)
    return res


def flash_check(g) -> dict:
    """The flash kernel at Depth Anything V2's shape: a batch of
    ``DAV2_BATCH`` 1080p frames at 518 x 924, qkv [8, 2443, 3072] bf16 at
    16 heads, through ``qkv_attention`` (which hands it to the flash
    kernel), against its plain version in its own order
    (``flash_attention_plain``: max 8e-3, mean 1e-5) and the full-row
    plain version (``short_seq_attention_plain``, p rounded at the final
    max, not the running one: max 8e-3, mean 1e-4), the bounds of
    tests/test_torch_cuda.py::test_flash_attention_at_depth_anythings_shape.
    Times: the kernel, both plain versions, the split kernel's two-pass
    route on views of the same qkv, SDPA's flash backend; the bound is
    ``frozen/dav2.flash_attention_bound``'s (4 N T^2 D operations at the
    bf16 tensor peak, or q, k, v and the output at 3.35 TB/s)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from vsc_tpu_torch.ops import _cuda
    from vsc_tpu_torch.ops.attention_cuda import (flash_attention_plain,
                                                  qkv_attention,
                                                  short_seq_attention,
                                                  short_seq_attention_plain)
    from vsc_tpu_torch.utils.flops import least_time
    N, T, H, Dh, scale = DAV2_BATCH, DAV2_TOKENS, 16, 64, 0.125
    qkv = torch.randn((N, T, 3 * H * Dh), generator=g, device=g.device).to(
        torch.bfloat16)
    q, k, v = qkv.view(N, T, 3, H, Dh).unbind(2)
    before = dict(_cuda.LAUNCHES), dict(_cuda.ROUTE_LAUNCHES)
    o = qkv_attention(qkv, H, scale).float()
    check(_cuda.LAUNCHES["attention_flash"]
          == before[0]["attention_flash"] + 1
          and _cuda.ROUTE_LAUNCHES["flash"] == before[1]["flash"] + 1
          and _cuda.LAUNCHES["attention"] == before[0]["attention"]
          and _cuda.LAUNCHES["attention_split"]
          == before[0]["attention_split"],
          f"[{N}, {T}] bf16 attention did not take the flash kernel alone")
    d_own = (o - flash_attention_plain(qkv, H, scale).float()).abs()
    d_row = (o - short_seq_attention_plain(q, k, v, scale).float().view(
        N, T, -1)).abs()
    err = float(torch.maximum(d_own.max(), d_row.max()))
    own = (float(d_own.max()), float(d_own.mean()))
    row = (float(d_row.max()), float(d_row.mean()))
    del o, d_own, d_row
    check(own[0] <= 8e-3 and own[1] <= 1e-5,
          f"flash kernel vs its own order: max {own[0]}, mean {own[1]}")
    check(row[0] <= 8e-3 and row[1] <= 1e-4,
          f"flash kernel vs the full-row plain version: max {row[0]}, "
          f"mean {row[1]}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa_flash():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
    r = dict(max_abs_err=err, mean_abs_err=own[1], full_row_max_err=row[0],
             full_row_mean_err=row[1],
             ms=time_ms(lambda: qkv_attention(qkv, H, scale)),
             plain_ms=time_ms(lambda: flash_attention_plain(qkv, H, scale),
                              reps=2),
             full_row_plain_ms=time_ms(lambda: short_seq_attention_plain(
                 q, k, v, scale), reps=2),
             two_pass_ms=time_ms(lambda: short_seq_attention(q, k, v,
                                                             scale)),
             library_ms=time_ms(sdpa_flash),
             **least_time(nbytes(qkv) + nbytes(qkv) // 3,
                          bf16_tensor=4.0 * N * T * T * H * Dh))
    log(f"phase 2: attention_flash bf16 [{N}, {T}, {3 * H * Dh}] (Depth "
        f"Anything V2 at 1080p): vs its own order max {own[0]:.3g}, mean "
        f"{own[1]:.3g} [max 8e-3, mean 1e-5], vs the full row max "
        f"{row[0]:.3g}, mean {row[1]:.3g} [max 8e-3, mean 1e-4]; kernel "
        f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms (full row "
        f"{r['full_row_plain_ms']:.3f}), two-pass route "
        f"{r['two_pass_ms']:.3f} ms, sdpa flash {r['library_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}, "
        f"{100 * r['bound_ms'] / r['ms']:.1f} % of it)")
    del qkv, q, k, v, qt, kt, vt
    return r


def attention_two_pass(B: int) -> None:
    """Attention beyond the qkv kernel's 640 tokens: the token counts of
    DepthPro at input 2048 (tiles of 512: [36B, 1025] tokens) and 4096
    (4097 tokens), through qkv_attention (bf16, on the flash kernel,
    against its plain version in its own order) and short_seq_attention
    (f32, on the split kernel's two-pass route), against the plain
    versions, with SDPA's time beside them."""
    import torch
    from vsc_tpu_torch.utils.flops import least_time
    import torch.nn.functional as F
    from vsc_tpu_torch.ops import _cuda
    from vsc_tpu_torch.ops.attention_cuda import (flash_attention_plain,
                                                  qkv_attention,
                                                  short_seq_attention,
                                                  short_seq_attention_plain)
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(22)
    H, Dh, scale = 16, 64, 0.125
    for dtype, N, T in ((torch.bfloat16, 36 * B, 1025),
                        (torch.float32, 36 * B, 1025),
                        (torch.bfloat16, 2, 4097)):
        qkv = torch.randn((N, T, 3 * H * Dh), generator=g, device=dev).to(
            dtype)
        q, k, v = qkv.view(N, T, 3, H, Dh).unbind(2)
        bf16 = dtype == torch.bfloat16
        if bf16:
            fn = lambda: qkv_attention(qkv, H, scale)          # noqa: E731
            o_p = flash_attention_plain(qkv, H, scale).float()
            plain = lambda: flash_attention_plain(qkv, H, scale)  # noqa: E731
        else:
            fn = lambda: short_seq_attention(q, k, v, scale)   # noqa: E731
            o_p = short_seq_attention_plain(q, k, v, scale).float()
            plain = lambda: short_seq_attention_plain(        # noqa: E731
                q, k, v, scale)
        before = dict(_cuda.ROUTE_LAUNCHES)
        o = fn().float()
        route = "flash" if bf16 else "split_two_pass"
        check(_cuda.ROUTE_LAUNCHES[route] == before[route] + 1,
              f"attention at {T} tokens did not take the {route} route")
        err = float((o.reshape(o_p.shape) - o_p).abs().max())
        mean_err = float((o.reshape(o_p.shape) - o_p).abs().mean())
        del o, o_p
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ops = 4.0 * T * T * Dh * N * H
        r = dict(ms=time_ms(fn, reps=3), plain_ms=time_ms(plain, reps=1),
                 library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, scale=scale), reps=3),
                 **least_time(nbytes(qkv) + nbytes(qkv) // 3,
                              **({"bf16_tensor": ops,
                                  "f32": 5.0 * T * T * N * H} if bf16 else
                                 {"f32": ops + 5.0 * T * T * N * H})))
        ok = (err <= 8e-3 and mean_err <= 1e-5) if bf16 else err <= 2e-5
        name = (f"{'qkv_attention' if bf16 else 'short_seq_attention'} "
                f"{str(dtype)[6:]} [{N}, {T}, {3 * H * Dh}], {route} route")
        log(f"phase 2: {name}: max_abs_err {err:.3g}, mean {mean_err:.3g} "
            f"[{'max 8e-3, mean 1e-5' if bf16 else 'max 2e-5'}], kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, sdpa "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']})")
        check(ok, f"{name} disagrees: max {err}, mean {mean_err}")
        del qkv, q, k, v, qt, kt, vt


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


def small_sbs_check(params, dev, rgb=None, dsm=None, phase=3, what=""):
    """The SBS composition on the card vs the CPU plain path, by default on
    2 x 72 x 128 synthetic frames (else on the CPU tensors ``rgb`` [B, 72,
    128, 3] and ``dsm`` [B, 72, 128], u8 or u16), disparity and convergence
    scaled from 1920 to 128 columns."""
    import torch
    from vsc_tpu_torch.ops.stereo import StereoParams
    if rgb is None:
        g = torch.Generator().manual_seed(3)
        rgb = (torch.rand((2, 72, 128, 3), generator=g) * 255).to(torch.uint8)
        dsm = (smooth_depth(2, 72, 128, torch.device("cpu"), 4) * 255).to(
            torch.uint8)
    small = StereoParams(max_disparity=params.max_disparity * 128 / 1920,
                         convergence=params.convergence * 128 / 1920,
                         super_sampling=params.super_sampling)
    sbs_card_vs_cpu(rgb, dsm, small, dev,
                    f"phase {phase}: small SBS{what} card vs CPU plain at "
                    f"super_sampling {params.super_sampling:g}")


def sbs_card_vs_cpu(rgb, dsm, params, dev, label: str) -> float:
    """generate_sbs on the card against the CPU plain path on the CPU
    tensors rgb and dsm, under the planar-u8 thresholds (mean diff < 0.05,
    > 1 code on < 0.5 % of values, max <= 16). Returns the CPU path's
    seconds."""
    from vsc_tpu_torch.ops.stereo import generate_sbs
    t0 = time.perf_counter()
    ref = generate_sbs(rgb, dsm, params).int()
    cpu_s = time.perf_counter() - t0
    got = generate_sbs(rgb.to(dev), dsm.to(dev), params).cpu().int()
    diff = (got - ref).abs().float()
    mean, over1, top = (float(diff.mean()), float((diff > 1).float().mean()),
                        int(diff.max()))
    log(f"{label}: mean diff {mean:.4f}, >1 code {over1:.5f}, max {top} "
        f"(CPU plain path {cpu_s:.2f} s)")
    check(mean < 0.05 and over1 < 0.005 and top <= 16,
          "SBS on the card disagrees with the CPU plain path")
    return cpu_s


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


# launch counter -> its checks in phase_ss_kernels
SS_PARTS = {"upsample": ("upsample_u8", "upsample_f32"),
            "pool": ("pool_eye4", "pool_f32"), "pyramid": ("pyramid",),
            "finish": ("finish",), "warp": ("warp_planar_u8",),
            "blur": ("blur",), "postprocess": ("postprocess",),
            "bilateral": ("bilateral",)}


def merge_ss(ss: dict) -> dict:
    """One row per launch counter from phase_ss_kernels' checks: the
    largest error over the counter's checks; a row of several checks
    (upsample, pool) sums their times and bounds, and has a library time
    only when every part has one. A counter whose checks did not run at
    these shapes (the pools and the bilateral at an odd W') has no row."""
    rows = {}
    for name, keys in SS_PARTS.items():
        if not all(k in ss for k in keys):
            continue
        rows[name] = {
            "max_abs_err": max(ss[k]["max_abs_err"] for k in keys),
            "ms": sum(ss[k]["ms"] for k in keys),
            "plain_ms": sum(ss[k]["plain_ms"] for k in keys),
            "bound_ms": sum(ss[k]["bound_ms"] for k in keys),
            "bound_by": max((ss[k] for k in keys),
                            key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": (sum(ss[k]["library_ms"] for k in keys)
                           if all("library_ms" in ss[k] for k in keys)
                           else None)}
    return rows


def merge_kernel_results(ss1: dict, ss3: dict, depth: dict) -> dict:
    """One row per launch counter for the kernels line: times at the main
    path's (super_sampling 3) shapes where the kernel has a check there
    (super_sampling 1 times kept beside them), the largest error over every
    check of the kernel (merge_ss)."""
    rows = dict(ss1)
    rows.update(depth)
    for name, row in merge_ss(ss3).items():
        if name in ss1:
            row.update(max_abs_err=max(row["max_abs_err"],
                                       ss1[name]["max_abs_err"]),
                       ss1_ms=ss1[name]["ms"],
                       ss1_plain_ms=ss1[name]["plain_ms"])
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
                 t_sbs: float, card: str, default_groups: dict) -> dict:
    """The JAX package's opt-in routes to its last three kernels, each
    driven through render_sbs for ROUTE_BATCHES batches with the launch
    counters reset around the run (``default_groups``: the default batch's
    device time by group). Returns each route's counts."""
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
        cl = torch.channels_last
        broken = {
            "drops its last 8 input channels": lambda x, w, b, packed: real(
                x[:, :-8].contiguous(memory_format=cl), w[:-8].contiguous(),
                b),
            "swaps the row and column phases": lambda x, w, b, packed: real(
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
        groups = log_profile("one VSC_TPU_PALLAS_DECONV=1 batch",
                             lambda: render_sbs(frames[-1], depth_fn, params),
                             group=CONV_GROUP)
    conv = "convolutions (cuDNN)"
    log(f"phase 3: per batch, the deconv route's {conv} group "
        f"{groups[conv]:.2f} ms + deconv kernel {groups['deconv kernel']:.2f} "
        f"ms against the default route's {conv} group "
        f"{default_groups[conv]:.2f} ms (cuDNN's ConvT included); depth "
        f"{td / B:.1f} against {t_depth / B:.1f} ms/frame")

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
    from vsc_tpu_torch.ops import _cuda
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
        f"(super_sampling 3): {launches}; split attention by route: "
        f"{_cuda.ROUTE_LAUNCHES}")
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
    pair_holes(frames[0], depth, params)
    default_groups = log_profile(
        "one default batch", lambda: render_sbs(frames[-1], depth_fn, params),
        group=CONV_GROUP)

    small_sbs_check(ss1, dev)
    small_sbs_check(params, dev)
    launches.update(phase_routes(B, depth_fn, frames, params, t_depth, t_sbs,
                                 card, default_groups))
    del depth_fn
    depth_2048(card)
    return launches


def depth_2048(card: str) -> None:
    """One batch of one 1080p frame through full-width DepthPro at input
    2048 (tiles of 512: 1025 tokens, past the qkv kernel's 640, so every
    attention takes the flash kernel), counters reset just before and read
    just after."""
    import torch
    from vsc_tpu_torch.ops import _cuda
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depth_fn
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    fn = build_depth_fn("depthpro", 2048, 1080, 1920, False, device=dev,
                        seed=0)
    frame = frames_u8(1, dev, 30)
    fn(frame)                                          # warm-up
    torch.cuda.synchronize()
    log(f"phase 3: full-width DepthPro at input 2048 (bf16) built and "
        f"warmed in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    depth = fn(frame)
    torch.cuda.synchronize()
    launches, routes = dict(_cuda.LAUNCHES), dict(_cuda.ROUTE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 3: launches of one 1-frame batch at input 2048: {launches}; "
        f"split attention by route: {routes}")
    check(launches["attention_flash"] > 0 and launches["attention"] == 0
          and launches["attention_split"] == 0
          and routes["flash"] == launches["attention_flash"],
          f"input 2048 attention: {launches} {routes}")
    check(tuple(depth.shape) == (1, 1080, 1920)
          and depth.dtype == torch.uint8
          and int(depth.max()) > int(depth.min()),
          f"input 2048 depth {tuple(depth.shape)} {depth.dtype}")
    t = time_ms(lambda: fn(frame), reps=2)
    log(f"phase 3: input 2048: depth {t:.1f} ms/frame (1-frame batches), "
        f"peak device memory {peak:.2f} GiB, on {card}")


def pair_holes(frame, depth, params) -> None:
    """The postprocess on the default path's own pair (one batch, the
    model's depth): the share of its tiles that take the hole path, and
    its time there (the phase-2 pair comes from a smooth synthetic depth)."""
    from vsc_tpu_torch.ops import stereo
    from vsc_tpu_torch.ops.postprocess_cuda import (TILE_H, TILE_W,
                                                    hole_tiles)
    seen = []
    real = stereo.postprocess_eye

    def recording(eye4, smooth_q, smoothing):
        seen.append((eye4, smooth_q, smoothing))
        return real(eye4, smooth_q, smoothing)
    stereo.postprocess_eye = recording
    try:
        stereo.generate_sbs(frame, depth, params)
    finally:
        stereo.postprocess_eye = real
    eye4, smooth_q, smoothing = seen[0]
    log(f"phase 3: the default path's pair {tuple(eye4.shape)}: "
        f"{100 * float(hole_tiles(eye4[3]).float().mean()):.1f} % of its "
        f"{TILE_H} x {TILE_W} tiles take the hole path, "
        f"{100 * float((eye4[3] == 0).float().mean()):.2f} % of pixels are "
        f"holes; postprocess {time_ms(lambda: real(*seen[0])):.3f} ms")


def phase_cli():
    from vsc_tpu_torch.native import vscmedia_path
    missing = []
    try:
        import tqdm  # noqa: F401
    except ImportError:
        missing.append("tqdm")
    if vscmedia_path() is None:        # counts only a binary that starts
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


STEP_FRAMES = 12        # phase 5: a full depth batch of 8 and a padded one
STEP_DEPTH_BATCH = 8
STEP_SBS_BATCH = 4
# the kernels of the SBS step at the defaults (super_sampling 3)
SBS_STEP_KERNELS = ("blur", "warp", "postprocess", "upsample", "pool",
                    "pyramid", "finish")


def new_workflow(path: Path, video: Path) -> Path:
    from vsc_tpu_torch.pipeline import workflow_init
    with contextlib.redirect_stdout(io.StringIO()):
        rc = workflow_init.main(["--input-video", str(video),
                                 "--workflow-dir", str(path)])
    check(rc == 0, f"workflow_init.main on {path} returned {rc}")
    return path


def write_frames(wf: Path, frames) -> None:
    from vsc_tpu_torch.io.image import write_rgb
    for i, f in enumerate(frames, 1):
        check(write_rgb(wf / "frames" / f"frame_{i:06d}.png", f),
              f"write frame {i}")


def step_main(module, argv, what: str) -> tuple[float, str]:
    """One step CLI's main(argv): its wall time (host clock) and output;
    a nonzero exit code fails the run."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"{what} exited {rc}: {out.getvalue()[-2000:]}")
    return wall, out.getvalue()


class pipeline_clock:
    """Wall time of each run_pipeline call (the loader, compute and saver
    threads of a step, without the model's build or the first read), which
    also runs inside a profiler event named "step_pipeline", and the host
    seconds spent in each of its four callables (``parts``)."""

    PARTS = ("load_batch", "compute", "save_one", "split_results")

    def __enter__(self):
        from torch.profiler import record_function
        from vsc_tpu_torch.io import prefetch
        self.real, self.seconds = prefetch.run_pipeline, []
        self.parts = {name: 0.0 for name in self.PARTS}

        def clocked(name, fn):
            def call(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.parts[name] += time.perf_counter() - t0
            return call

        def timed(items, *fns, **k):
            fns = [clocked(n, f) for n, f in zip(self.PARTS, fns)]
            t0 = time.perf_counter()
            try:
                with record_function("step_pipeline"):
                    return self.real(items, *fns, **k)
            finally:
                self.seconds.append(time.perf_counter() - t0)
        prefetch.run_pipeline = timed
        return self

    def breakdown(self) -> str:
        """Host seconds by callable: the loader thread's reads, the main
        thread's launches (compute) and waits for a batch's copy back
        (split_results), the saver thread's writes."""
        return ", ".join(f"{n} {t:.3f} s" for n, t in self.parts.items())

    def __exit__(self, *exc):
        from vsc_tpu_torch.io import prefetch
        prefetch.run_pipeline = self.real


def step_busy_share(module, argv, what: str) -> str:
    """The device's busy share over one step's pipeline (run_pipeline's
    window), from torch.profiler's device events, and its device time by
    kernel group and top kernels."""
    def run():
        with pipeline_clock():
            step_main(module, argv, what)
    prof = profile_device(run, window="step_pipeline")
    top = sorted(prof["per_kernel"].items(), key=lambda kv: -kv[1])[:6]
    return (f"device busy {prof['busy_ms']:.1f} of {prof['window_ms']:.1f} "
            f"ms of the pipeline "
            f"({100 * prof['busy_ms'] / prof['window_ms']:.1f} %), "
            f"{prof['events']} device events; by group: " + "; ".join(
                f"{g} {t:.1f} ms" for g, t in sorted(
                    prof["groups"].items(), key=lambda kv: -kv[1]) if t > 0)
            + "; top: " + "; ".join(f"{t:.1f} ms {n[:60]}" for n, t in top))


def depth_on_step_batches(fn, frames, batch: int, dev):
    """fn on host frames [n, H, W, 3] in the depth step's own batches (the
    last one padded with its last frame to ``batch``), as numpy."""
    import numpy as np
    import torch
    n, want = len(frames), []
    for i in range(0, n, batch):
        b = frames[i:i + batch]
        b = np.concatenate([b] + [b[-1:]] * (batch - len(b)))
        want.append(fn(torch.from_numpy(b).to(dev))[:n - i].cpu().numpy())
    return np.concatenate(want)


def check_sbs_files(files, frames, depth, batch: int, dev) -> None:
    """The SBS step's PNGs against generate_sbs on the host frames and
    depth in the step's batches, bit for bit."""
    import numpy as np
    import torch
    from vsc_tpu_torch.io.image import read_rgb
    from vsc_tpu_torch.ops.stereo import StereoParams, generate_sbs
    check(len(files) == len(frames), f"{len(files)} SBS files")
    for i in range(0, len(frames), batch):
        sl = slice(i, i + batch)
        ref = generate_sbs(torch.from_numpy(frames[sl]).to(dev),
                           torch.from_numpy(depth[sl]).to(dev),
                           StereoParams()).cpu().numpy()
        for f, w in zip(files[sl], ref):
            check(np.array_equal(read_rgb(f), w),
                  f"{f.name} differs from generate_sbs")


def sixteen_bit_pass(path: Path, video: Path, frames, depth_argv, sbs_argv,
                     dev, phase: int):
    """The depth and SBS step CLIs on a new workflow with save_16bit: the
    depth as uint16 TIFFs spanning 0..65535, the SBS PNGs equal to
    generate_sbs on the frames and that depth, bit for bit. Returns the
    depth read back."""
    import numpy as np
    from vsc_tpu_torch.config import load_config, save_config
    from vsc_tpu_torch.io.image import read_depth
    from vsc_tpu_torch.pipeline import depth_map_generator, sbs_generator
    n = len(frames)
    wf16 = new_workflow(path, video)
    config = load_config(wf16)
    config["depth"]["save_16bit"] = True
    save_config(wf16, config)
    write_frames(wf16, frames)
    step_main(depth_map_generator, [str(wf16), *depth_argv],
              "16-bit depth step")
    tifs = sorted((wf16 / "depth_maps").glob("depth_frame_*.tif"))
    d16 = np.stack([read_depth(f) for f in tifs])
    check(len(tifs) == n and d16.dtype == np.uint16
          and all(int(d.min()) == 0 and int(d.max()) == 65535 for d in d16),
          f"16-bit depth: {len(tifs)} files, {d16.dtype}")
    step_main(sbs_generator, [str(wf16), *sbs_argv], "16-bit SBS step")
    check_sbs_files(sorted((wf16 / "sbs").glob("sbs_*.png")), frames, d16,
                    n, dev)
    log(f"phase {phase}: 16-bit pass: {n} uint16 TIFFs (0..65535 each), SBS "
        "PNGs equal generate_sbs on them bit for bit")
    return d16


def phase_steps(card: str) -> dict:
    """Phase 5: the step workflow through its mains at 1080p. Returns the
    launches of the counted depth and SBS steps by kernel."""
    import shutil

    import numpy as np
    import torch
    from vsc_tpu_torch.config import load_config
    from vsc_tpu_torch.io.image import read_depth, read_rgb
    from vsc_tpu_torch.ops import _cuda
    from vsc_tpu_torch.ops.stereo import StereoParams
    from vsc_tpu_torch.pipeline import (depth_map_generator, sbs_generator,
                                        sbs_tester)
    dev = torch.device("cuda")
    n = STEP_FRAMES
    depth_argv = ["--model", "depthpro", "--batch-size",
                  str(STEP_DEPTH_BATCH), "--no-interactive"]
    sbs_argv = ["--batch-size", str(STEP_SBS_BATCH), "--no-interactive"]
    frames = frames_u8(n, dev, 50).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        video = tmp / "input.mkv"    # workflow_init checks only is_file()
        video.touch()
        wf = new_workflow(tmp / "workflow", video)
        warm = new_workflow(tmp / "warm", video)
        write_frames(wf, frames)
        write_frames(warm, frames_u8(n, dev, 60).cpu().numpy())
        log("phase 5: workflow_init.main made two workflows; "
            f"{n} 1080p frames written to each")
        phase_steps_extract(tmp)

        # warm-up on other frames: cuDNN and cuBLAS choices, first launches
        step_main(depth_map_generator, [str(warm), *depth_argv], "warm depth")
        step_main(sbs_generator, [str(warm), *sbs_argv], "warm SBS")

        # the depth step, counted and timed
        _cuda.reset_launches()
        with pipeline_clock() as clock:
            t_depth, out = step_main(depth_map_generator,
                                     [str(wf), *depth_argv], "depth step")
        l_depth = dict(_cuda.LAUNCHES)
        depth_files = sorted((wf / "depth_maps").glob("depth_frame_*.png"))
        check(len(depth_files) == n, f"{len(depth_files)} depth maps")
        check(l_depth["attention"] > 0, f"depth step launches {l_depth}")
        batches = -(-n // STEP_DEPTH_BATCH)
        log(f"phase 5: depth step ({n} frames, batch {STEP_DEPTH_BATCH}): "
            f"launches {l_depth} ({batches} batches); wall {t_depth:.2f} s = "
            f"{n / t_depth:.2f} frames/s around main, pipeline "
            f"{clock.seconds[0]:.2f} s = {n / clock.seconds[0]:.2f} frames/s "
            f"({clock.breakdown()}) on {card}")

        # its PNGs against build_depth_fn on the CLI's own padded batches
        read = np.stack([read_rgb(f) for f in
                         sorted((wf / "frames").glob("frame_*.png"))])
        check(np.array_equal(read, frames), "frames read back differ")
        fn = depth_map_generator.build_depth_fn(
            "depthpro", 1536, 1080, 1920, False, device=dev, seed=0)
        want = depth_on_step_batches(fn, read, STEP_DEPTH_BATCH, dev)
        del fn
        got = np.stack([read_depth(f) for f in depth_files])
        check(got.dtype == np.uint8 and np.array_equal(got, want),
              f"depth PNGs differ from build_depth_fn: "
              f"{int((got != want).sum())} pixels")
        log("phase 5: depth PNGs equal build_depth_fn on the same padded "
            f"batches bit for bit ({n} frames)")
        shutil.rmtree(wf / "depth_maps")
        log("phase 5: depth step under torch.profiler: " + step_busy_share(
            depth_map_generator, [str(wf), *depth_argv], "profiled depth")
            + f" on {card}")
        check(np.array_equal(np.stack([read_depth(f) for f in depth_files]),
                             want), "the profiled depth run differs")

        # resume: nothing left to do, nothing launched
        _cuda.reset_launches()
        _, out = step_main(depth_map_generator, [str(wf), *depth_argv],
                           "depth resume")
        relaunch = sum(_cuda.LAUNCHES.values())
        check("0 to process" in out and relaunch == 0,
              f"depth resume: {relaunch} launches, {out[-500:]}")
        log("phase 5: a second depth run: 0 to process, 0 launches")

        # the SBS step at the defaults, counted and timed
        config = load_config(wf)
        check(config["stereo"] == StereoParams().to_dict(), config["stereo"])
        _cuda.reset_launches()
        with pipeline_clock() as clock:
            t_sbs, _ = step_main(sbs_generator, [str(wf), *sbs_argv],
                                 "SBS step")
        l_sbs = dict(_cuda.LAUNCHES)
        check(all(l_sbs[k] > 0 for k in SBS_STEP_KERNELS),
              f"SBS step launches {l_sbs}")
        sbs_files = sorted((wf / "sbs").glob("sbs_*.png"))
        check(len(sbs_files) == n, f"{len(sbs_files)} SBS frames")
        check(not list((wf / "frames").glob("*.png")),
              "free_space 'frame' left frames")
        batches = -(-n // STEP_SBS_BATCH)
        log(f"phase 5: SBS step ({n} frames, batch {STEP_SBS_BATCH}, "
            f"StereoParams() defaults, free_space 'frame'): launches {l_sbs} "
            f"({batches} batches); wall {t_sbs:.2f} s = {n / t_sbs:.2f} "
            f"frames/s around main, pipeline {clock.seconds[0]:.2f} s = "
            f"{n / clock.seconds[0]:.2f} frames/s ({clock.breakdown()}) on "
            f"{card}")
        check_sbs_files(sbs_files, read, got, STEP_SBS_BATCH, dev)
        log("phase 5: SBS PNGs equal generate_sbs on the frames and the "
            f"depth read back, bit for bit ({n} frames)")

        phase_steps_timing(wf, frames, sbs_argv, card)

        d16 = sixteen_bit_pass(tmp / "workflow16", video, frames[:4],
                               depth_argv, sbs_argv, dev, 5)
        crop = (slice(None, 1), slice(400, 472), slice(800, 928))
        small_sbs_check(StereoParams(), dev,
                        torch.from_numpy(frames[crop].copy()),
                        torch.from_numpy(d16[crop].copy()), phase=5,
                        what=" on a 72 x 128 crop of the 16-bit pass")

        # the tester's grid on the frames and 8-bit depth
        write_frames(wf, frames)
        grid_dir = tmp / "grid"
        step_main(sbs_tester, [str(wf), "--grid",
                               "max_disparity=20,40;super_sampling=1,3",
                               "--frames", "2", "--out-dir", str(grid_dir)],
                  "sbs_tester --grid")
        report = json.loads((grid_dir / "grid_report.json").read_text())
        check(len(report) == 4 and all(e["frames_per_s"] > 0
                                       for e in report), report)
        log("phase 5: sbs_tester --grid (2 frames): " + "; ".join(
            f"{e['label']} {e['frames_per_s']} frames/s (first call "
            f"{e['first_call_s']} s)" for e in report) + f" on {card}")
    return {k: l_depth[k] + l_sbs[k] for k in l_depth}


def phase_steps_extract(tmp: Path, width: int = 320, height: int = 180,
                        phase: int = 5) -> None:
    """frame_extractor.main on a 12-frame clip of width x height, where the
    media engine starts."""
    from vsc_tpu_torch.native import vscmedia_path
    if vscmedia_path() is None:
        log(f"phase {phase}: frame_extractor not run: the vscmedia media "
            "engine (libav) does not start here")
        return
    from vsc_tpu_torch.io.media import make_test_video
    from vsc_tpu_torch.pipeline import frame_extractor
    video = tmp / "clip.mkv"
    make_test_video(video, width=width, height=height, frames=12,
                    framerate="24/1", with_audio=False)
    wf = new_workflow(tmp / "extract", video)
    step_main(frame_extractor, [str(wf)], "frame_extractor")
    got = len(list((wf / "frames").glob("frame_*.png")))
    check(got == 12, f"frame_extractor wrote {got} frames")
    log(f"phase {phase}: frame_extractor.main extracted 12 {width} x "
        f"{height} frames")


def phase_steps_timing(wf: Path, frames, sbs_argv, card: str) -> None:
    """The SBS step again on the same frames: under torch.profiler (the
    device's busy share over the step), then with and without its
    per-dispatch health probe (the probe replaced here only), in the order
    probe, none, none, probe."""
    import shutil
    from vsc_tpu_torch.parallel import health
    from vsc_tpu_torch.pipeline import sbs_generator

    def rerun(what):
        shutil.rmtree(wf / "sbs")
        write_frames(wf, frames)
        return step_main(sbs_generator, [str(wf), *sbs_argv], what)[0]

    shutil.rmtree(wf / "sbs")
    write_frames(wf, frames)
    log("phase 5: SBS step under torch.profiler: " + step_busy_share(
        sbs_generator, [str(wf), *sbs_argv], "profiled SBS step")
        + f" on {card}")
    real = health.check_accelerator_health
    walls = {}
    for probe in (True, False, False, True):
        health.check_accelerator_health = (
            real if probe else lambda device=None, timeout=None: True)
        try:
            walls.setdefault(probe, []).append(rerun("SBS step"))
        finally:
            health.check_accelerator_health = real
    n = len(frames)
    log("phase 5: SBS step with the per-dispatch probe " + ", ".join(
        f"{w:.3f} s ({n / w:.2f} frames/s)" for w in walls[True])
        + "; without " + ", ".join(
        f"{w:.3f} s ({n / w:.2f} frames/s)" for w in walls[False])
        + f" on {card}")


ORCH_FRAMES = 24        # phase 6: frames of each of its two 1080p clips
ORCH_TIMEOUT = 600.0    # phase 6: the orchestrated run's limit, seconds
# phase 6: the kernels each child's trace must show, by trace-name pattern
TRACE_KERNELS = {
    "depth_map_generator": {"attention": r"qkv_attention_kernel"},
    "sbs_generator": {
        "blur": r"::blur_kernel[<(]", "warp": r"::warp_kernel[<(]",
        "postprocess": r"::postprocess_tile_kernel[<(]",
        "upsample": r"::upsample_kernel[<(]",
        "pool": r"::(pool_eye4|pool2)_kernel[<(]",
        "pyramid": r"::pyramid_(down|top|up)_kernel[<(]",
        "finish": r"::sharpen_downscale_kernel[<(]"},
}


def write_npz_cache(dev) -> tuple[Path, float, float]:
    """The seeded full-width DepthPro's parameters, in float32, written as
    the npz weight cache a user's first hub download leaves
    (``models/bootstrap.npz_cache_path()``). Returns the path, the write
    seconds and the seconds of one load of it into a model on ``dev``."""
    import numpy as np
    import torch
    from vsc_tpu_torch.models.bootstrap import npz_cache_path
    from vsc_tpu_torch.models.convert import jax_flat_from_state_dict
    from vsc_tpu_torch.pipeline.depth_map_generator import (DTYPE_ENV,
                                                            build_depthpro)
    with env_set(DTYPE_ENV, "float32"):
        model = build_depthpro(1536, dev, seed=0)
    dest = npz_cache_path()
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_name(dest.stem + ".tmp.npz")
    t0 = time.perf_counter()
    np.savez(str(tmp), **jax_flat_from_state_dict(model.state_dict(), model))
    os.replace(tmp, dest)
    t_write = time.perf_counter() - t0
    del model
    t0 = time.perf_counter()
    model = build_depthpro(1536, dev, checkpoint=str(dest))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    return dest, t_write, t_load


def cv2_writes_ffv1(path: Path) -> bool:
    """cv2's FFV1 writer opens and writes (the chunk step's encoder where
    vscmedia does not start)."""
    import cv2
    import numpy as np
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"FFV1"),
                             24.0, (64, 48))
    ok = writer.isOpened()
    if ok:
        writer.write(np.zeros((48, 64, 3), np.uint8))
    writer.release()
    return ok and path.is_file() and path.stat().st_size > 0


def run_orchestrated(yaml_path: Path, cfg, skip: set, timeout: float):
    """The port's orchestrator over yaml_path in this process's main thread
    (its signal handlers need it), its dashboard into a buffer. Steps in
    ``skip`` are never started; the run then stops once nothing runs and
    every workflow has its persistent steps DONE and, unless the chunk step
    is skipped too, all its chunks. It also stops at the first FAILED or
    ERROR. Returns the orchestrator; its ``events`` hold every log line
    with its host time, ``t0`` and ``t1`` the run's start and end."""
    import asyncio
    import re

    from rich.console import Console
    from vsc_tpu_torch.runtime import workflow_metrics as wm
    from vsc_tpu_torch.runtime.orchestrator import Orchestrator
    from vsc_tpu_torch.runtime.workflow_state import (PERSISTENT_STEPS,
                                                       StepStatus,
                                                       get_step_status,
                                                       load_workflows)

    class Timed(Orchestrator):
        def log(self, message):
            self.events.append((time.perf_counter(), message))
            super().log(message)

        def _can_start(self, step, workflow_path, workflow):
            return step not in skip and super()._can_start(
                step, workflow_path, workflow)

    orch = Timed(yaml_path, load_workflows(yaml_path), cfg,
                 console=Console(file=io.StringIO(), width=160))
    orch.events = []

    def should_stop():
        if any(re.search(r"(FAILED|ERROR)\[/", m) for _, m in orch.events):
            return True
        if orch.active or not skip:
            return False
        wm.invalidate_cache()
        return all(
            all(get_step_status(wf.get(s)) == StepStatus.DONE
                for s in PERSISTENT_STEPS)
            and ("chunk_generator" in skip
                 or wm.is_all_chunks_complete(Path(p)))
            for p, wf in orch.workflows.items())

    async def drive():
        task = asyncio.create_task(orch.run())
        try:
            while not task.done():
                if should_stop():
                    orch.stop_event.set()
                    orch.wakeup.set()
                await asyncio.sleep(0.25)
            await task
        finally:
            if not task.done():       # the limit cut the run
                task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await task
                await orch.shutdown()

    orch.t0 = time.perf_counter()
    try:
        asyncio.run(asyncio.wait_for(drive(), timeout=timeout))
    except asyncio.TimeoutError:
        raise RuntimeError(
            f"check failed: the orchestrated run exceeded {timeout:.0f} s; "
            "its log: " + " | ".join(m for _, m in orch.events[-30:]))
    orch.t1 = time.perf_counter()
    return orch


def child_spans(orch) -> list[dict]:
    """Each child's step, workflow, start and exit (seconds from the run's
    start) and whether it exited 0, from the orchestrator's own STARTED /
    DONE / FAILED lines."""
    import re
    spans, running = [], {}
    for t, message in orch.events:
        m = re.search(r"(STARTED|DONE|FAILED|ERROR)\[/[\w ]+\]: (\w+) for "
                      r"(\S+)", message)
        if not m:
            continue
        what, step, name = m.groups()
        if what == "STARTED":
            running[(step, name)] = dict(step=step, workflow=name,
                                         start=t - orch.t0)
        else:
            span = running.pop((step, name))
            span.update(end=t - orch.t0, ok=what == "DONE")
            spans.append(span)
    check(not running, f"children with no exit line: {list(running)}")
    return sorted(spans, key=lambda s: s["start"])


def trace_kernel_counts(profile_dir: Path) -> dict:
    """{step: [(trace file, {kernel: launches})]} from each child's own
    trace: its device kernel events whose names match TRACE_KERNELS."""
    import re
    out = {}
    for step, patterns in TRACE_KERNELS.items():
        for path in sorted((profile_dir / step).glob("*/trace.json")):
            names = [e.get("name", "") for e in json.loads(
                path.read_text())["traceEvents"]
                if str(e.get("cat", "")).lower() == "kernel"]
            out.setdefault(step, []).append((path, {
                k: sum(1 for name in names if re.search(p, name))
                for k, p in patterns.items()}))
    return out


def check_chunks(wf: Path, n: int, size=(3840, 1080)) -> list[str]:
    """Every chunk of the workflow decodes (cv2) to its frame count at
    ``size``, and the last ends at frame n; returns their names."""
    import cv2
    from vsc_tpu_torch.config import get_path, load_config
    chunks = sorted(get_path(wf, load_config(wf), "chunks").glob("sbs_*.mkv"))
    check(bool(chunks), f"{wf}: no chunks")
    for c in chunks:
        first, last = (int(x) for x in c.stem.split("_")[1:3])
        cap = cv2.VideoCapture(str(c))
        got = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
               int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
        frames = 0
        while cap.read()[0]:
            frames += 1
        cap.release()
        check(got == tuple(size) and frames == last - first + 1,
              f"{c.name}: {got}, {frames} frames")
    check(max(int(c.stem.split("_")[2]) for c in chunks) == n,
          f"{wf}: chunks end before frame {n}")
    return [c.name for c in chunks]


def log_timeline(orch, spans, what: str, card: str) -> None:
    """The run's wall time and frames/s; each child's start and exit, split
    at its first and last output line (start-up, work, the rest: a traced
    child writes its trace after its last line); the gap from each exit to
    the next launch; whether depth of video 2 overlapped SBS of video 1."""
    wall = orch.t1 - orch.t0
    log(f"phase 6: {what}: the run took {wall:.2f} s for {2 * ORCH_FRAMES} "
        f"frames of two 1080p videos, {2 * ORCH_FRAMES / wall:.3f} frames/s, "
        f"on {card}")
    parts = []
    for s in spans:
        tag = f"[{s['step']}|{s['workflow']}]"
        lines = [t - orch.t0 for t, m in orch.events if tag in m
                 and s["start"] <= t - orch.t0 <= s["end"]]
        split = (f"{lines[0] - s['start']:.2f} + {lines[-1] - lines[0]:.2f} + "
                 f"{s['end'] - lines[-1]:.2f}" if lines else "no lines")
        parts.append(f"{s['step']}|{s['workflow']} {s['start']:.2f} - "
                     f"{s['end']:.2f} ({split})")
    log(f"phase 6: {what}: children, start - exit in s from the run's start "
        "(start-up to the first line + to the last + to the exit): "
        + "; ".join(parts))
    # each launch after the first tick's comes when a child's exit wakes
    # the scheduler: its gap is from the last exit before it
    gaps = []
    for s in spans:
        before = [o["end"] for o in spans if o["end"] <= s["start"]]
        if before:
            gaps.append((s["start"] - max(before),
                         f"{s['step']}|{s['workflow']}"))
    first = [f"{s['step']}|{s['workflow']}" for s in spans
             if not any(o["end"] <= s["start"] for o in spans)]
    log(f"phase 6: {what}: the first tick ({spans[0]['start']:.2f} s) "
        "launched " + ", ".join(first) + "; each later launch after the last "
        "exit before it, s: " + "; ".join(f"{w} {g:.3f}" for g, w in gaps)
        + (f" (max {max(g for g, _ in gaps):.3f}; the tick is 5 s)"
           if gaps else ""))

    def span(step, video):
        return next(s for s in spans if s["step"] == step
                    and s["workflow"] == video)
    d2, s1 = span("depth_map_generator", "video2"), span("sbs_generator",
                                                          "video1")
    overlap = min(d2["end"], s1["end"]) - max(d2["start"], s1["start"])
    log(f"phase 6: {what}: depth of video 2 ({d2['start']:.2f} - "
        f"{d2['end']:.2f}) " + (
            f"overlapped SBS of video 1 ({s1['start']:.2f} - "
            f"{s1['end']:.2f}) by {overlap:.2f} s" if overlap > 0 else
            f"did not overlap SBS of video 1 ({s1['start']:.2f} - "
            f"{s1['end']:.2f})"))


def orchestrate(root: Path, clips, skip: set, engine) -> tuple:
    """Two workflows (workflow_init.main; video 2 with free_space none)
    under root, one workflows.yaml, the orchestrator at its defaults over
    them. Fails unless every child exited 0 and the YAML reads as JAX's
    orchestrator writes it. Returns (orchestrator, child spans, workflows,
    yaml path)."""
    import re

    import yaml
    from vsc_tpu_torch.config import load_config, save_config
    from vsc_tpu_torch.runtime.orchestrator import OrchestratorConfig
    from vsc_tpu_torch.runtime.workflow_state import (PERSISTENT_STEPS,
                                                       load_workflows)
    wfs = [new_workflow(root / f"video{i}", clip)
           for i, clip in enumerate(clips, 1)]
    config = load_config(wfs[1])
    config["free_space"] = {"sbs_generator": "none",
                            "chunk_generator": "none"}
    save_config(wfs[1], config)
    yaml_path = root / "workflows.yaml"
    yaml_path.write_text(yaml.safe_dump({str(w): None for w in wfs},
                                        sort_keys=False))
    orch = run_orchestrated(yaml_path, OrchestratorConfig(), skip,
                            ORCH_TIMEOUT)
    failed = [m for _, m in orch.events if re.search(r"(FAILED|ERROR)\[/", m)]
    if failed:
        for t, m in orch.events:
            log(f"phase 6: log {t - orch.t0:8.2f} s: {m}")
    check(not failed, f"children failed: {failed}")
    spans = child_spans(orch)
    check(bool(spans) and all(s["ok"] for s in spans), f"children {spans}")
    saved = yaml.safe_load(yaml_path.read_text())
    done = dict.fromkeys(PERSISTENT_STEPS, "DONE")
    want = {str(w.resolve()): ("DONE" if engine is not None else done)
            for w in wfs}
    check(saved == want, f"workflows.yaml: {saved}")
    check(all(all(wf[s] == "DONE" for s in PERSISTENT_STEPS)
              for wf in load_workflows(yaml_path).values()),
          "workflows.yaml loads with steps not DONE")
    return orch, spans, wfs, yaml_path


def phase_orchestrator(card: str) -> None:
    """Phase 6: the port's orchestrator drives the step CLIs as child
    processes on the card, two 1080p clips from input to SBS chunks: once
    with VSC_TPU_PROFILE_DIR set (the checks), once without (the timing)."""
    import shutil

    import numpy as np
    import torch
    from vsc_tpu_torch.config import get_path, load_config
    from vsc_tpu_torch.io.image import read_depth, read_rgb
    from vsc_tpu_torch.io.media import make_test_video
    from vsc_tpu_torch.native import vscmedia_path
    from vsc_tpu_torch.ops.stereo import StereoParams, generate_sbs
    from vsc_tpu_torch.pipeline import depth_map_generator, sbs_generator
    from vsc_tpu_torch.runtime.workflow_metrics import DISK_SPACE_THRESHOLD_GB
    from vsc_tpu_torch.utils.profiling import PROFILE_ENV
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    n = ORCH_FRAMES
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as env:
        tmp = Path(tmp)
        env.enter_context(env_set("VSC_TPU_CACHE", str(tmp / "cache")))
        # the children's lines reach the orchestrator as they print them
        env.enter_context(env_set("PYTHONUNBUFFERED", "1"))
        npz, t_write, t_load = write_npz_cache(dev)
        log(f"phase 6: the seeded full-width DepthPro (seed 0) as the npz "
            f"weight cache: {npz.stat().st_size / 2 ** 30:.3f} GiB written "
            f"in {t_write:.2f} s; one load into a bf16 model on the card "
            f"{t_load:.2f} s on {card}")
        free = shutil.disk_usage(tmp).free / 2 ** 30
        check(free > DISK_SPACE_THRESHOLD_GB + 4,
              f"{tmp} has {free:.1f} GiB free: the orchestrator's disk gate "
              f"blocks every launch below {DISK_SPACE_THRESHOLD_GB} GiB, and "
              "the two runs write ~4 GiB")
        log(f"phase 6: {free:.1f} GiB free beside the workflows")

        engine = vscmedia_path()
        skip = set()
        if engine is not None:
            log(f"phase 6: media backend vscmedia ({engine} starts)")
        else:
            skip.add("video_concatenator")
            log("phase 6: media backend cv2: the vscmedia engine does not "
                "start here and cannot be built (no libav)")
            log("phase 6: concat not run: video_concatenator muxes with "
                "vscmedia only (cv2 has no concat or audio)")
            if not cv2_writes_ffv1(tmp / "ffv1_probe.mkv"):
                skip.add("chunk_generator")
                log("phase 6: chunking not run: cv2 cannot open an FFV1 "
                    "writer here and vscmedia does not start")
        clips = [tmp / f"clip{i}{'.mkv' if engine else '.mp4'}"
                 for i in (1, 2)]
        for clip in clips:
            make_test_video(clip, width=1920, height=1080, frames=n,
                            framerate="24/1", with_audio=engine is not None)
        log(f"phase 6: two {n}-frame 1920x1080 clips "
            f"({'vscmedia' if engine else 'cv2 mp4v'}), workflows from "
            "workflow_init.main, video 2 with free_space none; the "
            "orchestrator at its defaults (1 depth, 2 SBS, 1 mutex "
            "process, 5 s tick)")

        with env_set(PROFILE_ENV, str(tmp / "profile")):
            orch, spans, wfs, _ = orchestrate(tmp / "traced", clips, skip,
                                              engine)
        log(f"phase 6: traced run: {len(spans)} children, each exited 0 ("
            + ", ".join(sorted({s['step'] for s in spans}))
            + "); workflows.yaml as JAX's orchestrator writes it")

        # video 2's depth and SBS against in-process calls on its frames
        wf = wfs[1]
        read = np.stack([read_rgb(f) for f in
                         sorted((wf / "frames").glob("frame_*.png"))])
        check(read.shape == (n, 1080, 1920, 3), f"frames {read.shape}")
        got = np.stack([read_depth(f) for f in sorted(
            (wf / "depth_maps").glob("depth_frame_*.png"))])
        fn = depth_map_generator.build_depth_fn(
            "depthpro", 1536, 1080, 1920, False, device=dev, seed=0)
        b = depth_map_generator.DEFAULT_BATCH
        want = []
        for i in range(0, n, b):
            x = read[i:i + b]
            x = np.concatenate([x] + [x[-1:]] * (b - len(x)))
            want.append(fn(torch.from_numpy(x).to(dev))[:n - i].cpu().numpy())
        want = np.concatenate(want)
        del fn
        check(got.shape == want.shape and np.array_equal(got, want),
              f"depth PNGs {got.shape} differ from build_depth_fn")
        sbs_files = sorted((wf / "sbs").glob("sbs_*.png"))
        check(len(sbs_files) == n, f"{len(sbs_files)} SBS frames")
        b = sbs_generator.DEFAULT_BATCH
        for i in range(0, n, b):
            ref = generate_sbs(torch.from_numpy(read[i:i + b]).to(dev),
                               torch.from_numpy(got[i:i + b]).to(dev),
                               StereoParams()).cpu().numpy()
            for f, w in zip(sbs_files[i:i + b], ref):
                check(np.array_equal(read_rgb(f), w),
                      f"{f.name} differs from generate_sbs")
        log(f"phase 6: video 2's depth PNGs equal build_depth_fn (seed 0, "
            f"batches of {depth_map_generator.DEFAULT_BATCH}) and its SBS "
            "PNGs equal generate_sbs on its frames and that depth, bit for "
            f"bit ({n} frames)")
        check(not list((wfs[0] / "frames").glob("*.png")),
              "video 1's frames were not deleted (free_space 'frame')")

        # the chunks and, where concat ran, the output videos
        for w in wfs:
            if "chunk_generator" not in skip:
                log(f"phase 6: {w.name}: " + ", ".join(check_chunks(w, n))
                    + f" decode to {n} frames at 3840x1080")
            if engine is not None:
                out = get_path(w, load_config(w), "output_video")
                check(out.is_file(), f"{out} missing")

        # the kernels each child launched, from its own trace
        counts = trace_kernel_counts(tmp / "profile")
        for step in TRACE_KERNELS:
            runs = sum(1 for s in spans if s["step"] == step)
            traces = counts.get(step, [])
            check(len(traces) == runs == 2,
                  f"{step}: {len(traces)} traces of {runs} runs")
            for path, c in traces:
                check(all(v > 0 for v in c.values()),
                      f"{step} {path.parent.name}: kernels {c}")
            log(f"phase 6: {step} kernel launches, one trace a child: "
                + "; ".join(f"{p.parent.name}: {c}" for p, c in traces))
        log_timeline(orch, spans, "traced run", card)

        # the same again without traces, as a user runs it: the timing
        orch, spans, _, _ = orchestrate(tmp / "untraced", clips, skip,
                                        engine)
        log(f"phase 6: untraced run: {len(spans)} children, each exited 0; "
            "workflows.yaml as JAX's orchestrator writes it")
        log_timeline(orch, spans, "untraced run", card)

def run_peak_gib(fn) -> float:
    """GiB the card allocates over one fn() above what it held before."""
    import torch
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2 ** 30


MESH_SBS_KERNELS = ("blur", "warp", "postprocess", "upsample", "pool",
                    "pyramid", "finish")


def phase_parallel(card: str) -> None:
    """Phase 7: the port's parallel layer on the one card, each mesh naming
    cuda:0 twice: (a) a data mesh, (b) tensor and sequence parallelism,
    (c) the dry run in-process and over two gloo processes, (d) the
    sharding overhead beside the unsharded time."""
    import torch
    from vsc_tpu_torch.models import DepthProConfig, ViTConfig
    from vsc_tpu_torch.models import vit as vit_module
    from vsc_tpu_torch.ops import _cuda
    from vsc_tpu_torch.ops.stereo import StereoParams, generate_sbs
    from vsc_tpu_torch.parallel import dryrun
    from vsc_tpu_torch.parallel.auto import gather, shard_batch
    from vsc_tpu_torch.parallel.mesh import Sharded, make_mesh
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depth_fn
    from vsc_tpu_torch.pipeline.stream_convert import render_sbs
    dev = torch.device("cuda", 0)
    params = StereoParams()
    torch.cuda.empty_cache()
    host = frames_u8(2, dev, 70).cpu().numpy()
    x1 = torch.from_numpy(host).to(dev)
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    fn = build_depth_fn("depthpro", 1536, 1080, 1920, False, device=dev,
                        seed=0)
    w_one = (torch.cuda.memory_allocated() - held) / 2 ** 30
    ref_depth = [fn(x1[i:i + 1]) for i in range(2)]   # batch 1 each
    ref_depth2 = fn(x1)
    _cuda.reset_launches()
    ref_sbs = generate_sbs(x1, torch.cat(ref_depth), params)
    torch.cuda.synchronize()
    l_ref = dict(_cuda.LAUNCHES)
    log(f"phase 7: unsharded full-width DepthPro (seed 0, bf16) built and "
        f"run in {time.perf_counter() - t0:.1f} s; one unsharded SBS call "
        f"on the 2-frame batch launches {l_ref}")

    # (a) a data mesh: cuda:0 named twice, one frame a shard
    mesh = make_mesh(2, 1, devices=[dev, dev])
    held = torch.cuda.memory_allocated()
    fn_dp = build_depth_fn("depthpro", 1536, 1080, 1920, False, seed=0,
                           mesh=mesh)
    w_dp = (torch.cuda.memory_allocated() - held) / 2 ** 30
    xs = shard_batch(host, dev, mesh)
    check(isinstance(xs, Sharded) and [p.device for p in xs.parts]
          == [dev, dev], f"shard_batch placed {xs}")
    _cuda.reset_launches()
    d_dp = fn_dp(xs)
    s_dp = generate_sbs(xs, d_dp, params)
    torch.cuda.synchronize()
    l_dp = dict(_cuda.LAUNCHES)
    log(f"phase 7: (a) data mesh {mesh}: launches of one 2-frame batch "
        f"{l_dp}")
    check(isinstance(d_dp, Sharded) and isinstance(s_dp, Sharded),
          "the data mesh's depth and SBS are not sharded")
    for i in range(2):
        check(torch.equal(d_dp.parts[i], ref_depth[i]),
              f"(a) shard {i}'s depth differs from depth_fn on its frame")
    check(torch.equal(gather(s_dp), ref_sbs.cpu()),
          "(a) sharded SBS differs from the unsharded batch's")
    check(l_dp["attention"] == 2 * 48, f"(a) attention launches {l_dp}")
    check(all(l_ref[k] > 0 and l_dp[k] == 2 * l_ref[k]
              for k in MESH_SBS_KERNELS), f"(a) SBS launches {l_dp} vs "
          f"{l_ref} a call")
    log("phase 7: (a) each shard's u8 depth equals the unsharded depth_fn "
        "on its frame (batch 1) and the SBS equals the unsharded batch's, "
        "bit for bit; qkv attention 48 launches a shard, each SBS kernel "
        "launched once a shard (twice its count in one unsharded call)")

    # (b) tensor + sequence parallel: a (1 data x 2 model) mesh
    mesh_tp = make_mesh(1, 2, devices=[dev, dev])
    cfg_tp = DepthProConfig(img_size=1536, tile_size=384,
                            encoder=ViTConfig(img_size=384, seq_shard=True),
                            use_fov_head=False)
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    fn_tp = build_depth_fn("depthpro", 1536, 1080, 1920, False, seed=0,
                           model_cfg=cfg_tp, mesh=mesh_tp)
    torch.cuda.synchronize()
    w_tp = (torch.cuda.memory_allocated() - held) / 2 ** 30
    log(f"phase 7: (b) TP 2 + seq_shard DepthPro built in "
        f"{time.perf_counter() - t0:.1f} s")
    x_tp = shard_batch(host, dev, mesh_tp)
    check(type(x_tp) is torch.Tensor, "a one-row mesh placed a Sharded batch")
    fn_tp(x_tp)                                           # warm-up
    shapes = set()
    real = vit_module.qkv_attention

    def recording(qkv, heads, scale):
        shapes.add((tuple(qkv.shape), heads))
        return real(qkv, heads, scale)
    vit_module.qkv_attention = recording
    try:
        fn_tp(x_tp)
    finally:
        vit_module.qkv_attention = real
    torch.cuda.synchronize()
    _cuda.reset_launches()
    d_tp = fn_tp(x_tp)
    torch.cuda.synchronize()
    l_tp = dict(_cuda.LAUNCHES)
    log(f"phase 7: (b) launches of one 2-frame batch {l_tp}; qkv kernel "
        f"shapes (qkv, heads): {sorted(shapes)}")
    check(l_tp["attention"] == 96 and l_tp["attention_split"] == 0,
          f"(b) attention launches {l_tp}")
    check(shapes == {((70, 577, 1536), 8), ((2, 577, 1536), 8)},
          f"(b) qkv kernel shapes {shapes}")
    m_tp, t_tp = depth_diff(d_tp, ref_depth2)
    with env_set("VSC_TPU_DEPTH_DTYPE", "float32"):
        fn32 = build_depth_fn("depthpro", 1536, 1080, 1920, False,
                              device=dev, seed=0)
        d32 = fn32(x1)
    del fn32
    m32, t32 = depth_diff(d32, ref_depth2)
    log(f"phase 7: (b) u8 depth, TP 2 + seq_shard vs unsharded bf16: mean "
        f"diff {m_tp:.4f}, max {t_tp} codes; float32 vs bf16 on the same "
        f"frames: mean {m32:.4f}, max {t32} codes")
    check(int(d_tp.max()) > int(d_tp.min()), "(b) depth is constant")
    check(m_tp <= m32 and t_tp <= t32,
          "(b) the sharded depth differs from the unsharded by more than "
          "float32 from bf16")

    # (d) readings: sharding overhead on one card (not a speed-up)
    t_one = time_ms(lambda: render_sbs(x1, fn, params), reps=3)
    t_dp = time_ms(lambda: render_sbs(xs, fn_dp, params), reps=3)
    t_d1 = time_ms(lambda: fn(x1), reps=3)
    t_dtp = time_ms(lambda: fn_tp(x_tp), reps=3)
    run_one = run_peak_gib(lambda: render_sbs(x1, fn, params))
    run_dp = run_peak_gib(lambda: render_sbs(xs, fn_dp, params))
    run_d1 = run_peak_gib(lambda: fn(x1))
    run_tp = run_peak_gib(lambda: fn_tp(x_tp))
    log(f"phase 7: (d) per 2-frame batch on {card}: (a) data mesh depth + "
        f"SBS {t_dp:.1f} ms against unsharded {t_one:.1f} ms "
        f"({t_dp / t_one:.3f}x); (b) TP 2 + seq_shard depth {t_dtp:.1f} ms "
        f"against unsharded {t_d1:.1f} ms ({t_dtp / t_d1:.3f}x)")
    log(f"phase 7: (d) device memory, weights held / a batch's peak above "
        f"them, GiB: unsharded {w_one:.3f} / depth + SBS {run_one:.3f}, "
        f"depth {run_d1:.3f}; (a) {w_dp:.3f} / {run_dp:.3f}; (b) "
        f"{w_tp:.3f} / {run_tp:.3f}. One card named twice: sharding "
        "overhead, not scale-out")
    del fn, fn_dp, fn_tp
    torch.cuda.empty_cache()

    # (c) the dry run, in-process and over two gloo processes
    _cuda.reset_launches()
    line = dryrun.run(8)
    l_dry = dict(_cuda.LAUNCHES)
    log(f"phase 7: (c) in-process: {line}")
    check(line.startswith("dryrun_multichip OK") and "cpu" not in line
          and l_dry["attention"] > 0, f"(c) dry run: {line}, {l_dry}")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vsc_tpu_torch.parallel.dryrun", "8",
         "--processes", "2", "--timeout", "240"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    ok = [ln for ln in proc.stdout.splitlines()
          if ln.startswith("dryrun_multichip OK")]
    check(proc.returncode == 0 and len(ok) == 1 and "cpu" not in ok[0]
          and "over 2 process(es)" in ok[0],
          f"(c) dry run over 2 processes: rc {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    log(f"phase 7: (c) 2 processes over gloo, {time.perf_counter() - t0:.1f}"
        f" s: {ok[0]}")


K4_H, K4_W = 2160, 3840
K4_BATCH = 4            # phase 8: the SBS step's and streaming CLI's default
K4_BATCHES = 2          # phase 8: timed render_sbs batches after a warm-up
K4_STEP_FRAMES = 8      # phase 8: one depth batch of 8, two SBS batches of 4
K4_STRIP = (120, 32)    # phase 8: the tier-1 strip's first row and rows
# phase 8: launches of one 4K batch by kernel at the defaults: W' = 11847
# is odd, so the pools take the torch glue and the split route is refused
K4_LAUNCHES = {"attention": 48, "blur": 1, "upsample": 2, "warp": 1,
               "pyramid": 1, "postprocess": 1, "finish": 1, "pool": 0,
               "bilateral": 0, "deconv": 0, "attention_split": 0,
               "attention_flash": 0}


def phase_4k_main(card: str) -> dict:
    """Phase 8: the main path at 2160 x 3840 and the CLIs' default batches.
    (a) each kernel of the 4K path against its plain version at the B = 4
    shapes, (b) generate_sbs on a batch of 4 equal to the same frames at
    B = 1 bit for bit, (c) the card against the CPU plain path, (d)
    render_sbs with full-width DepthPro timed on batches of 4, (e) the step
    CLIs on 4K PNGs. Returns each kernel's launches a render_sbs batch with
    its row from (a) (merge_ss), and the launches of the timed run."""
    import torch
    from vsc_tpu_torch.ops.stereo import (StereoParams, generate_sbs,
                                          sbs_shapes)
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depth_fn
    from vsc_tpu_torch.pipeline.stream_convert import render_sbs
    dev = torch.device("cuda")
    H, W, B = K4_H, K4_W, K4_BATCH
    params = StereoParams()
    s = sbs_shapes(H, W, params)
    UH, UW = s["up_h"], s["up_w"]
    torch.cuda.empty_cache()

    # (a) the kernels at the B = 4 shapes; the pair passes 2^31 elements
    pair_n = 4 * 2 * B * UH * UW
    masks = [3 * 2 * B * UH * UW + (B + i) * UH * UW for i in range(B)]
    check(pair_n > 2 ** 31, f"the B = {B} pair holds {pair_n} elements")
    log(f"phase 8: (a) the B = {B} pair [4, {2 * B}, {UH}, {UW}] u8 holds "
        f"{pair_n:,} elements ({pair_n / 2 ** 31:.3f} x 2^31); its "
        f"right-eye valid planes start at elements "
        + ", ".join(f"{m:,}" for m in masks))
    rows = merge_ss(phase_ss_kernels(B, H, W, phase=8))
    torch.cuda.empty_cache()
    # the depth model's attention at a batch of 4 (its shapes do not depend
    # on the frame size)
    att = rows["attention"] = attention_check(
        36 * B, torch.Generator(dev).manual_seed(2))
    log(f"phase 8: attention [{36 * B}, 577, 3072] bf16: max_abs_err "
        f"{att['max_abs_err']:.3g} [{att['bound']}], kernel {att['ms']:.3f} "
        f"ms, plain {att['plain_ms']:.3f} ms, sdpa {att['library_ms']:.3f} "
        f"ms, bound {att['bound_ms']:.3f} ms ({att['bound_by']})")

    # (b) batching changes no pixel
    rgb = frames_u8(B, dev, 81, H, W)
    depth = torch.stack([
        (torch.roll(smooth_depth(1, H, W, dev, 82 + i)[0], 480 * i, dims=1)
         * 255).to(torch.uint8) for i in range(B)])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batch = generate_sbs(rgb, depth, params)
    torch.cuda.synchronize()
    peak_sbs = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    check(tuple(batch.shape) == (B, H, 2 * W, 3)
          and batch.dtype == torch.uint8, f"4K SBS {tuple(batch.shape)}")
    order = list(range(B))[::-1]
    for i in order:
        one = generate_sbs(rgb[i:i + 1], depth[i:i + 1], params)
        check(torch.equal(one, batch[i:i + 1]),
              f"(b) frame {i} at B = 1 differs from the batch of {B}: "
              f"{int((one != batch[i:i + 1]).sum())} values")
    log(f"phase 8: (b) generate_sbs on a 4K batch of {B} (frames "
        f"{list(range(B))}) equals the same frames at B = 1, run in the "
        f"order {order}, bit for bit; the batch's peak device memory "
        f"{peak_sbs:.2f} GiB above its inputs")
    del batch

    # (c) the card against the CPU plain path on the strip; the plain path
    # on a whole frame would take minutes on the host (the projection)
    y0, n_rows = K4_STRIP
    cpu_s = sbs_card_vs_cpu(
        rgb[:1, y0:y0 + n_rows].contiguous().cpu(),
        depth[:1, y0:y0 + n_rows].contiguous().cpu(), params, dev,
        f"phase 8: (c) the 4K-geometry strip [1, {n_rows}, {W}] (rows "
        f"{y0}-{y0 + n_rows - 1} of frame 0) card vs CPU plain at the "
        f"defaults")
    log(f"phase 8: (c) the CPU plain path's {cpu_s:.2f} s on {n_rows} rows "
        f"projects to {cpu_s * H / n_rows:.0f} s for a whole frame on this "
        f"host")
    del rgb, depth
    torch.cuda.empty_cache()

    # (d) render_sbs with full-width DepthPro on batches of 4
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    depth_fn = build_depth_fn("depthpro", 1536, H, W, False, device=dev,
                              seed=0)
    torch.cuda.synchronize()
    weights = (torch.cuda.memory_allocated() - held) / 2 ** 30
    log(f"phase 8: (d) full-width DepthPro (seed 0, bf16) at out {H} x {W} "
        f"built in {time.perf_counter() - t0:.1f} s, {weights:.3f} GiB")
    frames = [frames_u8(B, dev, 90 + i, H, W) for i in range(1 + K4_BATCHES)]
    render_sbs(frames[0], depth_fn, params)              # warm-up
    torch.cuda.synchronize()
    outs, batch_s, launches = drive(frames[1:], depth_fn, params)
    per_batch = {k: v // K4_BATCHES for k, v in launches.items()}
    log(f"phase 8: (d) launches over {K4_BATCHES} batches of {B}: "
        f"{launches}; a batch: {per_batch}")
    for o in outs:
        check(tuple(o.shape) == (B, H, 2 * W, 3) and o.dtype == torch.uint8,
              f"4K render_sbs {tuple(o.shape)} {o.dtype}")
    check(launches == {k: n * K4_BATCHES for k, n in K4_LAUNCHES.items()},
          f"4K launches {launches}, expected {K4_LAUNCHES} a batch")
    d = depth_fn(frames[1])
    check(tuple(d.shape) == (B, H, W) and d.dtype == torch.uint8
          and all(int(x.max()) == 255 and int(x.min()) == 0 for x in d),
          "4K depth is not a full-range u8 map a frame")
    t_depth = time_ms(lambda: depth_fn(frames[1]), reps=2)
    t_sbs = time_ms(lambda: generate_sbs(frames[1], d, params), reps=2)
    peak = run_peak_gib(lambda: render_sbs(frames[1], depth_fn, params))
    per_frame = sorted(1e3 * x / B for x in batch_s)
    log(f"phase 8: (d) 4K at the defaults, batches of {B}: depth "
        f"{t_depth / B:.1f} ms/frame, SBS {t_sbs / B:.1f} ms/frame (CUDA "
        f"events), end to end {B * len(batch_s) / sum(batch_s):.3f} fps "
        f"({B * len(batch_s)} frames, host clock; per batch "
        f"{per_frame[0]:.1f} / {per_frame[-1]:.1f} ms/frame min / max); "
        f"peak device memory {peak:.3f} GiB above the {weights:.3f} GiB of "
        f"weights, on {card}")
    log_profile(f"one 4K batch of {B}",
                lambda: render_sbs(frames[-1], depth_fn, params), phase=8)
    del frames, outs, d

    # (e) the step CLIs at their default batches
    phase_4k_steps(card, depth_fn)
    del depth_fn
    torch.cuda.empty_cache()
    return {"kernels": {name: {"launches": n, **rows.get(name, {})}
                        for name, n in per_batch.items()},
            "launches": launches}


def phase_4k_steps(card: str, depth_fn) -> None:
    """Phase 8 (e): the depth and SBS step CLIs' main(argv) at their
    default batches (depth 8, SBS 4) on 8 4K frames written as PNGs: the
    depth PNGs equal depth_fn (full-width DepthPro, seed 0) on the step's
    batches and the SBS PNGs generate_sbs on the frames and the depth read
    back, bit for bit; each step's frames/s and, on a second run, its busy
    share; then a 16-bit pass on 4 frames. frame_extractor runs on a 4K
    clip where the media engine starts."""
    import shutil

    import numpy as np
    import torch
    from vsc_tpu_torch.io.image import read_depth, read_rgb
    from vsc_tpu_torch.ops import _cuda
    from vsc_tpu_torch.pipeline import depth_map_generator, sbs_generator
    dev = torch.device("cuda")
    n = K4_STEP_FRAMES
    nd, ns = depth_map_generator.DEFAULT_BATCH, sbs_generator.DEFAULT_BATCH
    check((nd, ns) == (8, 4), f"the steps' default batches are {nd}, {ns}")
    depth_argv = ["--model", "depthpro", "--no-interactive"]
    sbs_argv = ["--no-interactive"]
    frames = frames_u8(n, dev, 85, K4_H, K4_W).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        video = tmp / "input.mkv"    # workflow_init checks only is_file()
        video.touch()
        wf = new_workflow(tmp / "workflow", video)
        t0 = time.perf_counter()
        write_frames(wf, frames)
        log(f"phase 8: (e) {n} {K4_H} x {K4_W} frames written as PNGs in "
            f"{time.perf_counter() - t0:.2f} s")
        phase_steps_extract(tmp, K4_W, K4_H, phase=8)

        _cuda.reset_launches()
        with pipeline_clock() as clock:
            t_depth, _ = step_main(depth_map_generator,
                                   [str(wf), *depth_argv], "4K depth step")
        l_depth = dict(_cuda.LAUNCHES)
        depth_files = sorted((wf / "depth_maps").glob("depth_frame_*.png"))
        check(len(depth_files) == n, f"{len(depth_files)} 4K depth maps")
        check(l_depth["attention"] == 48 * -(-n // nd),
              f"4K depth step launches {l_depth}")
        read = np.stack([read_rgb(f) for f in
                         sorted((wf / "frames").glob("frame_*.png"))])
        check(np.array_equal(read, frames), "4K frames read back differ")
        want = depth_on_step_batches(depth_fn, read, nd, dev)
        got = np.stack([read_depth(f) for f in depth_files])
        check(got.dtype == np.uint8 and np.array_equal(got, want),
              f"4K depth PNGs differ from build_depth_fn: "
              f"{int((got != want).sum())} pixels")
        log(f"phase 8: (e) depth step ({n} frames, batch {nd}): launches "
            f"{l_depth}; wall {t_depth:.2f} s = {n / t_depth:.2f} frames/s "
            f"around main, pipeline {clock.seconds[0]:.2f} s = "
            f"{n / clock.seconds[0]:.2f} frames/s ({clock.breakdown()}); "
            f"PNGs equal build_depth_fn bit for bit, on {card}")
        shutil.rmtree(wf / "depth_maps")
        log("phase 8: (e) depth step under torch.profiler: "
            + step_busy_share(depth_map_generator, [str(wf), *depth_argv],
                              "profiled 4K depth step") + f" on {card}")
        check(np.array_equal(np.stack([read_depth(f) for f in depth_files]),
                             want), "the profiled 4K depth run differs")

        _cuda.reset_launches()
        with pipeline_clock() as clock:
            t_sbs, _ = step_main(sbs_generator, [str(wf), *sbs_argv],
                                 "4K SBS step")
        l_sbs = dict(_cuda.LAUNCHES)
        check(all(l_sbs[k] == K4_LAUNCHES[k] * (n // ns)
                  for k in SBS_STEP_KERNELS), f"4K SBS step launches {l_sbs}")
        sbs_files = sorted((wf / "sbs").glob("sbs_*.png"))
        check_sbs_files(sbs_files, read, got, ns, dev)
        log(f"phase 8: (e) SBS step ({n} frames, batch {ns}, StereoParams() "
            f"defaults): launches {l_sbs}; wall {t_sbs:.2f} s = "
            f"{n / t_sbs:.2f} frames/s around main, pipeline "
            f"{clock.seconds[0]:.2f} s = {n / clock.seconds[0]:.2f} frames/s "
            f"({clock.breakdown()}); PNGs equal generate_sbs on the frames "
            f"and the depth read back, bit for bit, on {card}")
        shutil.rmtree(wf / "sbs")
        write_frames(wf, frames)
        log("phase 8: (e) SBS step under torch.profiler: "
            + step_busy_share(sbs_generator, [str(wf), *sbs_argv],
                              "profiled 4K SBS step") + f" on {card}")

        sixteen_bit_pass(tmp / "workflow16", video, frames[:ns], depth_argv,
                         sbs_argv, dev, 8)


FOV_BATCH = 2           # phase 9: frames a batch, as phase 3's
FOV_QKV = 72            # phase 9: qkv launches a batch, 24 blocks x 3 ViTs
FOV_F32_ATOL = 1e-3     # phase 9 (b): degrees, the JAX tests' bound vs HF


@contextlib.contextmanager
def plain_attention():
    """The ViTs on the plain attention (``qkv_attention_plain``,
    ``short_seq_attention_plain``) inside the with-block: the yardstick a
    kernel route is held against here, never a route of the program."""
    from vsc_tpu_torch.models import vit
    from vsc_tpu_torch.ops import attention_cuda
    saved = vit.qkv_attention, vit.short_seq_attention
    vit.qkv_attention = attention_cuda.qkv_attention_plain
    vit.short_seq_attention = attention_cuda.short_seq_attention_plain
    try:
        yield
    finally:
        vit.qkv_attention, vit.short_seq_attention = saved


def depth_input(frames):
    """``build_depth_fn``'s head: u8 frames -> the resize to 1536 ->
    ``preprocess_frames``."""
    import torch
    from vsc_tpu_torch.models.depthpro import preprocess_frames
    from vsc_tpu_torch.ops.resize import resize
    x = resize(frames.to(torch.float32), 1536, 1536, "bilinear",
               channel_last=True)
    return preprocess_frames(x)


def quantize_depth(canonical, H: int = 1080, W: int = 1920):
    """``build_depth_fn``'s tail: the resize back, the min-max to u8."""
    import torch
    from vsc_tpu_torch.ops.resize import resize
    d = resize(canonical, H, W, "bilinear")
    lo = d.amin(dim=(1, 2), keepdim=True)
    hi = d.amax(dim=(1, 2), keepdim=True)
    return torch.round((d - lo) / torch.clamp(hi - lo, min=1e-12)
                       * 255.0).to(torch.uint8)


def max_diff(a: dict, b: dict, key: str) -> float:
    return float((a[key] - b[key]).abs().max())


def phase_fov(card: str) -> dict:
    """Phase 9: the JAX package's default DepthPro, the FOV head on (a
    third ViT-L on the quarter-size image), at full width on 1080p batches
    of 2 through the resize and ``preprocess_frames`` of build_depth_fn.
    (a) bf16: fov_deg finite, the canonical depth equal to the head-off
    model's on the same weights, fov_deg and inverse_depth on the kernels
    against the plain attention within the plain path's own bf16-vs-float32
    difference, 72 qkv launches a batch (48 without the head; counters
    and torch.profiler), ms/frame with and without the head, weights and
    peak memory; (b) float32: 72 split-kernel launches, fov_deg within
    1e-3 degrees of the plain path; (c) TP 2 + seq_shard on a (1 x 2)
    mesh naming cuda:0 twice, the head on: fov_deg and the u8 depth within
    the unsharded bf16-vs-float32 difference. Returns the launches of the
    head's path by kernel (bf16 route; float32 for the split kernel)."""
    import re
    import torch
    from vsc_tpu_torch.models import DepthProConfig, ViTConfig
    from vsc_tpu_torch.models.vit import Block
    from vsc_tpu_torch.ops import _cuda
    from vsc_tpu_torch.parallel.mesh import make_mesh
    from vsc_tpu_torch.parallel.sharding import shard_params
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depthpro
    dev = torch.device("cuda")
    B = FOV_BATCH
    torch.cuda.empty_cache()
    frames = frames_u8(B, dev, 90)
    x = depth_input(frames)
    cfg = DepthProConfig()
    check(cfg.use_fov_head and cfg.use_fov_encoder,
          f"DepthProConfig() has the head off: {cfg}")

    def built(**kw):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        m = build_depthpro(1536, dev, seed=0, **kw)
        torch.cuda.synchronize()
        return (m, (torch.cuda.memory_allocated() - held) / 2 ** 30,
                time.perf_counter() - t0)

    def fwd(m, inp=None):
        with torch.inference_mode():
            return m(x if inp is None else inp)

    def counted(m):
        _cuda.reset_launches()
        out = fwd(m)
        torch.cuda.synchronize()
        return out, dict(_cuda.LAUNCHES)

    def qkv_events(m):
        n = profile_device(lambda: fwd(m))["per_kernel_n"]
        return sum(c for k, c in n.items()
                   if re.search(r"qkv_attention_kernel", k))

    on, w_on, t_on = built(cfg=cfg)
    off, w_off, _ = built()                 # the pipeline's: head off
    check(hasattr(on, "fov") and not hasattr(off, "fov"),
          "the head-on / head-off models")
    sd_on = on.state_dict()
    check(all(torch.equal(v, sd_on[k]) for k, v in off.state_dict().items()),
          "the head-off model's seed-0 weights differ from the head-on's")
    log(f"phase 9: full-width DepthPro with the FOV head (seed 0, bf16) "
        f"built in {t_on:.1f} s; weights {w_on:.3f} GiB with the head, "
        f"{w_off:.3f} GiB without (the same seed-0 tensors, equal)")

    # (a) the default bf16 route
    fwd(on), fwd(off)                                   # warm-up
    out, l_on = counted(on)
    ref, l_off = counted(off)
    ref2 = fwd(off)
    fov = out["fov_deg"]
    check(tuple(fov.shape) == (B,) and fov.dtype == torch.float32
          and bool(torch.isfinite(fov).all()), f"fov_deg {fov}")
    can_self = max_diff(ref, ref2, "canonical_inverse_depth")
    can_head = max_diff(out, ref, "canonical_inverse_depth")
    log(f"phase 9: (a) fov_deg {[round(float(v), 4) for v in fov]}; "
        f"canonical depth with the head vs without: max diff {can_head:.3g} "
        f"(two head-off runs: {can_self:.3g})")
    check(can_head <= can_self, "the FOV head changed the canonical depth")
    check(torch.equal(out["inverse_depth"], out["canonical_inverse_depth"]
                      * (2.0 * torch.tan(torch.deg2rad(fov) / 2.0))[:, None,
                                                                    None]),
          "inverse_depth is not canonical * 2 tan(fov / 2)")
    p_on, p_off = qkv_events(on), qkv_events(off)
    log(f"phase 9: (a) launches of one {B}-frame batch with the head "
        f"{l_on}, without {l_off}; qkv kernel events (torch.profiler) "
        f"{p_on} / {p_off}")
    check(l_on["attention"] == p_on == FOV_QKV
          and l_off["attention"] == p_off == 48
          and l_on["attention_split"] == 0, "(a) qkv launches")
    with plain_attention():
        plain = fwd(on)
    with env_set("VSC_TPU_DEPTH_DTYPE", "float32"):
        on32, w32, _ = built(cfg=cfg)
    with plain_attention():
        plain32 = fwd(on32)
    dk = {k: max_diff(out, plain, k) for k in ("fov_deg", "inverse_depth")}
    dp = {k: max_diff(plain, plain32, k) for k in dk}
    log("phase 9: (a) kernels vs plain attention (bf16) / plain bf16 vs "
        "plain float32, max abs: " + "; ".join(
            f"{k} {dk[k]:.4g} / {dp[k]:.4g}" for k in dk))
    check(all(dk[k] <= dp[k] for k in dk),
          "(a) the kernel route differs from the plain attention by more "
          "than bf16 from float32")
    t_with = time_ms(lambda: quantize_depth(fwd(on, depth_input(frames))[
        "canonical_inverse_depth"]), reps=3)
    t_without = time_ms(lambda: quantize_depth(fwd(off, depth_input(frames))[
        "canonical_inverse_depth"]), reps=3)
    peak_on = run_peak_gib(lambda: fwd(on))
    peak_off = run_peak_gib(lambda: fwd(off))
    log(f"phase 9: (a) depth (frames -> u8, build_depth_fn's work) "
        f"{t_with / B:.2f} ms/frame with the head, {t_without / B:.2f} "
        f"without (+{(t_with - t_without) / B:.2f}, "
        f"{100 * (t_with / t_without - 1):.1f} %); weights {w_on:.3f} / "
        f"{w_off:.3f} GiB; a batch's peak above them {peak_on:.3f} / "
        f"{peak_off:.3f} GiB; on {card}")
    log_profile(f"one {B}-frame batch with the FOV head", lambda: fwd(on),
                phase=9)
    del off

    # (b) float32: the split-q/k/v kernel
    fwd(on32)
    out32, l32 = counted(on32)
    d32 = max_diff(out32, plain32, "fov_deg")
    log(f"phase 9: (b) float32 ({w32:.3f} GiB): launches of one batch "
        f"{l32}; split attention by route {_cuda.ROUTE_LAUNCHES}; fov_deg "
        f"kernel vs plain max diff {d32:.3g} (bound {FOV_F32_ATOL}); "
        f"inverse_depth {max_diff(out32, plain32, 'inverse_depth'):.3g}")
    check(l32["attention_split"] == FOV_QKV and l32["attention"] == 0,
          "(b) split attention launches")
    check(d32 <= FOV_F32_ATOL, "(b) float32 fov_deg vs the plain path")
    del on32, plain, plain32

    # (c) TP 2 + seq_shard with the head on
    mesh = make_mesh(1, 2, devices=[dev, dev])
    tp_model, _, _ = built(cfg=DepthProConfig(
        encoder=ViTConfig(seq_shard=True)))
    rep = shard_params(tp_model, mesh)[0]
    del tp_model
    ranked = [n for n, m in rep.named_modules()
              if isinstance(m, Block) and m.ranks is not None]
    check(len(ranked) == 72 and sum(n.startswith("fov.") for n in ranked)
          == 24, f"(c) {len(ranked)} blocks with ranks")
    fwd(rep)                                              # warm-up
    tp, l_tp = counted(rep)
    d_tp = max_diff(tp, out, "fov_deg")
    d_fp = max_diff(out32, out, "fov_deg")
    q = quantize_depth(out["canonical_inverse_depth"])
    m_tp, t_tp = depth_diff(quantize_depth(tp["canonical_inverse_depth"]), q)
    m32, t32 = depth_diff(quantize_depth(out32["canonical_inverse_depth"]), q)
    log(f"phase 9: (c) TP 2 + seq_shard: launches of one batch {l_tp}; "
        f"fov_deg vs unsharded bf16 max diff {d_tp:.4g} (float32 vs bf16: "
        f"{d_fp:.4g}); u8 depth mean {m_tp:.4f}, max {t_tp} codes (float32 "
        f"vs bf16: {m32:.4f}, {t32})")
    check(l_tp["attention"] == 2 * FOV_QKV, "(c) qkv launches")
    check(d_tp <= d_fp and m_tp <= m32 and t_tp <= t32,
          "(c) the sharded model differs from the unsharded by more than "
          "float32 from bf16")
    del rep, on
    torch.cuda.empty_cache()
    return {"attention": l_on["attention"],
            "attention_split": l32["attention_split"]}


BENCH_TIMEOUT = 900.0   # phase 10: one bench run's limit, seconds
BENCH_BATCH = 8         # phase 10: the bench's default batch


def bench_batch_kernels() -> dict:
    """Phase 10 (a): each kernel of the bench's path against its plain
    version at the bench's batch-8 shapes (the SBS pair [4, 16, 3240,
    6090], the qkv attention [288, 577, 3072]), and the bench's SBS bound,
    ``utils/flops.sbs_least_time``, against these kernels' own bounds on
    the real tensors: equal for every kernel but the postprocess, whose
    bound here adds the fill and polish of this run's hole pixels. Returns
    a row per launch counter (merge_ss)."""
    import torch
    from vsc_tpu_torch.utils.flops import sbs_least_time
    B = BENCH_BATCH
    ss = phase_ss_kernels(B, phase=10)
    rows = merge_ss(ss)
    torch.cuda.empty_cache()
    att = rows["attention"] = attention_check(
        36 * B, torch.Generator(torch.device("cuda")).manual_seed(3))
    log(f"phase 10: (a) attention [{36 * B}, 577, 3072] bf16: max_abs_err "
        f"{att['max_abs_err']:.3g} [{att['bound']}], kernel {att['ms']:.3f} "
        f"ms, plain {att['plain_ms']:.3f} ms, sdpa {att['library_ms']:.3f} "
        f"ms, bound {att['bound_ms']:.3f} ms ({att['bound_by']})")
    model = sbs_least_time(1080, 1920)["stages"]
    for name, r in ss.items():
        if name not in model:       # the split route's bilateral
            continue
        want = B * model[name]["ms"]
        ok = (want <= r["bound_ms"] * (1 + 1e-9) if name == "postprocess"
              else abs(want - r["bound_ms"]) <= 1e-9 * r["bound_ms"])
        check(ok, f"sbs_least_time's {name} stage: {want} ms a batch of "
                  f"{B}, the kernel's bound {r['bound_ms']} ms")
    log(f"phase 10: (a) sbs_least_time's kernel stages equal the kernels' "
        f"bounds on the batch-{B} tensors (the postprocess's "
        f"{B * model['postprocess']['ms']:.4f} ms without the hole work, "
        f"{ss['postprocess']['bound_ms']:.4f} ms with it)")
    del ss
    torch.cuda.empty_cache()
    return rows


def check_bench_line(line: dict, media: bool, extras: bool = True,
                     full: bool = True) -> None:
    """Phase 10's rule for a line of ``python -m vsc_tpu_torch.bench``: the
    quality gate passed on every SSIM point with no measurement error, a
    positive fps, with ``full`` (the DepthPro run) the MFU and with
    ``extras`` the roofline share in (0, 100], and the media readings
    skipped exactly when the media engine does not start (``media``)."""
    from vsc_tpu_torch.bench import MEDIA_KEYS, NO_MEDIA, SSIM_GATE
    d = line["detail"]
    check(d["quality_gate"] == "PASS", f"bench quality gate "
          f"{d['quality_gate']}")
    for err in ("ssim_error", "extras_error"):
        check(err not in d, f"bench {err}: {d.get(err)}")
    ssims = {k: v for k, v in d.items() if k.startswith("ssim_")}
    check(len(ssims) == 3 and all(v >= SSIM_GATE for v in ssims.values()),
          f"bench SSIM points {ssims}")
    check(line["value"] > 0, f"bench fps {line['value']}")
    if full:
        mfu = d["depth_mfu_pct"]
        check(mfu is not None and 0 < mfu <= 100, f"bench depth MFU {mfu}")
    if extras:
        att = d["sbs_roofline_attained_pct"]
        check(0 < att <= 100, f"bench SBS roofline share {att}")
        for key in MEDIA_KEYS:
            check((d[key] == NO_MEDIA) != media,
                  f"bench {key} = {d[key]!r} with the media engine "
                  f"{'starting' if media else 'not starting'}")


def run_bench(what: str, env: dict) -> tuple[dict, dict]:
    """``python -m vsc_tpu_torch.bench`` as a child process with ``env``
    over this environment less its BENCH_* knobs; its line and the kernel
    launches of its timed iterations, after logging both, the run's
    seconds and the oracle frames it computed."""
    env = {**{k: v for k, v in os.environ.items()
              if not k.startswith("BENCH_")}, **env}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "vsc_tpu_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"bench ({what}) exited "
          f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    oracle = [ln for ln in proc.stderr.splitlines()
              if ln.startswith("bench: oracle")]
    counted = [ln for ln in proc.stderr.splitlines()
               if ln.startswith("bench: kernel launches")]
    check(len(counted) == 1, f"bench ({what}) printed no launch counts")
    launches = json.loads(counted[0][counted[0].index("{"):])
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"phase 10: bench ({what}) in {secs:.1f} s; "
        + ("; ".join(oracle) or "every oracle frame from the disk cache"))
    log(f"phase 10: bench line ({what}): {json.dumps(line)}")
    log(f"phase 10: launches over its {line['detail']['iters']} timed "
        f"iterations: {launches}")
    return line, launches


def check_bench_launches(launches: dict, iters: int, full: bool) -> None:
    """Every default-path SBS kernel launched each timed iteration, the
    qkv attention 48 times an iteration (24 blocks x 2 ViTs) with
    DepthPro and not with the stub, and no opt-in route's kernel."""
    for name, n in launches.items():
        if name in SBS_STEP_KERNELS:
            check(n > 0 and n % iters == 0, f"bench {name} launches {n}")
        elif name == "attention":
            check(n == (48 * iters if full else 0),
                  f"bench attention launches {n}")
        else:
            check(n == 0, f"bench {name} launches {n} off its route")


def phase_bench(card: str) -> dict:
    """Phase 10: (a) bench_batch_kernels, (b) the bench as a child, at its
    defaults and on the stub depth. Returns (a)'s rows and the launches of
    the default run's timed iterations."""
    import gc
    import torch
    from vsc_tpu_torch.native import vscmedia_path
    from vsc_tpu_torch.utils.flops import (HBM_BYTES_S, PEAK_OPS_S,
                                           sbs_roofline)
    rows = bench_batch_kernels()
    # the child needs the card's memory that this process holds cached
    gc.collect()
    torch.cuda.empty_cache()
    media = vscmedia_path() is not None
    log(f"phase 10: {card}; media engine "
        f"{'starts' if media else 'does not start (no libav)'}; this "
        f"process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_oracle_") as cache:
        full, launches = run_bench("defaults: full, batch 8, iters 8",
                                   {"VSC_TPU_ORACLE_CACHE": cache})
        check_bench_line(full, media)
        check_bench_launches(launches, full["detail"]["iters"], True)
        stub, l_stub = run_bench("BENCH_DEPTH=stub BENCH_EXTRAS=0",
                                 {"VSC_TPU_ORACLE_CACHE": cache,
                                  "BENCH_DEPTH": "stub", "BENCH_EXTRAS": "0"})
        check_bench_line(stub, media, extras=False, full=False)
        check_bench_launches(l_stub, stub["detail"]["iters"], False)
    d, s = full["detail"], stub["detail"]
    log(f"phase 10: {card}: {full['value']} frames/s, depth "
        f"{d['depth_ms_per_frame']} ms/frame at {d['depth_mfu_pct']} % of "
        f"{PEAK_OPS_S['bf16_tensor'] / 1e12:.0f} TFLOP/s bf16; SBS "
        f"{d['sbs_ms_per_frame']} ms/frame (stub run: "
        f"{s['sbs_ms_per_frame']}), bound (sbs_least_time) "
        f"{d['sbs_roofline_ms']} ms ({HBM_BYTES_S / 1e12} TB/s, "
        f"{PEAK_OPS_S['f32'] / 1e12:.0f} TFLOP/s f32), attained "
        f"{d['sbs_roofline_attained_pct']} % (the JAX package's f32 stage "
        f"model on the card's rates: {sbs_roofline(1080, 1920)['ms']} ms); "
        f"worst case "
        f"{d['sbs_worstcase_noise_depth_ms_per_frame']} ms/frame; SSIM "
        + ", ".join(f"{k} {v}" for k, v in d.items()
                    if k.startswith("ssim_")))
    return {"kernels": rows, "launches": launches}


def dispatch_thread_cost(step, batches) -> tuple[float, float, float]:
    """Median ms of step(batch) over ``batches``, with its result in host
    memory: on this thread, on the CLI's dispatch thread
    (``parallel/health.run_with_deadline``, one thread kept across calls)
    and on a fresh thread each, which rebuilds its per-thread state."""
    import threading
    from vsc_tpu_torch.parallel.health import run_with_deadline

    def median_ms(call):
        ts = []
        for b in batches:
            t0 = time.perf_counter()
            call(b)
            ts.append(1e3 * (time.perf_counter() - t0))
        return sorted(ts)[len(ts) // 2]

    def fresh(b):
        t = threading.Thread(target=step, args=(b,))
        t.start()
        t.join()
    return (median_ms(step),
            median_ms(lambda b: run_with_deadline(lambda: step(b), 120.0)),
            median_ms(fresh))


def phase_dav2(card: str) -> dict:
    """Phase 11: Depth Anything V2 Large (seed 0, bf16) on the
    convert path as the streaming CLI runs it: ``build_depth_fn`` on
    ``data_mesh`` of the card (none on a one-card machine), 1080p batches
    of ``DAV2_BATCH`` through ``shard_batch``, ``render_sbs`` at
    ``StereoParams()`` and ``gather``. Counters reset just before the
    first counted batch and read just after: 24 flash launches a batch
    (one a ViT block over the batch's 2,443-token rows) and no qkv or
    split-kernel launch; every default SBS kernel. The model on a (1 x 1)
    ``parallel/mesh`` data mesh of the card, given a ``Sharded`` batch,
    returns a ``Sharded`` u8 depth equal to the CLI path's on the same
    frames, bit for bit. Times: depth and SBS ms a frame (CUDA events),
    a batch end to end (host clock) on the main thread, on the CLI's
    dispatch thread and on a fresh thread each, all again with cuDNN off;
    peak memory; one torch.profiler pass. Returns the launches of one
    batch by kernel."""
    import torch
    from vsc_tpu_torch.ops import _cuda
    from vsc_tpu_torch.ops.stereo import StereoParams, generate_sbs
    from vsc_tpu_torch.parallel.auto import data_mesh, gather, shard_batch
    from vsc_tpu_torch.parallel.mesh import Sharded, make_mesh
    from vsc_tpu_torch.pipeline.depth_map_generator import (DAV2,
                                                            build_depth_fn)
    from vsc_tpu_torch.pipeline.stream_convert import render_sbs
    dev = torch.device("cuda")
    B = DAV2_BATCH
    torch.cuda.empty_cache()
    mesh = data_mesh(dev)
    one = make_mesh(data=1, devices=[dev])
    t0 = time.perf_counter()
    fn = build_depth_fn(DAV2, None, 1080, 1920, False, device=dev,
                        mesh=mesh, seed=0)
    mesh_fn = build_depth_fn(DAV2, None, 1080, 1920, False, mesh=one,
                             seed=0)
    torch.cuda.synchronize()
    log(f"phase 11: Depth Anything V2 Large (seed 0, bf16) built twice in "
        f"{time.perf_counter() - t0:.1f} s: the CLI's (data mesh "
        f"{None if mesh is None else dict(mesh.shape)}) and on a "
        f"{dict(one.shape)} mesh")
    params = StereoParams()
    host = [frames_u8(B, dev, 110 + i).cpu().numpy()
            for i in range(DAV2_BATCHES)]

    def step(frames):
        return gather(render_sbs(shard_batch(frames, dev, mesh), fn, params))

    step(host[0])                                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    out = step(host[0])
    launches, routes = dict(_cuda.LAUNCHES), dict(_cuda.ROUTE_LAUNCHES)
    log(f"phase 11: launches of one batch of {B}: {launches}; attention "
        f"by route: {routes}")
    check(launches["attention_flash"] == 24 and routes["flash"] == 24
          and launches["attention"] == 0
          and launches["attention_split"] == 0
          and routes["split"] == routes["split_two_pass"] == 0,
          f"Depth Anything V2 attention launches {launches} {routes}")
    check(all(launches[k] > 0 for k in SBS_STEP_KERNELS),
          f"Depth Anything V2 SBS launches {launches}")
    check(tuple(out.shape) == (B, 1080, 3840, 3) and out.dtype == torch.uint8
          and float(out.float().std()) > 1.0, f"SBS {tuple(out.shape)}")
    x = torch.from_numpy(host[1]).to(dev)
    sharded = mesh_fn(Sharded((x,), one))
    check(isinstance(sharded, Sharded), f"mesh depth {type(sharded)}")
    d_mesh = gather(sharded)
    d_plain = gather(fn(shard_batch(host[1], dev, mesh)))
    check(torch.equal(d_mesh, d_plain),
          "the data mesh's depth differs from the CLI path's")
    check(int(d_plain.max()) > int(d_plain.min()), "the depth is constant")
    del mesh_fn, sharded
    batch_s = []
    for frames in host:
        t0 = time.perf_counter()
        step(frames)
        batch_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the streaming CLI runs each batch on its dispatch thread
    # (parallel/health.run_with_deadline); a fresh thread a batch rebuilds
    # per-thread state, which cuDNN off (the convolutions on ATen's own
    # kernels) tells apart
    thread_ms = dispatch_thread_cost(step, host)
    with torch.backends.cudnn.flags(enabled=False):
        step(host[0])                                     # warm-up
        no_cudnn_ms = dispatch_thread_cost(step, host)
    log(f"phase 11: a batch, median of {len(host)}, on the main thread / "
        f"the dispatch thread / a fresh thread each: "
        + " / ".join(f"{t:.1f}" for t in thread_ms) + " ms; cuDNN off: "
        + " / ".join(f"{t:.1f}" for t in no_cudnn_ms) + " ms")
    t_depth = time_ms(lambda: fn(x), reps=3)
    depth = d_plain.to(dev)
    t_sbs = time_ms(lambda: generate_sbs(x, depth, params), reps=5)
    med = sorted(batch_s)[len(batch_s) // 2]
    log(f"phase 11: depth {t_depth / B:.2f} ms/frame, SBS {t_sbs / B:.2f} "
        f"ms/frame (CUDA events); a batch end to end {1e3 * med:.1f} ms "
        f"median of {len(batch_s)} ({B / med:.2f} frames/s, host clock, "
        f"main thread); peak device memory {peak:.2f} GiB, on {card}")
    log_profile(f"one Depth Anything V2 batch of {B}",
                lambda: step(host[-1]), group=r"flash_attention_kernel",
                phase=11)
    del fn, x, d_mesh, d_plain, depth
    torch.cuda.empty_cache()
    return {k: n for k, n in launches.items() if n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11")
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
    # the depth CLI's checkpoint resolution may reach for the hub; this
    # machine has none to reach
    os.environ["HF_HUB_OFFLINE"] = "1"
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
    step = phase_steps(card) if 5 in phases else {}
    if 6 in phases:
        phase_orchestrator(card)
    if 7 in phases:
        phase_parallel(card)
    k4 = phase_4k_main(card) if 8 in phases else {}
    fov = phase_fov(card) if 9 in phases else {}
    bench = phase_bench(card) if 10 in phases else {}
    dav2 = phase_dav2(card) if 11 in phases else {}
    # where phase 3 ran not: the step path's, else the 4K path's, else the
    # FOV head's, else the bench's
    for name, n in {**bench.get("launches", {}), **fov,
                    **k4.get("launches", {}),
                    **step}.items():
        launches.setdefault(name, n)
    check(not any(m.split(".")[0] in ("jax", "flax", "vsc_tpu")
                  for m in sys.modules),
          "the port pulled in jax or the JAX package")

    line = {"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": launches.get(name, 0),
         "step_launches": step.get(name, 0),
         **{k: kern.get(name, {}).get(k)
            for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                      "bound_by", "library_ms")},
         "at_4k": k4.get("kernels", {}).get(name),
         "fov_launches": fov.get(name, 0),
         "bench_launches": bench.get("launches", {}).get(name, 0),
         "at_bench_batch": bench.get("kernels", {}).get(name),
         "dav2_launches": dav2.get(name, 0)}
        for name, route, src, rep in KERNELS]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
