"""
Benchmark harness of the port
=============================

Port of the JAX package's ``bench.py`` (the repository root's) onto the
card: measures **1080p frames/sec end to end (depth + SBS)** and prints ONE
JSON line with that bench's keys::

  {"metric": ..., "value": N, "unit": "frames/sec", "vs_baseline": N,
   "detail": {"quality_gate", "device", "batch", "iters", "depth_model",
              "depth_ms_per_frame", "sbs_ms_per_frame", "depth_mfu_pct",
              "stereo_params", "content", "ssim_*", extras...}}

    python -m vsc_tpu_torch.bench

Workload per frame, as the JAX bench's:
  depth: the depth step's ``build_depth_fn``: resize 1920x1080 -> model
         input, DepthPro forward (bf16, weights from seed 0), resize back,
         min-max normalize, quantize to u8
  sbs:   ``ops/stereo.generate_sbs`` at ``StereoParams()`` (disparity 50,
         super_sampling 3, bilateral smoothing, inpaint, sharpen 14) -> u8
         side-by-side frames, on ``bench_content``'s scene-like depth

Each stage is timed on the host clock around ``iters`` calls after a
warm-up, closed by ``torch.cuda.synchronize()``. ``depth_mfu_pct`` divides
``utils/flops.depthpro_flops`` by the card's dense bf16 peak;
``sbs_roofline_ms`` is ``utils/flops.sbs_least_time``, the least time of
the port's SBS path on the card's memory and f32 rates (each kernel's and
glue stage's u8 and f32 tensors read and written once), and
``sbs_roofline_attained_pct`` the SBS time's share of it. The quality gate
holds the SBS frames of the timed program against ``utils/oracle``
(torch/cv2 reference semantics) by SSIM: every point must reach 0.99, and
every frame of the timed batch must equal the first (the frames are copies
of one), or ``vs_baseline`` reads 0.

Env knobs (the JAX bench's, less its 384-input ``flagship`` depth):
  BENCH_DEPTH=full|stub            full: the production 1536-input ViT-L
                                   DepthPro, FOV head off (default);
                                   stub: luminance
  BENCH_BATCH=N                    frames per dispatch (default 8, as the
                                   JAX bench's code; its docstring says 2)
  BENCH_ITERS=N                    timed iterations (default 8)
  BENCH_EXTRAS=0                   skip the secondary measurements
  BENCH_SSIM=0                     skip the SSIM gate (gate SKIPPED,
                                   vs_baseline 0)
  VSC_TPU_ORACLE_CACHE=DIR         the oracle frames' disk cache (default
                                   ~/.cache/vsc_tpu_oracle)

Without a card it prints the zero line (``value`` 0, ``detail.error``) and
exits 1: it never measures the CPU. The media readings of the extras need
the media engine (vscmedia); where it does not start they read
``"skipped: no media engine"`` and the rest of the extras run on the
synthetic frames.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, NamedTuple

METRIC = "1080p frames/sec/chip end-to-end (depth+SBS)"
REFERENCE_FLOOR_FPS = 0.95  # the JAX bench's documented estimate
SSIM_GATE = 0.99
NO_MEDIA = "skipped: no media engine"
MEDIA_KEYS = ("decoded_video", "stream_convert_fps_stub_depth_x265ultrafast")


def bench_content(H: int, W: int):
    """Deterministic synthetic content with real-video statistics (smooth
    regions + edges + fine texture) rather than uniform noise: noise makes
    EVERY pixel a depth discontinuity, so the postprocess kernel's
    per-tile hole path never skips and the SBS time measures a worst case
    no actual video exhibits.

    The depth map is the one the SBS stage is TIMED on: smooth scene-like
    structure (depth plane + blocks). The depth stage times the model on
    the frames; its output is NOT used for SBS because random-init weights
    produce noise depth, which turns every pixel into a disocclusion.

    Returns (frame [H, W, 3] u8, depth [H, W] u8), equal to the JAX
    bench's."""
    import numpy as np

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 0.5 + 0.5 * np.sin(xx / 97.0) * np.cos(yy / 53.0)
    blocks = ((xx // 240).astype(int) % 3 == (yy // 135).astype(int) % 3)
    tex = rng.normal(0, 0.04, (H, W)).astype(np.float32)
    plane = np.clip(base * 0.6 + blocks * 0.3 + tex, 0, 1)
    frame = np.stack([plane, 0.8 * plane + 0.1, 1.0 - 0.7 * plane], -1)
    frame = (frame * 255).astype(np.uint8)
    d = 0.45 + 0.35 * np.sin(xx / 311.0) * np.cos(yy / 173.0) + blocks * 0.15
    depth = (np.clip(d, 0, 1) * 255).astype(np.uint8)
    return frame, depth


class Workload(NamedTuple):
    frames: object          # [B, H, W, 3] u8 on the device
    depth_sbs: object       # [B, H, W] u8: the depth SBS is timed on
    run_depth: Callable     # u8 frames -> u8 depth
    run_sbs: Callable       # (u8 frames, u8 depth) -> u8 SBS
    batch: int


def build_workload(*, height: int = 1080, width: int = 1920,
                   device=None) -> Workload:
    """The JAX bench's workload on ``device`` (None: the card, or an
    error), BENCH_BATCH frames. BENCH_DEPTH=full is the depth step's
    ``build_depth_fn`` on DepthPro with its FOV head off (the output is
    min-max normalized, so the metric branch cannot change the depth map),
    in bf16 on the card, weights from seed 0; stub is the luminance depth
    with no resize, as the JAX bench's."""
    import numpy as np
    import torch

    from vsc_tpu_torch import default_device
    from vsc_tpu_torch.config import StereoParams
    from vsc_tpu_torch.ops.stereo import generate_sbs

    device = default_device() if device is None else torch.device(device)
    H, W = height, width
    kind = os.environ.get("BENCH_DEPTH", "full")
    batch = int(os.environ.get("BENCH_BATCH", "8"))

    frame, depth_real = bench_content(H, W)
    frames = torch.from_numpy(
        np.broadcast_to(frame, (batch, H, W, 3)).copy()).to(device)
    depth_sbs = torch.from_numpy(
        np.broadcast_to(depth_real, (batch, H, W)).copy()).to(device)

    if kind == "full":
        from vsc_tpu_torch.models import DepthProConfig
        from vsc_tpu_torch.pipeline.depth_map_generator import build_depth_fn
        cfg = DepthProConfig(use_fov_head=False)
        run_depth = build_depth_fn("depthpro", cfg.img_size, H, W, False,
                                   device=device, model_cfg=cfg, seed=0)
    elif kind == "stub":
        from vsc_tpu_torch.models.stub import luminance_depth

        @torch.inference_mode()
        def run_depth(frames_u8):
            return torch.round(luminance_depth(
                frames_u8.to(torch.float32) / 127.5 - 1.0) * 255.0
            ).to(torch.uint8)
    else:
        raise ValueError(f"BENCH_DEPTH must be full or stub, got {kind!r}")

    sbs_params = StereoParams()  # reference defaults incl. supersampling 3

    @torch.inference_mode()
    def run_sbs(frames_u8, depth_u8):
        return generate_sbs(frames_u8, depth_u8, sbs_params)

    return Workload(frames, depth_sbs, run_depth, run_sbs, batch)


def device_sync(device) -> Callable[[], None]:
    """A barrier that returns once ``device`` has done its queued work."""
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def timed(fn, iters: int, sync) -> tuple[float, object]:
    """Host seconds of ``iters`` calls of ``fn()`` up to ``sync()``, and
    the last call's result."""
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    sync()
    return time.perf_counter() - t0, out


def quality_gate(extras: dict, ssim_on: bool) -> str:
    """SKIPPED without the SSIM measurement; FAIL on a measurement error
    (a broken oracle path must not launder a broken kernel) or no point;
    else PASS when every ``ssim_*`` point reaches SSIM_GATE."""
    ssims = [v for k, v in extras.items() if k.startswith("ssim_")
             and isinstance(v, (int, float))]
    if not ssim_on:
        return "SKIPPED"
    if "ssim_error" in extras or not ssims:
        return "FAIL"
    return "PASS" if min(ssims) >= SSIM_GATE else "FAIL"


def zero_line(error: str) -> dict:
    """The line of a run that could not measure: value 0 and the reason."""
    return {"metric": METRIC, "value": 0.0, "unit": "frames/sec",
            "vs_baseline": 0.0, "detail": {"error": error}}


def device_name(device) -> str:
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return f"{device} {torch.cuda.get_device_name(device)}"
    return str(device)


def measure(w: Workload, iters: int, *, ssim: bool = True,
            extras: bool = True, depth_model: str = "full") -> dict:
    """Times the workload ``w`` and returns the bench line. Runs on the
    frames' device; ``main`` gives it the card's. The kernels' launch
    counts over the timed iterations go to stderr."""
    from vsc_tpu_torch.models import DepthProConfig
    from vsc_tpu_torch.ops import _cuda
    from vsc_tpu_torch.utils.flops import PEAK_OPS_S, depthpro_flops

    frames, depth_sbs, run_depth, run_sbs, batch = w
    sync = device_sync(frames.device)

    # warm-up: the kernels' first launches, cuDNN's algorithm choice
    run_depth(frames)
    sbs = run_sbs(frames, depth_sbs)
    sync()
    _cuda.reset_launches()
    t_depth, _ = timed(lambda: run_depth(frames), iters, sync)
    t_sbs, sbs = timed(lambda: run_sbs(frames, depth_sbs), iters, sync)
    print("bench: kernel launches over the timed iterations "
          + json.dumps(_cuda.LAUNCHES), file=sys.stderr, flush=True)
    n = iters * batch
    fps = n / (t_depth + t_sbs)

    out = {}
    if ssim:
        try:
            out["ssim_vs_oracle"] = measure_ssim(frames, depth_sbs, sbs)
            out.update(measure_ssim_extra(frames))
        except Exception as e:  # the line carries it; the gate fails
            out["ssim_error"] = f"{type(e).__name__}: {e}"
    if extras:
        out.update(measure_extras(frames, run_depth, run_sbs, batch,
                                  max(iters // 2, 2), sync,
                                  t_depth / n, t_sbs / n))
    mfu = None
    if depth_model == "full":
        flops = depthpro_flops(DepthProConfig(use_fov_head=False), 1)
        mfu = round(100.0 * flops
                    / ((t_depth / n) * PEAK_OPS_S["bf16_tensor"]), 1)
    gate = quality_gate(out, ssim)
    return {
        "metric": METRIC,
        "value": round(fps, 3),
        "unit": "frames/sec",
        "vs_baseline": (round(fps / REFERENCE_FLOOR_FPS, 2)
                        if gate == "PASS" else 0.0),
        "detail": {
            "quality_gate": gate,
            "device": device_name(frames.device),
            "batch": batch,
            "iters": iters,
            "depth_model": depth_model,
            "depth_ms_per_frame": round(1000.0 * t_depth / n, 1),
            "sbs_ms_per_frame": round(1000.0 * t_sbs / n, 1),
            "depth_mfu_pct": mfu,
            "stereo_params": "reference defaults",
            "content": "synthetic-realistic frames + scene-like depth "
                       "(smooth+edges+texture)",
            **out,
        },
    }


def _first_dispatch(device) -> None:
    import torch
    x = torch.ones((128, 128), device=device) * 2 + 1
    if abs(float(x[0, 0]) - 3.0) > 1e-6:
        raise RuntimeError("the first dispatch computed a wrong value")


def main() -> int:
    from vsc_tpu_torch import cli_device
    from vsc_tpu_torch.parallel.health import run_with_deadline

    try:
        device = cli_device()
    except RuntimeError as e:
        print(json.dumps(zero_line(str(e))), flush=True)
        return 1
    try:
        run_with_deadline(lambda: _first_dispatch(device), 900.0)
    except TimeoutError:
        print(json.dumps(zero_line("device unreachable: the in-process "
                                   "first dispatch hung")), flush=True)
        return 1

    w = build_workload(device=device)
    line = measure(w, int(os.environ.get("BENCH_ITERS", "8")),
                   ssim=os.environ.get("BENCH_SSIM", "1") != "0",
                   extras=os.environ.get("BENCH_EXTRAS", "1") != "0",
                   depth_model=os.environ.get("BENCH_DEPTH", "full"))
    print(json.dumps(line), flush=True)
    return 0


def oracle_sbs(frame, depth, params):
    """Reference-semantics oracle SBS frame (``utils/oracle``: Lanczos
    pre-stretch, depth-sorted splat, cv2 bilateral + Telea inpaint),
    cached on disk by content. The cache key hashes the oracle's source
    alongside content and params, so an oracle edit never serves a stale
    ground truth. A frame computed here is logged on stderr with its
    time."""
    import hashlib
    from pathlib import Path

    import numpy as np

    from vsc_tpu_torch.utils import oracle
    src_hash = hashlib.sha256(
        Path(oracle.__file__).read_bytes()).hexdigest()[:16]
    key = hashlib.sha256(frame.tobytes() + depth.tobytes()
                         + repr(params).encode()
                         + f"|oracle-src-{src_hash}".encode()).hexdigest()
    cache = Path(os.environ.get(
        "VSC_TPU_ORACLE_CACHE",
        str(Path.home() / ".cache" / "vsc_tpu_oracle")))
    cache.mkdir(parents=True, exist_ok=True)
    ref_file = cache / f"{key}.npy"
    if ref_file.exists():
        return np.load(ref_file)
    t0 = time.perf_counter()
    ref = oracle.process_frame(frame, depth, params)
    np.save(ref_file, ref)
    print(f"bench: oracle frame {frame.shape[1]}x{frame.shape[0]} "
          f"computed in {time.perf_counter() - t0:.1f} s ({params})",
          file=sys.stderr, flush=True)
    return ref


def measure_ssim(frames, depth_sbs, sbs_dev) -> float:
    """SSIM of the first SBS frame of the timed program against the oracle
    at ``StereoParams()`` on the bench's content. The oracle side is
    deterministic CPU ground truth (disk-cached); the device side is the
    timed run's own output, so a kernel regression cannot hide behind a
    warm cache. The batch's frames are copies of one, so every SBS frame
    must equal the first, or the first would not stand for the batch: a
    frame that differs raises."""
    from vsc_tpu_torch.config import StereoParams
    from vsc_tpu_torch.utils import oracle
    differ = (sbs_dev != sbs_dev[:1]).flatten(1).any(1).nonzero().flatten()
    if len(differ):
        raise RuntimeError(f"SBS frames {differ.tolist()} of the timed batch "
                           f"differ from frame 0 on copies of one frame")
    ours = sbs_dev[0].cpu().numpy()
    ref = oracle_sbs(frames[0].cpu().numpy(), depth_sbs[0].cpu().numpy(),
                     StereoParams())
    return round(oracle.ssim(ours, ref), 4)


def measure_ssim_extra(frames) -> dict:
    """Two more SSIM points, one frame each on the frames' device against
    the oracle:

    - ssim_noise_depth: default params on uniform-noise depth (every pixel
      a disocclusion: the fill and polish run everywhere);
    - ssim_alt_params: positive convergence (flips the per-eye crop-offset
      ordering) + super_sampling 1 (the compat branch of generate_sbs)."""
    import numpy as np
    import torch

    from vsc_tpu_torch.config import StereoParams
    from vsc_tpu_torch.ops.stereo import generate_sbs
    from vsc_tpu_torch.utils import oracle

    dev = frames.device
    frame = frames[0].cpu().numpy()
    out = {}

    def ours(depth, params):
        with torch.inference_mode():
            sbs = generate_sbs(frames[:1], torch.from_numpy(depth)[None]
                               .to(dev), params)
        return sbs[0].cpu().numpy()

    rng = np.random.default_rng(7)
    noise_depth = rng.integers(0, 256, frame.shape[:2], np.uint8)
    p_def = StereoParams()
    out["ssim_noise_depth"] = round(oracle.ssim(
        ours(noise_depth, p_def), oracle_sbs(frame, noise_depth, p_def)), 4)

    H, W = frame.shape[:2]
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    d = 0.45 + 0.35 * np.sin(xx / 311.0) * np.cos(yy / 173.0)
    depth = (np.clip(d, 0, 1) * 255).astype(np.uint8)
    p_alt = StereoParams(convergence=10.0, super_sampling=1.0)
    out["ssim_alt_params"] = round(oracle.ssim(
        ours(depth, p_alt), oracle_sbs(frame, depth, p_alt)), 4)
    return out


def measure_extras(frames, run_depth, run_sbs, batch, iters, sync,
                   depth_spf, sbs_spf) -> dict:
    """Secondary measurements:

    - ``decoded_video``: the same programs timed on decoded video frames
      (a clip at the frames' size through the media engine's encode and
      decode) with the stub's luminance depth of those frames;
    - ``sbs_worstcase_noise_depth_ms_per_frame``: SBS on uniform-noise
      depth, every pixel a disocclusion (on the decoded frames, else on
      the bench's own);
    - ``sbs_roofline_ms`` (``utils/flops.sbs_least_time``) and the SBS
      time's share of it, ``sbs_roofline_attained_pct``;
    - ``stream_convert_fps_stub_depth_x265ultrafast``: the streaming CLI
      (decode -> stub depth -> SBS -> encoder pipe) on a clip.

    The two media readings need vscmedia; where it does not start they
    read NO_MEDIA and the others still run. An error is caught into
    ``extras_error`` so that the headline survives."""
    import shutil
    import subprocess
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from vsc_tpu_torch.native import vscmedia_path

    extras = {}
    dev = frames.device
    H, W = frames.shape[1:3]
    tmp = Path(tempfile.mkdtemp(prefix="bench_clip_"))
    try:
        binary = vscmedia_path()
        src = frames
        if binary is None:
            extras.update({k: NO_MEDIA for k in MEDIA_KEYS})
        else:
            from vsc_tpu_torch.io.media import decode_frames
            from vsc_tpu_torch.models.stub import luminance_depth

            def make_clip(path, n):
                subprocess.run(
                    [str(binary), "makevideo", "--output", str(path),
                     "--width", str(W), "--height", str(H), "--frames",
                     str(n), "--framerate", "24"],
                    check=True, capture_output=True)

            clip = tmp / "clip.mkv"
            make_clip(clip, max(batch, 16))
            dec = [np.frombuffer(raw, np.uint8).reshape(H, W, 3)
                   for raw in decode_frames(clip, W, H, count=batch)]
            while len(dec) < batch:
                dec.append(dec[-1])
            src = torch.from_numpy(np.stack(dec)).to(dev)
            with torch.inference_mode():
                dec_depth = torch.round(luminance_depth(
                    src.to(torch.float32) / 127.5 - 1.0) * 255.0
                ).to(torch.uint8)
            run_depth(src)
            run_sbs(src, dec_depth)
            sync()
            t_d, _ = timed(lambda: run_depth(src), iters, sync)
            t_s, _ = timed(lambda: run_sbs(src, dec_depth), iters, sync)
            t_d, t_s = t_d / (iters * batch), t_s / (iters * batch)
            extras["decoded_video"] = {
                "depth_ms_per_frame": round(1000 * t_d, 1),
                "sbs_ms_per_frame": round(1000 * t_s, 1),
                "fps": round(1.0 / (t_d + t_s), 3),
            }

        rng = np.random.default_rng(1)
        noise_depth = torch.from_numpy(
            rng.integers(0, 256, (batch, H, W), np.uint8)).to(dev)
        run_sbs(src, noise_depth)
        sync()
        t, _ = timed(lambda: run_sbs(src, noise_depth), iters, sync)
        extras["sbs_worstcase_noise_depth_ms_per_frame"] = round(
            1000 * t / (iters * batch), 1)

        from vsc_tpu_torch.utils.flops import sbs_least_time
        sol = sbs_least_time(H, W)["ms"]
        extras["sbs_roofline_ms"] = round(sol, 3)
        extras["sbs_roofline_attained_pct"] = round(
            100.0 * sol / (1000.0 * sbs_spf), 1)

        if binary is not None:
            # two passes over distinct workflows: the first warms the
            # stream shapes, the second measures the steady state
            from vsc_tpu_torch.config import load_config, save_config
            from vsc_tpu_torch.pipeline import stream_convert
            from vsc_tpu_torch.pipeline.workflow_init import init_workflow
            n_stream = 2 * max(batch, 16)
            sclip = tmp / "stream_clip.mkv"
            make_clip(sclip, n_stream)

            def workflow(video, name):
                # preset ultrafast: at x265's default preset the reading
                # is the host's encoder, not the pipeline (labeled in the
                # key)
                wf = init_workflow(video, tmp / name)
                cfg = load_config(wf)
                cfg["encoding"]["preset"] = "ultrafast"
                save_config(wf, cfg)
                return wf, cfg

            warm, warm_cfg = workflow(clip, "wf_warm")
            stream_convert.run(warm, warm_cfg, batch_size=batch,
                               model_name="stub", concat=False, device=dev)
            wf, cfg = workflow(sclip, "wf")
            t0 = time.perf_counter()
            ok = stream_convert.run(wf, cfg, batch_size=batch,
                                    model_name="stub", concat=False,
                                    device=dev)
            wall = time.perf_counter() - t0
            if ok:
                extras["stream_convert_fps_stub_depth_x265ultrafast"] = \
                    round(n_stream / wall, 3)
    except Exception as e:  # extras must never sink the headline metric
        extras["extras_error"] = f"{type(e).__name__}: {e}"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return extras


if __name__ == "__main__":
    sys.exit(main())
