"""
Interactive stereo parameter tester (PyTorch)
=============================================

Port of ``vsc_tpu/pipeline/sbs_tester.py``, which replaces the reference's
Windows-bound Tkinter + Win32 tool (reference sbs_tester.py:18-26) with a
cross-platform equivalent exposing the same seven sliders over the same
ranges (Disparity 5-100, Convergence +-50, SuperSampling 1-4, EdgeSoftness
0-30, Smoothing 0-5, Gamma 0.1-2, Sharpen 0-16 — sbs_tester.py:356-362),
frame navigation over the valid frame set, a hold-to-view depth mode,
per-render timing, result caching per parameter set, and "save to config"
via update_stereo_params.

Two modes, on the card unless ``--cpu`` is given:
  - interactive: OpenCV HighGUI window + trackbars (works on any platform
    with a display; no Tkinter / Win32 dependency).
  - --grid: headless parameter sweep on a frame batch — renders the cross
    product of requested parameter values, writes preview PNGs + a timing
    report. Each parameter set is one batched ``generate_sbs`` dispatch;
    every clock stops only once the result is on the host (``.cpu()``),
    so no time is read before the card has finished::

        python -m vsc_tpu_torch.pipeline.sbs_tester <workflow> \\
            --grid "max_disparity=20,40;super_sampling=1,3" --frames 2
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from pathlib import Path

from vsc_tpu_torch.config import (
    ConfigError,
    StereoParams,
    find_valid_frames,
    get_frame_paths,
    load_config,
    update_stereo_params,
)

# slider name -> (param field, min, max, scale) ; scale maps int slider
# positions to float values (cv2 trackbars are integer-only)
SLIDERS = [
    ("Disparity", "max_disparity", 5, 100, 1.0),
    ("Convergence", "convergence", -50, 50, 1.0),
    ("SuperSampling x10", "super_sampling", 10, 40, 0.1),
    ("EdgeSoftness", "edge_softness", 0, 30, 1.0),
    ("Smoothing x10", "artifact_smoothing", 0, 50, 0.1),
    ("Gamma x100", "depth_gamma", 10, 200, 0.01),
    ("Sharpen", "sharpen", 0, 16, 1.0),
]


def detect_monitors() -> list[dict]:
    """Enumerate physical monitors as {x, y, width, height} dicts.

    Cross-platform replacement for the reference's Win32
    EnumDisplayMonitors path (sbs_tester.py:153-189): Win32 via ctypes on
    Windows, xrandr parsing on X11, a Tk screen query as fallback, and a
    1080p default when headless."""
    monitors: list[dict] = []
    if os.name == "nt":  # Win32 (reference behavior)
        try:
            import ctypes
            import ctypes.wintypes
            user32 = ctypes.windll.user32

            def callback(hMon, hdc, rect_p, _data):
                r = rect_p.contents
                monitors.append({"x": r.left, "y": r.top,
                                 "width": r.right - r.left,
                                 "height": r.bottom - r.top})
                return True

            proc = ctypes.WINFUNCTYPE(
                ctypes.c_bool, ctypes.c_ulong, ctypes.c_ulong,
                ctypes.POINTER(ctypes.wintypes.RECT), ctypes.c_double)
            user32.EnumDisplayMonitors(None, None, proc(callback), 0)
        except Exception:
            pass
    elif os.environ.get("DISPLAY"):
        try:
            import subprocess
            out = subprocess.run(["xrandr", "--listactivemonitors"],
                                 capture_output=True, text=True,
                                 timeout=5).stdout
            monitors = parse_xrandr_monitors(out)
        except (OSError, subprocess.SubprocessError):
            pass
        if not monitors:
            try:
                import tkinter
                root = tkinter.Tk()
                monitors = [{"x": 0, "y": 0,
                             "width": root.winfo_screenwidth(),
                             "height": root.winfo_screenheight()}]
                root.destroy()
            except Exception:
                pass
    return monitors or [{"x": 0, "y": 0, "width": 1920, "height": 1080}]


def parse_xrandr_monitors(text: str) -> list[dict]:
    """Parse `xrandr --listactivemonitors` output lines like
    ' 0: +*eDP-1 1920/309x1080/173+0+0  eDP-1' -> geometry dicts."""
    import re
    monitors = []
    for line in text.splitlines():
        m = re.search(r"(\d+)/\d+x(\d+)/\d+\+(\d+)\+(\d+)", line)
        if m:
            w, h, x, y = (int(g) for g in m.groups())
            monitors.append({"x": x, "y": y, "width": w, "height": h})
    return monitors


def fullscreen_image(image, monitor: dict):
    """Stretch the SBS image for a 3D monitor's fullscreen mode: width to
    the screen, height to screen*2 (the half-height-per-eye convention 3D
    displays expect — reference sbs_tester.py:191-200), Lanczos4."""
    import cv2
    return cv2.resize(image, (monitor["width"], monitor["height"] * 2),
                      interpolation=cv2.INTER_LANCZOS4)


def completion_cue():
    """Render-finished cue: winsound beep on Windows (reference
    sbs_tester.py:697), terminal bell elsewhere."""
    if os.name == "nt":
        try:
            import winsound
            winsound.Beep(800, 100)
            return
        except Exception:
            pass
    print("\a", end="", flush=True)


def render_params(rgb, depth, params: StereoParams, device):
    """One frame through the stereo pipeline on ``device``; returns (sbs u8
    HxWx3, seconds up to the result on the host)."""
    from vsc_tpu_torch.ops.stereo import generate_sbs
    from vsc_tpu_torch.parallel.auto import shard_batch
    t0 = time.perf_counter()
    sbs = generate_sbs(shard_batch(rgb[None], device),
                       shard_batch(depth[None], device), params)
    sbs = sbs.cpu().numpy()[0]
    return sbs, time.perf_counter() - t0


def run_grid(workflow_path: Path, config: dict, grid_spec: str,
             frame_limit: int, out_dir: Path | None, device) -> bool:
    """Headless sweep on ``device``: grid_spec like
    'max_disparity=20,40;depth_gamma=0.5,1.0' (cross product). The frames
    go to the device once; each parameter set is timed twice from the
    dispatch to its result on the host: ``first_call_s`` (on the card it
    includes the kernel library's load on the first set) and
    ``steady_s``."""
    import numpy as np
    from vsc_tpu_torch.io.image import load_image_pair
    from vsc_tpu_torch.parallel.auto import shard_batch

    frames = find_valid_frames(workflow_path, config)
    if not frames:
        print("ERROR: No frames with depth maps found. Run the depth step first.")
        return False
    frames = frames[:frame_limit]

    axes: dict[str, list[float]] = {}
    for part in filter(None, grid_spec.split(";")):
        key, _, values = part.partition("=")
        axes[key.strip()] = [float(v) for v in values.split(",")]
    base = StereoParams.from_config(config["stereo"])

    combos = [dict(zip(axes, vals))
              for vals in itertools.product(*axes.values())] or [{}]
    print(f"Grid: {len(combos)} parameter set(s) x {len(frames)} frame(s)")

    pairs = [get_frame_paths(workflow_path, config, n) for n in frames]
    rgbs, depths = [], []
    for pair in pairs:
        rgb, depth = load_image_pair(*pair)
        rgbs.append(rgb)
        depths.append(depth)
    rgb_batch = shard_batch(np.stack(rgbs), device)
    depth_batch = shard_batch(np.stack(depths), device)

    from vsc_tpu_torch.ops.stereo import generate_sbs
    report = []
    for combo in combos:
        params = StereoParams(**{**base.to_dict(), **combo})
        t0 = time.perf_counter()
        sbs = generate_sbs(rgb_batch, depth_batch, params).cpu().numpy()
        compile_and_run = time.perf_counter() - t0
        t0 = time.perf_counter()
        sbs = generate_sbs(rgb_batch, depth_batch, params).cpu().numpy()
        steady = time.perf_counter() - t0
        label = ",".join(f"{k}={v}" for k, v in combo.items()) or "base"
        report.append({"params": params.to_dict(), "label": label,
                       "first_call_s": round(compile_and_run, 3),
                       "steady_s": round(steady, 3),
                       "frames_per_s": round(len(frames) / max(steady, 1e-9), 2)})
        print(f"  {label}: {report[-1]['frames_per_s']} frames/s "
              f"(first call {compile_and_run:.1f}s)")
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
            import cv2
            safe = label.replace("=", "_").replace(",", "__")
            cv2.imwrite(str(out_dir / f"grid_{safe}.png"), sbs[0][:, :, ::-1])
    if out_dir is not None:
        (out_dir / "grid_report.json").write_text(json.dumps(report, indent=2))
        print(f"Report: {out_dir / 'grid_report.json'}")
    return True


def run_interactive(workflow_path: Path, config: dict, device) -> bool:
    import cv2
    import numpy as np
    from vsc_tpu_torch.io.image import load_image_pair

    frames = find_valid_frames(workflow_path, config)
    if not frames:
        print("ERROR: No frames with depth maps found. Run the depth step first.")
        return False

    params = StereoParams.from_config(config["stereo"])
    window = ("SBS Tester  [n/p: frame  d: depth  s: save  f: 3D fullscreen"
              "  m: monitor  q: quit]")
    cv2.namedWindow(window, cv2.WINDOW_NORMAL)
    cv2.resizeWindow(window, 1280, 360)

    monitors = detect_monitors()
    print(f"Detected {len(monitors)} monitor(s)")
    for i, m in enumerate(monitors):
        print(f"  Monitor {i}: {m['width']}x{m['height']} at "
              f"({m['x']}, {m['y']})")

    state = {"frame_idx": 0, "dirty": True, "fullscreen": False,
             "monitor": 0, "render_after": 0.0}
    cache: dict[tuple, "np.ndarray"] = {}

    def show(img_rgb):
        """Display, applying the 3D-monitor stretch in fullscreen mode."""
        if state["fullscreen"]:
            img_rgb = fullscreen_image(img_rgb, monitors[state["monitor"]])
        cv2.imshow(window, img_rgb[:, :, ::-1] if img_rgb.ndim == 3
                   else img_rgb)

    def apply_fullscreen():
        mon = monitors[state["monitor"]]
        if state["fullscreen"]:
            # leave fullscreen before moving so the WM honors the position
            cv2.setWindowProperty(window, cv2.WND_PROP_FULLSCREEN,
                                  cv2.WINDOW_NORMAL)
            cv2.moveWindow(window, mon["x"], mon["y"])
            cv2.setWindowProperty(window, cv2.WND_PROP_FULLSCREEN,
                                  cv2.WINDOW_FULLSCREEN)
        else:
            cv2.setWindowProperty(window, cv2.WND_PROP_FULLSCREEN,
                                  cv2.WINDOW_NORMAL)
            cv2.resizeWindow(window, 1280, 360)
        state["dirty"] = True

    def on_change(_=None):
        # 100 ms debounce like the reference (sbs_tester.py:487-498): each
        # movement re-arms the timer, so dragging a slider issues one
        # ~100 ms render per pause instead of one per poll tick
        state["dirty"] = True
        state["render_after"] = time.monotonic() + 0.1

    for name, field, lo, hi, scale in SLIDERS:
        init = int(round(getattr(params, field) / scale))
        cv2.createTrackbar(name, window, init - lo, hi - lo, on_change)

    def current_params() -> StereoParams:
        values = {}
        for name, field, lo, hi, scale in SLIDERS:
            pos = cv2.getTrackbarPos(name, window) + lo
            values[field] = pos * scale
        return StereoParams(**values)

    rgb = depth = None

    def load_frame():
        nonlocal rgb, depth
        pair = get_frame_paths(workflow_path, config, frames[state["frame_idx"]])
        rgb, depth = load_image_pair(*pair)
        cache.clear()
        state["dirty"] = True

    load_frame()
    print(f"{len(frames)} frames available. Rendering...")
    showing_depth = False

    while True:
        if (state["dirty"] and not showing_depth
                and time.monotonic() >= state["render_after"]):
            p = current_params()
            key = tuple(sorted(p.to_dict().items()))
            if key not in cache:
                sbs, dt = render_params(rgb, depth, p, device)
                cache[key] = sbs
                print(f"\rFrame {frames[state['frame_idx']]}: "
                      f"{dt * 1000:.0f} ms   ", end="", flush=True)
                completion_cue()  # reference beeps when a render lands
            show(cache[key])
            state["dirty"] = False

        key = cv2.waitKey(30) & 0xFF
        if key in (ord("q"), 27):
            break
        elif key == ord("n"):
            state["frame_idx"] = (state["frame_idx"] + 1) % len(frames)
            load_frame()
        elif key == ord("p"):
            state["frame_idx"] = (state["frame_idx"] - 1) % len(frames)
            load_frame()
        elif key == ord("d"):
            showing_depth = not showing_depth
            if showing_depth:
                d = depth.astype(np.float32)
                d = (d - d.min()) / max(float(d.max() - d.min()), 1e-6)
                cv2.imshow(window, (d * 255).astype(np.uint8))
            else:
                state["dirty"] = True
        elif key == ord("f"):
            # 3D-monitor fullscreen: image stretched to height*2 on the
            # selected monitor (reference sbs_tester.py:191-200)
            state["fullscreen"] = not state["fullscreen"]
            apply_fullscreen()
        elif key == ord("m"):
            # cycle target monitor (reference sbs_tester.py:153-189)
            state["monitor"] = (state["monitor"] + 1) % len(monitors)
            mon = monitors[state["monitor"]]
            print(f"\nMonitor {state['monitor']}: "
                  f"{mon['width']}x{mon['height']} at ({mon['x']}, {mon['y']})")
            apply_fullscreen()
        elif key == ord("s"):
            update_stereo_params(workflow_path, current_params().to_dict())
            print(f"\nSaved stereo parameters to "
                  f"{workflow_path / 'config.json'}")
        if cv2.getWindowProperty(window, cv2.WND_PROP_VISIBLE) < 1:
            break

    cv2.destroyAllWindows()
    return True


def pick_workflow_dir() -> str | None:
    """Tk folder dialog (reference sbs_tester.py:726-736); returns None when
    nothing was selected or no display is reachable."""
    if not os.environ.get("DISPLAY") and os.name == "posix":
        return None
    try:
        import tkinter as tk
        from tkinter import filedialog
        root = tk.Tk()
        root.withdraw()
        path = filedialog.askdirectory(title="Select Workflow Directory")
        root.destroy()
        return path or None
    except Exception:
        return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Interactively tune stereo parameters (or sweep a grid)")
    parser.add_argument("workflow_path", type=Path, nargs="?", default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU (default: the card)")
    parser.add_argument("--grid", type=str, default=None,
                        help="Headless sweep, e.g. "
                             "'max_disparity=20,50;depth_gamma=0.2,1.0'")
    parser.add_argument("--frames", type=int, default=4,
                        help="Frames per grid evaluation (batch size)")
    parser.add_argument("--out-dir", type=Path, default=None,
                        help="Directory for grid preview PNGs + report")
    args = parser.parse_args(argv)

    from vsc_tpu_torch import cli_device
    try:
        device = cli_device(force_cpu=args.cpu)
    except RuntimeError as e:
        print(f"ERROR: {e}")
        return 1
    if args.workflow_path is None:
        # no argument: folder picker, like the reference
        # (sbs_tester.py:726-736); headless runs must pass a path
        picked = pick_workflow_dir()
        if not picked:
            print("No workflow directory selected.")
            return 1
        args.workflow_path = Path(picked)
    if not args.workflow_path.is_dir():
        print(f"ERROR: Workflow directory not found: {args.workflow_path}")
        return 1
    try:
        config = load_config(args.workflow_path)
    except ConfigError as e:
        print(f"ERROR: {e}")
        return 1

    if args.grid is not None:
        ok = run_grid(args.workflow_path, config, args.grid, args.frames,
                      args.out_dir, device)
        return 0 if ok else 1

    if not os.environ.get("DISPLAY") and os.name == "posix":
        print("No display available; use --grid for the headless sweep.")
        return 1
    return 0 if run_interactive(args.workflow_path, config, device) else 1


if __name__ == "__main__":
    from vsc_tpu_torch.utils.console import (ensure_utf8_console,
                                             set_terminal_title)
    ensure_utf8_console()
    set_terminal_title("sbs_tester " + " ".join(sys.argv[1:]))
    sys.exit(main())
