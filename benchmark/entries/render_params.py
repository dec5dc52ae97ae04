"""
Entry "render_params": the interactive tester's render
======================================================

One step is one request of one tester user: a frame and its depth map
(host u8 arrays) through ``pipeline/sbs_tester.render_params`` (numpy in,
SBS numpy out) at the sliders' current values. The requests follow
``schedule``: the sliders start at the mix's "start" values, each request
moves one slider (never a "fixed" one) to a seeded position of its
range, and the frame changes every "frame_every" requests, as a user
pressing ``n`` would.

Mix parameters: "pool_frames", "pan_px", "sliders" ([field, lo, hi,
scale]: positions lo..hi times scale, as the tester's ``SLIDERS``),
"start", "fixed", "frame_every", "schedule" (requests drawn, cycled
through), "check" {"sample"}. Set-up warms every geometry, blur width,
bilateral radius and optional stage the schedule reaches, widest first.
Spans: "sbs" around the ``generate_sbs`` call inside each request. Check:
``sbs_off_share`` of the sampled requests against the reference SBS at
their own parameters (``lib/check.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from frozen.content import content_pool
from lib import check
from lib.program import configure

UNIT = "requests"


def schedule(mix: dict, seed: int, n_frames: int, count: int):
    """The tester's requests: [(pool frame, {field: value})]."""
    rng = np.random.default_rng([abs(int(seed)), 2])
    sliders = [s for s in mix["sliders"] if s[0] not in mix["fixed"]]
    values = dict(mix["start"])
    values.update(mix["fixed"])
    frame = int(rng.integers(0, n_frames))
    out = []
    for i in range(count):
        if i and i % mix["frame_every"] == 0:
            frame = int(rng.integers(0, n_frames))
        field, lo, hi, scale = sliders[int(rng.integers(0, len(sliders)))]
        values[field] = int(rng.integers(lo, hi + 1)) * scale
        out.append((frame, dict(values)))
    return out


def _warm_keys(H, W, p):
    """What decides the shapes and kernel instances one request runs: its
    geometry, blur taps, bilateral radius and optional stages."""
    from vsc_tpu_torch.ops.stereo import sbs_shapes
    k = max(5, min(int(p.edge_softness * 6) | 1, 31)) \
        if p.edge_softness > 0 else 0
    rb = max(5, min(int(p.artifact_smoothing * 4), 15)) // 2 \
        if p.artifact_smoothing > 0 else 0
    return (("w", sbs_shapes(H, W, p)["stretched_w"]), ("k", k), ("rb", rb),
            ("opt", p.depth_gamma != 1.0, p.sharpen > 0))


def inputs(cell, seed, device):
    """(frames, depth maps, requests [(pool frame, StereoParams)])."""
    from vsc_tpu_torch.config.stereo_params import StereoParams
    cfg, mix = cell.config, cell.mix
    n = int(mix["pool_frames"])
    frames, depths = content_pool(n, cfg["frame"]["height"],
                                  cfg["frame"]["width"], seed, mix["pan_px"],
                                  device)
    return frames, depths, [(f, StereoParams(**q)) for f, q in
                            schedule(mix, seed, n, int(mix["schedule"]))]


class Entry:
    def __init__(self, cell, inputs, devices, spans):
        from vsc_tpu_torch.ops import stereo
        cfg = cell.config
        self.cell, self.device = cell, torch.device(devices[0])
        self.H, self.W = cfg["frame"]["height"], cfg["frame"]["width"]
        self.frames, self.depths, self.reqs = inputs
        configure(cell, self.device)
        spans.patch(stereo, "generate_sbs", "sbs")

    def warm(self):
        seen, warm = set(), []
        for i, (_, p) in enumerate(self.reqs):
            keys = _warm_keys(self.H, self.W, p)
            if not seen.issuperset(keys):
                seen.update(keys)
                warm.append(i)
        # widest geometry first, so the allocator's blocks fit the rest
        for i in sorted(warm, key=lambda i: -_warm_keys(
                self.H, self.W, self.reqs[i][1])[0][1]):
            self.step(i)

    def step(self, i):
        from vsc_tpu_torch.pipeline import sbs_tester
        f, p = self.reqs[i % len(self.reqs)]
        sbs, _ = sbs_tester.render_params(self.frames[f], self.depths[f], p,
                                          self.device)
        return 1, (f, p, sbs)

    def record(self):
        return {"H": self.H, "W": self.W, "batch": 1}

    def release(self):
        pass

    @torch.no_grad()
    def check(self, samples):
        dev = self.device
        offs = []
        for f, p, out in samples:
            q = {k: float(v) for k, v in p.to_dict().items()}
            rgb = torch.from_numpy(self.frames[f][None]).to(dev)
            dep = torch.from_numpy(self.depths[f][None]).to(dev)
            offs.append(check.sbs_off_share(
                torch.from_numpy(np.ascontiguousarray(out)[None]).to(dev),
                check.reference_sbs(rgb, dep, q)))
        return {"sbs_off_share": max(offs)}
