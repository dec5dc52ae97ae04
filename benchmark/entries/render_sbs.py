"""
Entry "render_sbs": the streaming CLI's device path
===================================================

One step is one batch of host-resident u8 frames through the body of
``pipeline/stream_convert.run``'s per-batch ``compute_batch``: a copy of
the frames through ``parallel/auto.shard_batch`` onto the card (or the
data mesh), ``stream_convert.render_sbs`` (the depth step's
``build_depth_fn`` on DepthPro, then ``ops/stereo.generate_sbs``) and
``gather(...)[:n].numpy()``, on a dispatch thread under the CLI's deadline
(``parallel/health.run_with_deadline``). ``compute_batch`` is a closure of
``run``, which needs a decoder, so its body is followed here; the decode,
the encode and the health probes around it are left out (the card's
machine has no media engine).

Mix parameters: "pool_batches", "pan_px", "warmup_steps", "check"
{"sample"}. Spans: "depth" around each ``depth_fn`` call, "sbs" around
each ``generate_sbs`` call. Check: ``depth_gap`` of the sampled batches'
depth maps and ``sbs_off_share`` of their SBS frames (``lib/check.py``);
the reference SBS starts from the program's depth map, which
``depth_gap`` holds on its own (the SBS is discontinuous in the u8 depth).
"""

from __future__ import annotations

import numpy as np
import torch

from frozen import flops
from lib import check
from lib.program import BatchPool, configure, depth_program, stereo_params
from reference.depthpro import cfg_from_dict

UNIT = "frames"


def inputs(cell, seed, device):
    return BatchPool(cell, seed, device)


class Entry:
    def __init__(self, cell, pool, devices, spans):
        from vsc_tpu_torch.ops import stereo
        from vsc_tpu_torch.parallel.auto import data_mesh
        self.cell, self.device = cell, torch.device(devices[0])
        self.pool = pool
        self.params = stereo_params(cell)
        configure(cell, self.device)
        self.mesh = data_mesh(self.device)
        depth_fn, self.wpath = depth_program(cell, self.device, self.mesh)
        self.depth_fn = spans.wrap("depth", depth_fn)
        spans.patch(stereo, "generate_sbs", "sbs")

    def warm(self):
        for i in range(int(self.cell.mix.get("warmup_steps", 1))):
            self.step(i)

    def step(self, i):
        from vsc_tpu_torch.parallel import health
        from vsc_tpu_torch.parallel.auto import gather, shard_batch
        from vsc_tpu_torch.pipeline import stream_convert
        k = self.pool.index(i)
        rgb_np = self.pool.frames[self.pool.rows(k)]
        n = len(rgb_np)
        depth = []

        def depth_fn(x):
            depth.append(self.depth_fn(x))
            return depth[-1]

        def run():
            rgb = shard_batch(np.array(rgb_np), self.device, self.mesh)
            sbs = stream_convert.render_sbs(rgb, depth_fn, self.params)
            return gather(sbs)[:n].numpy()
        out = health.run_with_deadline(run, max(
            stream_convert.DISPATCH_TIMEOUT,
            stream_convert.DISPATCH_COLD_TIMEOUT))
        return n, (k, depth[-1], out)

    def record(self):
        return {"H": self.pool.H, "W": self.pool.W, "batch": self.pool.batch,
                "params": {k: float(v) for k, v in
                           self.params.to_dict().items()},
                "flops_per_frame": flops.depthpro_flops(
                    cfg_from_dict(self.cell.config["model"]), 1)}

    def release(self):
        self.depth_fn = None

    @torch.no_grad()
    def check(self, samples):
        from vsc_tpu_torch.parallel.auto import gather
        dev = self.device
        p = {k: float(v) for k, v in self.params.to_dict().items()}
        ref = check.reference_depth(self.cell.config, self.wpath, dev)
        gaps, offs = [], []
        for k, d_prog, out in samples:
            rgb = torch.from_numpy(self.pool.frames[self.pool.rows(k)]).to(dev)
            d_prog = gather(d_prog).to(dev)
            gaps.append(check.depth_gap(d_prog, ref(rgb)))
            s_ref = check.reference_sbs(rgb, d_prog, p)
            offs.append(check.sbs_off_share(torch.from_numpy(out).to(dev),
                                            s_ref))
        return {"depth_gap": max(gaps), "sbs_off_share": max(offs)}
