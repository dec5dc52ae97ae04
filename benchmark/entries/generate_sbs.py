"""
Entry "generate_sbs": the SBS step's compute on stored depth maps
=================================================================

One step is one batch of host-resident frames and their scene-like u8
depth maps through what ``pipeline/sbs_generator.run``'s ``compute`` and
``split_results`` do: ``parallel/auto.shard_batch`` of both onto the card
(or the data mesh), ``ops/stereo.generate_sbs`` and
``gather(...).numpy()``. Both are closures of ``run``, which reads and
writes PNG files, so their bodies are followed here; the file I/O and the
health probe are left out.

Mix parameters: "batch", "pool_frames", "pan_px", "warmup_steps", "check"
{"sample"}. Spans: "sbs" around each ``generate_sbs`` call. Check:
``sbs_off_share`` of the sampled batches against the reference SBS on the
same frames and depth maps (``lib/check.py``).
"""

from __future__ import annotations

import torch

from lib import check
from lib.program import BatchPool, configure, stereo_params

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
        spans.patch(stereo, "generate_sbs", "sbs")

    def warm(self):
        for i in range(int(self.cell.mix.get("warmup_steps", 1))):
            self.step(i)

    def step(self, i):
        from vsc_tpu_torch.ops import stereo
        from vsc_tpu_torch.parallel.auto import gather, shard_batch
        k = self.pool.index(i)
        rows = self.pool.rows(k)
        result = stereo.generate_sbs(
            shard_batch(self.pool.frames[rows], self.device, self.mesh),
            shard_batch(self.pool.depths[rows], self.device, self.mesh),
            self.params)
        out = gather(result).numpy()
        return len(out), (k, out)

    def record(self):
        return {"H": self.pool.H, "W": self.pool.W, "batch": self.pool.batch,
                "params": {k: float(v) for k, v in
                           self.params.to_dict().items()}}

    def release(self):
        pass

    @torch.no_grad()
    def check(self, samples):
        dev = self.device
        p = {k: float(v) for k, v in self.params.to_dict().items()}
        offs = []
        for k, out in samples:
            rows = self.pool.rows(k)
            rgb = torch.from_numpy(self.pool.frames[rows]).to(dev)
            dep = torch.from_numpy(self.pool.depths[rows]).to(dev)
            offs.append(check.sbs_off_share(
                torch.from_numpy(out).to(dev),
                check.reference_sbs(rgb, dep, p)))
        return {"sbs_off_share": max(offs)}
