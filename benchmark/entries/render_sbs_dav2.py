"""
Entry "render_sbs_dav2": the streaming CLI's device path on Depth Anything V2
============================================================================

``entries/render_sbs.py``'s step (a batch of host-resident u8 frames
through ``parallel/auto.shard_batch``, ``stream_convert.render_sbs`` and
``gather`` on the CLI's dispatch thread), its inputs, warm-up and release,
with three parts of its own:

  the model   the depth step's ``build_depth_fn("depth-anything-v2")``,
              loaded from the configuration's seeded weight file in the
              official key layout (``lib/weights_dav2.py``); the model's
              module is imported first, so that a program without it
              stops before any work
  record()    Depth Anything V2's operations a frame
              (``frozen/dav2.dav2_flops``) and the long attention's least
              time a step (one launch a ViT block over the batch's
              2,443-token rows at 1080p, ``frozen/dav2``)
  check()     ``depth_gap`` against the plain reference
              (``reference/depth_anything_v2.py``, float32, TF32 off, same
              weights and frames), ``sbs_off_share`` as in ``render_sbs``

Spans: "depth" around each ``depth_fn`` call, "sbs" around each
``generate_sbs`` call, as in ``render_sbs``.
"""

from __future__ import annotations

import torch

from frozen import dav2
from lib import check
from lib.program import configure, stereo_params
from lib.spec import load_entry
from lib.weights_dav2 import weight_file
from reference.depth_anything_v2 import cfg_from_dict, depth_u8, load_official

_base = load_entry("render_sbs")
UNIT = _base.UNIT
inputs = _base.inputs


def program_config(model: dict):
    from vsc_tpu_torch.models.depth_anything import DepthAnythingV2Config
    from vsc_tpu_torch.models.vit import ViTConfig
    return DepthAnythingV2Config(
        encoder=ViTConfig(**model["encoder"]),
        hook_block_ids=tuple(model["hook_block_ids"]),
        features=model["features"], out_channels=tuple(model["out_channels"]),
        input_size=model["input_size"])


def depth_program(cell, device, mesh=None):
    """(depth_fn, weight file): ``build_depth_fn`` on Depth Anything V2,
    looked up on its module at call time so that a planted control takes
    its place."""
    from vsc_tpu_torch.pipeline import depth_map_generator
    cfg = cell.config
    wpath = weight_file(cfg["model"], cfg["weights_seed"])
    fn = depth_map_generator.build_depth_fn(
        "depth-anything-v2", cfg["model"]["input_size"],
        cfg["frame"]["height"], cfg["frame"]["width"], False,
        checkpoint=str(wpath), device=device, mesh=mesh,
        model_cfg=program_config(cfg["model"]))
    return fn, wpath


class reference_depth:
    """The reference model of ``cfg`` on ``device`` from the weight file at
    ``precision``: calling it gives the u8 depth of u8 frames [B, H, W, 3]
    (a tensor on ``device``), with TF32 off."""

    def __init__(self, cfg: dict, wpath, device, precision="float32"):
        self.model = load_official(wpath, cfg_from_dict(cfg["model"]), device)
        self.model.set_precision(precision)

    def __call__(self, frames_u8):
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return depth_u8(self.model, frames_u8)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32


class Entry(_base.Entry):
    def __init__(self, cell, pool, devices, spans):
        import vsc_tpu_torch.models.depth_anything  # noqa: F401
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

    def record(self):
        model = self.cell.config["model"]
        enc = model["encoder"]
        H, W, B = self.pool.H, self.pool.W, self.pool.batch
        T = dav2.tokens(model, H, W)
        bound = dav2.flash_attention_bound(B, T, enc["embed_dim"],
                                           enc["num_heads"])["bound_ms"]
        return {"H": H, "W": W, "batch": B,
                "params": {k: float(v) for k, v in
                           self.params.to_dict().items()},
                "flops_per_frame": dav2.dav2_flops(model, H, W),
                "attention_long": {"launches": enc["depth"],
                                   "bound_ms": enc["depth"] * bound}}

    @torch.no_grad()
    def check(self, samples):
        from vsc_tpu_torch.parallel.auto import gather
        dev = self.device
        p = {k: float(v) for k, v in self.params.to_dict().items()}
        ref = reference_depth(self.cell.config, self.wpath, dev)
        gaps, offs = [], []
        for k, d_prog, out in samples:
            rgb = torch.from_numpy(self.pool.frames[self.pool.rows(k)]).to(dev)
            d_prog = gather(d_prog).to(dev)
            gaps.append(check.depth_gap(d_prog, ref(rgb)))
            s_ref = check.reference_sbs(rgb, d_prog, p)
            offs.append(check.sbs_off_share(torch.from_numpy(out).to(dev),
                                            s_ref))
        return {"depth_gap": max(gaps), "sbs_off_share": max(offs)}
