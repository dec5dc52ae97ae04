"""
The output check: the timed path's outputs against the plain reference
======================================================================

The numbers an entry (``entries/<entry>.py``) compares after the window,
on a sample of its steps drawn from the seed, with the program's state
freed:

  depth_gap      (cells that run the model) the worst sampled frame's mean
                 |program - reference| of the u8 depth map, in codes. The
                 reference is ``reference/depthpro.py`` in float32 (TF32
                 off) on the same weight file and the same frames.
  sbs_off_share  the worst sampled frame's share of SBS bytes that differ
                 from the reference's (``reference/sbs.py``, float32) by
                 more than one code. Where the program made the depth map,
                 the reference SBS starts from that map: the SBS is a
                 discontinuous function of the u8 depth, so it can only
                 follow the program there; ``depth_gap`` checks the map.

Each number is held to the limit the configuration's "check_limits" gives
it. ``lib/control.py`` puts the reference in the program's place at the
precision below the configuration's, so that the same run reads the
control's numbers.
"""

from __future__ import annotations

import torch

from reference import sbs as ref_sbs
from reference.depthpro import cfg_from_dict, depth_u8, load_apple

__all__ = ["held", "depth_gap", "sbs_off_share", "reference_depth",
           "reference_sbs"]


def depth_gap(prog_u8, ref_u8) -> float:
    """The worst frame's mean absolute difference, in u8 codes."""
    d = (prog_u8.to(torch.int16) - ref_u8.to(torch.int16)).abs().float()
    return float(d.mean(dim=(1, 2)).max())


def sbs_off_share(prog_u8, ref_u8) -> float:
    """The worst frame's share of bytes more than one code off."""
    d = (prog_u8.to(torch.int16) - ref_u8.to(torch.int16)).abs() > 1
    return float(d.float().mean(dim=(1, 2, 3)).max())


class reference_depth:
    """The reference DepthPro of ``cfg`` on ``device`` from the weight file:
    calling it gives the u8 depth of u8 frames [B, H, W, 3] (a tensor on
    ``device``), with TF32 off."""

    def __init__(self, cfg: dict, wpath, device, precision="float32"):
        self.model = load_apple(wpath, cfg_from_dict(cfg["model"]), device)
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


def reference_sbs(rgb_u8, depth_u8_, params: dict, precision="float32"):
    return ref_sbs.generate_sbs(rgb_u8, depth_u8_, params, precision)


def held(cell, values: dict) -> dict:
    """{name: {"value", "limit"}}: each number beside the limit the
    configuration's "check_limits" gives it."""
    lim = cell.config["check_limits"]
    return {n: {"value": float(v), "limit": float(lim[n])}
            for n, v in values.items()}
