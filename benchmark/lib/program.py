"""
The program as a cell's configuration states it
================================================

Helpers the entries (``entries/<entry>.py``) share: the configuration's
precision switches, its stereo parameters, the depth model built through
the depth step's own ``build_depth_fn`` from the seeded weight file, and a
seeded pool of frames and depth maps cut into batches.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from frozen.content import content_pool
from reference.depthpro import cfg_from_dict

__all__ = ["configure", "stereo_params", "depth_program", "BatchPool"]


def configure(cell, device) -> None:
    """TF32 and the depth model's dtype on the card, as the configuration
    states them."""
    cfg = cell.config
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get("tf32", False))
        torch.backends.cudnn.allow_tf32 = bool(cfg.get("tf32", False))
        os.environ["VSC_TPU_DEPTH_DTYPE"] = cfg["dtype"]


def stereo_params(cell):
    from vsc_tpu_torch.config.stereo_params import StereoParams
    return StereoParams(**cell.config["stereo"])


def program_config(model: dict):
    from vsc_tpu_torch.models import DepthProConfig, ViTConfig
    return DepthProConfig(
        img_size=model["img_size"], tile_size=model["tile_size"],
        encoder=ViTConfig(**model["encoder"]),
        hook_block_ids=tuple(model["hook_block_ids"]),
        decoder_features=model["decoder_features"],
        dims_encoder=tuple(model["dims_encoder"]),
        use_fov_head=False, use_fov_encoder=False)


def depth_program(cell, device, mesh=None):
    """(depth_fn, weight file): the depth step's ``build_depth_fn`` on
    DepthPro, loaded from the configuration's seeded weight file (written
    on first use, ``lib/weights.py``). Looked up on its module at call
    time, so that a planted control or fault takes its place."""
    from vsc_tpu_torch.pipeline import depth_map_generator
    from lib.weights import weight_file
    cfg = cell.config
    wpath = weight_file(cfg["model"], cfg_from_dict(cfg["model"]),
                        cfg["weights_seed"], device)
    H, W = cfg["frame"]["height"], cfg["frame"]["width"]
    fn = depth_map_generator.build_depth_fn(
        "depthpro", cfg["model"]["img_size"], H, W, False,
        checkpoint=str(wpath), device=device, mesh=mesh,
        model_cfg=program_config(cfg["model"]))
    return fn, wpath


class BatchPool:
    """The seed's pool of frames [n, H, W, 3] and depth maps [n, H, W]
    (host u8 arrays, ``frozen/content.py``), cut into batches of the
    cell's size and visited in an order drawn from the seed."""

    def __init__(self, cell, seed: int, device):
        cfg, mix = cell.config, cell.mix
        self.H, self.W = cfg["frame"]["height"], cfg["frame"]["width"]
        self.batch = int(mix.get("batch") or cfg["batch"])
        n = int(mix.get("pool_frames") or mix["pool_batches"] * self.batch)
        self.frames, self.depths = content_pool(n, self.H, self.W, seed,
                                                mix["pan_px"], device)
        n_batches = n // self.batch
        rng = np.random.default_rng([abs(int(seed)), 1])
        self.order = (rng.permutation(n_batches) if n_batches > 1
                      else np.zeros(1, int))

    def index(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def rows(self, k: int) -> slice:
        return slice(k * self.batch, (k + 1) * self.batch)
