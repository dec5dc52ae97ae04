"""
Seeded Depth Anything V2 weights in the official key layout
===========================================================

The configuration's ``weights_seed`` drawn by the reference's
``init_seeded`` (``reference/depth_anything_v2.py``: the scales of the
port's seeded init, flax's laws; LayerScale 1 as the published model's
``init_values``), stored in bf16, the type the model is served in, under
the keys of the official ``depth_anything_v2_vitl.pth``
(``pretrained.*`` with the mask token, ``depth_head.*``). The program
loads it through its normal checkpoint path
(``build_depth_fn("depth-anything-v2", checkpoint=...)``) and the
reference reads the same tensors.

The file is written once per checkout, under ``benchmark/.cache/``, and
read by every later run: about 0.67 GiB at the published widths.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import torch

from reference.depth_anything_v2 import (DepthAnythingV2, cfg_from_dict,
                                         init_seeded)

__all__ = ["CACHE", "weight_file"]

CACHE = Path(__file__).resolve().parents[1] / ".cache"


def weight_file(model: dict, seed: int) -> Path:
    """The checkpoint of ``model`` (the configuration's "model" object)
    drawn from ``seed``: made and written on first use, atomically, then
    found by its name."""
    tag = hashlib.sha256(json.dumps(model, sort_keys=True).encode()
                         ).hexdigest()[:12]
    path = CACHE / "weights" / f"dav2-{tag}-seed{int(seed)}.pth"
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with torch.device("meta"):
        shell = DepthAnythingV2(cfg_from_dict(model))
    state = {k: v.to(torch.bfloat16)
             for k, v in init_seeded(shell, seed).items()}
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    try:
        torch.save(state, str(tmp))
        tmp.replace(path)
    finally:
        tmp.unlink(missing_ok=True)
    return path
