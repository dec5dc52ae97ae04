"""
The control: the reference in the program's place, one precision lower
=======================================================================

``plant(cell, parts)`` puts the plain reference where the timed path calls
the program, computed in the nearest precision below the one the
configuration states, so that a whole run of the cell (``lib/harness.py``,
its own entry, window and check) reads the control's numbers:

  "depth"  the depth step's ``build_depth_fn`` builds the reference
           DepthPro from the same weight file, with float8 (e4m3) matmul
           and convolution inputs: the step below the configuration's
           bfloat16 (``reference/depthpro.py``)
  "sbs"    ``ops/stereo.generate_sbs`` is the reference SBS with every
           float stage rounded to bfloat16: the step below its float32
           (``reference/sbs.py``)

It returns the function that takes the control out again.
"""

from __future__ import annotations

import torch

from lib import check

__all__ = ["LOWER", "plant"]

# the configuration's precision -> the nearest one below
LOWER = {"float64": "float32", "float32": "bfloat16", "bfloat16": "fp8",
         "float16": "fp8"}


def plant(cell, parts=("depth", "sbs")):
    from vsc_tpu_torch.ops import stereo
    from vsc_tpu_torch.pipeline import depth_map_generator
    undo = []
    if "depth" in parts:
        real_build = depth_map_generator.build_depth_fn
        lower = LOWER[cell.config["dtype"]]

        def build(*a, checkpoint, device, **k):
            ref = check.reference_depth(cell.config, checkpoint,
                                        torch.device(device), lower)
            return lambda x: ref(x)
        depth_map_generator.build_depth_fn = build
        undo.append((depth_map_generator, "build_depth_fn", real_build))
    if "sbs" in parts:
        real_sbs = stereo.generate_sbs

        def sbs(rgb, depth, params=None):
            p = {k: float(v) for k, v in params.to_dict().items()}
            with torch.no_grad():
                return check.reference_sbs(rgb, depth, p, LOWER["float32"])
        stereo.generate_sbs = sbs
        undo.append((stereo, "generate_sbs", real_sbs))

    def remove():
        for module, attr, real in reversed(undo):
            setattr(module, attr, real)
    return remove
