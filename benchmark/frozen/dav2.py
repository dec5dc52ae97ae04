"""
The yardstick of Depth Anything V2: its operations and the long attention's
least time
===========================================================================

Written from the published model (github.com/DepthAnything/
Depth-Anything-V2, ``depth_anything_v2/dpt.py`` and ``dinov2.py``), not
from the program, so that a change to the program cannot change the measure
it is held to. The configuration is the configuration file's "model"
object.

- ``input_hw``: the model's input for a frame, the repository's
  lower-bound resize rule (``util/transform.py``'s ``Resize`` with
  ``keep_aspect_ratio``, ``ensure_multiple_of`` the patch, ``lower_bound``).
- ``dav2_flops``: exact multiply-adds (x2) of every matmul and convolution
  of one frame's forward pass: the patch embedding, per block the fused
  qkv, q k^T and p v, the projection and the MLP, then the DPT head's
  projections, resize layers, ``layerN_rn``, fusion blocks and output
  convolutions (elementwise work, the bilinear passes and the position
  table's resize left out).
- ``flash_attention_bound``: one launch of the long-token attention over
  [n, tokens, 3 dim] bf16 -> [n, tokens, dim] bf16: its QK^T and PV
  products (4 n tokens^2 dim operations) at the bf16 tensor peak against
  q, k, v and the output moved once at the memory rate, the larger.
- ``FLASH_KERNEL``: the name pattern of the program's kernel on that route.
"""

from __future__ import annotations

import numpy as np

from frozen.flops import least_time

__all__ = ["FLASH_KERNEL", "input_hw", "dav2_flops", "flash_attention_bound",
           "tokens"]

FLASH_KERNEL = r"flash_attention_kernel"


def input_hw(height: int, width: int, input_size: int,
             multiple: int) -> tuple[int, int]:
    sh, sw = input_size / height, input_size / width
    if sw > sh:
        sh = sw
    else:
        sw = sh

    def constrain(x):
        y = int(np.round(x / multiple) * multiple)
        if y < input_size:
            y = int(np.ceil(x / multiple) * multiple)
        return y
    return constrain(sh * height), constrain(sw * width)


def tokens(model: dict, height: int, width: int) -> int:
    """Tokens a frame in each ViT block: the patch grid plus the class
    token."""
    p = model["encoder"]["patch_size"]
    h, w = input_hw(height, width, model["input_size"], p)
    return (h // p) * (w // p) + 1


def dav2_flops(model: dict, height: int, width: int) -> float:
    """Operations of one ``height`` x ``width`` frame's forward pass."""
    enc = model["encoder"]
    p, D, depth = enc["patch_size"], enc["embed_dim"], enc["depth"]
    hidden = int(D * enc["mlp_ratio"])
    h, w = input_hw(height, width, model["input_size"], p)
    h0, w0 = h // p, w // p
    n = h0 * w0
    T = n + 1
    macs = n * D * 3 * p * p                               # patch embedding
    macs += depth * (T * D * 3 * D + 2 * T * T * D + T * D * D
                     + 2 * T * D * hidden)

    f, oc = model["features"], model["out_channels"]
    sizes = [(4 * h0, 4 * w0), (2 * h0, 2 * w0), (h0, w0),
             ((h0 + 1) // 2, (w0 + 1) // 2)]
    px = [a * b for a, b in sizes]
    macs += sum(n * D * c for c in oc)                     # projects
    macs += 16 * n * oc[0] * oc[0] + 4 * n * oc[1] * oc[1]  # 4x4/s4, 2x2/s2
    macs += px[3] * 9 * oc[3] * oc[3]                      # 3x3/s2
    macs += sum(q * 9 * c * f for q, c in zip(px, oc))     # layerN_rn
    rcu = 2 * 9 * f * f                                    # a pixel of an RCU
    macs += rcu * px[3] + px[2] * f * f                    # refinenet4
    macs += 2 * rcu * px[2] + px[1] * f * f                # refinenet3
    macs += 2 * rcu * px[1] + px[0] * f * f                # refinenet2
    macs += 2 * rcu * px[0] + 4 * px[0] * f * f            # refinenet1, x2
    macs += 4 * px[0] * 9 * f * (f // 2)                   # output_conv1
    macs += h * w * (9 * (f // 2) * 32 + 32)               # output_conv2
    return 2.0 * macs


def flash_attention_bound(n: int, tokens: int, dim: int, heads: int) -> dict:
    """One launch over n samples of ``tokens`` tokens at width ``dim``
    (``heads`` heads: the count does not change the work)."""
    nbytes = 2.0 * n * tokens * 3 * dim + 2.0 * n * tokens * dim
    ops = 4.0 * n * tokens * tokens * dim
    return least_time(nbytes, bf16_tensor=ops)
