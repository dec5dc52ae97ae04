"""
The yardstick: work counts and the card's peaks
===============================================

A frozen copy of ``vsc_tpu_torch/utils/flops.py`` as of commit 0b643e2
(``least_time``, ``vit_flops``, ``depthpro_flops``, ``sbs_least_time``,
``bilateral_ops`` and the peaks), with the few helpers of
``ops/stereo.py`` and ``ops/postprocess_cuda.py`` they read copied in, so
that a change to the program cannot change the measure it is held to.
The configuration objects are duck-typed: the reference's ``DepthProCfg``
serves.

- ``depthpro_flops``: exact multiply-add counts (x2) of every matmul and
  convolution of DepthPro's forward pass (elementwise work left out).
- ``sbs_least_time``: the least time of the port's planar-u8 SBS path per
  frame: each kernel's and glue stage's tensors read and written once at
  the dtypes the path hands over, or its f32 operations at the peak, the
  larger, summed. The postprocess's hole work depends on the data and is
  left out, so the bound stays below the time of any run.
- ``qkv_attention_bound``: the qkv attention kernel's least time for one
  launch: the packed bf16 qkv read once and the output written once, or
  its QK^T and PV products at the bf16 tensor peak.
"""

from __future__ import annotations

import math

__all__ = ["HBM_BYTES_S", "PEAK_OPS_S", "TRANSCENDENTAL_COST",
           "least_time", "vit_flops", "depthpro_flops", "sbs_least_time",
           "qkv_attention_bound", "SBS_KERNEL_STAGES"]

# NVIDIA H100 SXM 80GB HBM3, data sheet at 700 W: the memory rate and the
# dense peak of each operation type (float32 outside the tensor cores, an
# FMA counted as two operations; bf16 on the tensor cores).
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16_tensor": 989e12}
TRANSCENDENTAL_COST = 8.0

# the stages of sbs_least_time that are one hand-written kernel each
SBS_KERNEL_STAGES = ("upsample_u8", "upsample_f32", "blur", "warp_planar_u8",
                     "pool4_eye4", "pool_eye4", "pool_f32", "pyramid",
                     "postprocess", "finish")


def least_time(nbytes: float, **ops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max((n / PEAK_OPS_S[k] for k, n in ops.items()), default=0.0)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _bilateral_taps(smoothing: float) -> int:
    if smoothing <= 0:
        return 0
    r = max(5, min(int(smoothing * 4), 15)) // 2
    return sum(1 for dy in range(-r, r + 1) for dx in range(-r, r + 1)
               if (dy, dx) != (0, 0) and dy * dy + dx * dx <= r * r)


def bilateral_ops(smoothing: float, pixels: int) -> float:
    return pixels * (20.0 * _bilateral_taps(smoothing) + 6.0)


def vit_flops(cfg, n_images: int) -> float:
    T = cfg.num_patches + 1
    D = cfg.embed_dim
    hidden = int(D * cfg.mlp_ratio)
    patch_macs = cfg.num_patches * D * 3 * cfg.patch_size ** 2
    per_block = (T * D * 3 * D + 2 * T * T * (D // cfg.num_heads)
                 * cfg.num_heads + T * D * D + 2 * T * D * hidden)
    return 2.0 * n_images * (patch_macs + cfg.depth * per_block)


def depthpro_flops(cfg, batch: int) -> float:
    """Full DepthPro forward, FOV head off (as the pipeline builds it)."""
    enc = cfg.encoder
    grid = cfg.tile_size // enc.patch_size
    D = enc.embed_dim
    dd = cfg.decoder_features
    dims = cfg.dims_encoder
    g0 = 4 * grid
    n_tiles = 25 + 9 + 1
    total = vit_flops(enc, batch * n_tiles) + vit_flops(enc, batch)

    def conv(px, cin, cout, k=3):
        return 2.0 * batch * px * cin * cout * k * k

    def deconv(out_px, cin, cout):
        return 2.0 * batch * out_px * cin * cout

    total += conv(g0 ** 2, D, dims[0], 1)
    total += deconv((2 * g0) ** 2, dims[0], dd)
    total += deconv((4 * g0) ** 2, dd, dd)
    total += deconv((8 * g0) ** 2, dd, dd)
    total += conv(g0 ** 2, D, dims[0], 1)
    total += deconv((2 * g0) ** 2, dims[0], dims[0])
    total += deconv((4 * g0) ** 2, dims[0], dims[0])
    total += conv(g0 ** 2, D, dims[1], 1)
    total += deconv((2 * g0) ** 2, dims[1], dims[1])
    total += conv((g0 // 2) ** 2, D, dims[2], 1)
    total += deconv(g0 ** 2, dims[2], dims[2])
    total += conv(grid ** 2, D, dims[3], 1)
    total += deconv((2 * grid) ** 2, dims[3], dims[3])
    total += deconv((2 * grid) ** 2, D, dims[3])
    total += conv((2 * grid) ** 2, 2 * dims[3], dims[3], 1)
    lv = {1: (4 * g0) ** 2, 2: (2 * g0) ** 2, 3: g0 ** 2, 4: (g0 // 2) ** 2}
    chan = {1: dims[0], 2: dims[1], 3: dims[2], 4: dims[3]}
    for i in range(1, 5):
        total += conv(lv[i], chan[i], dd)
    px = {4: lv[4], 3: lv[3], 2: lv[2], 1: lv[1], 0: (8 * g0) ** 2}
    for i in (4, 3, 2, 1, 0):
        total += (2 if i == 4 else 4) * conv(px[i], dd, dd)
        out_px = px[i - 1] if i > 0 else px[0]
        if i > 0:
            total += deconv(out_px, dd, dd)
        total += conv(out_px if i > 0 else px[0], dd, dd, 1)
    head_in = px[0]
    total += conv(head_in, dd, dd // 2)
    total += deconv(4 * head_in, dd // 2, dd // 2)
    total += conv(4 * head_in, dd // 2, 32)
    total += conv(4 * head_in, 32, 1, 1)
    return total


def qkv_attention_bound(n: int, tokens: int, dim: int, heads: int) -> dict:
    """One launch of the qkv attention kernel over [n, tokens, 3 dim] bf16
    -> [n, tokens, dim] bf16."""
    nbytes = 2.0 * n * tokens * 3 * dim + 2.0 * n * tokens * dim
    ops = 4.0 * n * tokens * tokens * dim
    return least_time(nbytes, bf16_tensor=ops)


def _sbs_shapes(height: int, width: int, p: dict) -> dict:
    total = 2.0 * p["max_disparity"] + abs(p["convergence"])
    sw = int(width * (1.0 + total / width))
    up_h = int(height * p["super_sampling"])
    up_w = int(sw * p["super_sampling"])
    ratio = up_w / sw
    return {"stretched_w": sw, "up_h": up_h, "up_w": up_w,
            "scale_ratio": ratio, "crop_w": int(width * ratio)}


def sbs_least_time(height: int, width: int, p: dict) -> dict:
    """Per-frame least time of the planar-u8 SBS path at the parameters
    ``p`` (the seven StereoParams fields). Returns {"ms": total, "stages":
    {name: {"bytes", "ops", "ms", "bound_by"}}}."""
    s = _sbs_shapes(height, width, p)
    if not (p["super_sampling"] > 1.0
            and float(s["scale_ratio"]).is_integer()):
        raise ValueError("sbs_least_time covers the planar-u8 branch")
    H, W, SW = height, width, s["stretched_w"]
    UH, UW, CW = s["up_h"], s["up_w"], s["crop_w"]
    px_in, px_st, px_up = H * W, H * SW, UH * UW
    N = 2
    st: dict[str, tuple[float, float]] = {}
    st["stretch"] = (4 * px_in + 16 * px_st, 2.0 * 8 * 4 * px_st)
    st["normalize"] = (8 * px_st, 3.0 * px_st)
    st["upsample_u8"] = (12 * px_st + 3 * px_up, 6.0 * 3 * px_up)
    st["upsample_f32"] = (4 * px_st + 4 * px_up, 6.0 * px_up)
    if p["edge_softness"] > 0:
        k = max(5, min(int(p["edge_softness"] * 6) | 1, 31))
        st["blur"] = (8 * px_up, (4.0 * k + 4.0) * px_up)
    elif p["depth_gamma"] != 1.0:
        st["gamma"] = (8 * px_up, 2.0 * TRANSCENDENTAL_COST * px_up)
    st["warp_planar_u8"] = (3 * px_up + 4 * px_up + 4 * N * px_up,
                            40.0 * px_up)
    if UH % 4 == 0 and UW % 4 == 0:
        qh, qw = UH // 4, UW // 4
        st["pool4_eye4"] = (4 * N * px_up + 16 * N * qh * qw, 5.0 * N * px_up)
    elif UH % 2 == 0 and UW % 2 == 0:
        h, w = UH // 2, UW // 2
        he, we = h + (h & 1), w + (w & 1)
        qh, qw = he // 2, we // 2
        st["pool_eye4"] = (4 * N * px_up + 16 * N * h * w, 5.0 * N * px_up)
        if (h | w) & 1:
            st["edge_even"] = (16 * N * (h * w + he * we), 0.0)
        st["pool_f32"] = (16 * N * (he * we + qh * qw), 4.0 * N * he * we)
    else:
        qh, qw = (-(-(-(-n // 2)) // 2) for n in (UH, UW))
        st["pool_glue"] = (4 * N * px_up + 16 * N * qh * qw, 5.0 * N * px_up)
    st["pyramid"] = (28 * N * qh * qw, 10.0 * 4 * N * qh * qw)
    st["postprocess"] = (4 * N * px_up + 12 * N * qh * qw + 3 * N * px_up,
                         bilateral_ops(p["artifact_smoothing"], N * px_up))
    st["finish"] = (3 * N * UH * CW + 3 * N * px_in, 26.0 * 3 * N * UH * CW)
    st["pack"] = (2 * 3 * N * px_in, 0.0)
    out, total = {}, 0.0
    for name, (nbytes, ops) in st.items():
        t = least_time(nbytes, f32=ops)
        out[name] = {"bytes": nbytes, "ops": ops, "ms": t["bound_ms"],
                     "bound_by": t["bound_by"]}
        total += t["bound_ms"]
    return {"ms": total, "stages": out}
