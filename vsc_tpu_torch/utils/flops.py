"""
Analytic work counts and the card's peaks
=========================================

Port of ``vsc_tpu/utils/flops.py`` on the port's configs, with the peaks of
the card the port runs on in place of the TPU v5e's:

- ``vit_flops`` / ``depthpro_flops``: exact multiply-add counts (x2 for
  FLOPs) of every matmul and conv of DepthPro's forward pass, the same
  arithmetic as the JAX package's; elementwise work (norms, GELU, softmax)
  is left out. ``bench.py`` divides them by ``PEAK_OPS_S["bf16_tensor"]``
  for the depth MFU.
- ``sbs_least_time``: the least time of the port's SBS path
  (``ops/stereo.py``'s planar-u8 branch): each kernel's and each torch glue
  stage's bytes and operations at the dtypes the path hands over, the sum
  of their ``least_time``. ``bench.py`` reports it as ``sbs_roofline_ms``
  and the SBS time's share of it.
- ``sbs_roofline``: the JAX package's stage model of the SBS program, its
  bytes and vector operations unchanged, on the card's rates. It moves f32
  between every stage where the port moves u8 planes, so it is not a
  bound on the port's time (at 1080p it counts 2.1x the bytes of
  ``sbs_least_time`` and reads 1.9x its time); it sets the port's reading
  beside the JAX bench's.
- ``least_time`` / ``issue_floor`` / ``bilateral_ops``: the least time the
  card could take for one kernel's work, as chip_smoke.py reports beside
  each kernel's time.
"""

from __future__ import annotations

import math

__all__ = ["HBM_BYTES_S", "LANE_OPS_S", "PEAK_OPS_S", "TRANSCENDENTAL_COST",
           "bilateral_ops", "depthpro_flops", "issue_floor", "least_time",
           "sbs_least_time", "sbs_roofline", "vit_flops"]

# NVIDIA H100 SXM 80GB HBM3, data sheet at 700 W: the memory rate and the
# dense peak of each operation type (float32 outside the tensor cores, an
# FMA counted as two operations; bf16 on the tensor cores).
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16_tensor": 989e12}

# Kernels that must round as their plain versions do write every f32
# multiply and add as its own instruction (__fmul_rn / __fadd_rn, no FMA
# contraction), and the card issues ~33.5 T of those a second (132 SMs x
# 128 lanes x ~1.98 GHz): half the 67 TFLOP/s above, which counts an FMA as
# two operations. The same rate counts one f32 multiply-add a lane a clock,
# the roofline's vector operation.
LANE_OPS_S = 33.5e12

# Slots an exp takes against one multiply-add: an SM issues 16 MUFU ex2 a
# clock against 128 FFMA.
TRANSCENDENTAL_COST = 8.0


def least_time(nbytes: float, **ops: float) -> dict:
    """Each input byte read once and each output byte written once at the
    memory rate, or the operations the function needs at the peak rate of
    their type (``f32=...``, ``bf16_tensor=...``), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max((n / PEAK_OPS_S[k] for k, n in ops.items()), default=0.0)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def issue_floor(ops: float) -> dict:
    """``ops`` f32 multiplies and adds issued one at a time."""
    return {"issue_floor_ms": 1e3 * ops / LANE_OPS_S}


def bilateral_ops(smoothing: float, pixels: int) -> float:
    """~20 f32 operations (3 sub, 3 abs, 2 add, 3 mul, exp, 6 for num and
    den) per tap of the bilateral disc and ~6 per pixel."""
    from vsc_tpu_torch.ops.postprocess_cuda import bilateral_geometry
    _, taps = bilateral_geometry(smoothing)
    return pixels * (20.0 * len(taps) + 6.0)


def vit_flops(cfg, n_images: int) -> float:
    """One ViT forward over n_images tiles of cfg.img_size."""
    T = cfg.num_patches + 1
    D = cfg.embed_dim
    hidden = int(D * cfg.mlp_ratio)
    patch_macs = cfg.num_patches * D * 3 * cfg.patch_size ** 2
    per_block = (
        T * D * 3 * D          # qkv
        + 2 * T * T * (D // cfg.num_heads) * cfg.num_heads  # qk^T + pv
        + T * D * D            # attn out proj
        + 2 * T * D * hidden   # fc1 + fc2
    )
    return 2.0 * n_images * (patch_macs + cfg.depth * per_block)


def depthpro_flops(cfg, batch: int) -> float:
    """Full DepthPro forward (encoder upsample stack + decoder + heads)."""
    enc = cfg.encoder
    grid = cfg.tile_size // enc.patch_size
    D = enc.embed_dim
    dd = cfg.decoder_features
    dims = cfg.dims_encoder
    g0 = 4 * grid          # merged fine / hook grid
    n_tiles = 25 + 9 + 1

    total = vit_flops(enc, batch * n_tiles)         # patch encoder
    total += vit_flops(enc, batch)                  # image encoder
    if cfg.use_fov_head and cfg.use_fov_encoder:
        total += vit_flops(enc, batch)              # fov encoder

    def conv(px, cin, cout, k=3):
        return 2.0 * batch * px * cin * cout * k * k

    def deconv(out_px, cin, cout):                  # 2x2/s2: 1 tap per output
        return 2.0 * batch * out_px * cin * cout

    # encoder upsample stack
    total += conv(g0 ** 2, D, dims[0], 1)                      # latent0 proj
    total += deconv((2 * g0) ** 2, dims[0], dd)
    total += deconv((4 * g0) ** 2, dd, dd)
    total += deconv((8 * g0) ** 2, dd, dd)
    total += conv(g0 ** 2, D, dims[0], 1)                      # latent1 proj
    total += deconv((2 * g0) ** 2, dims[0], dims[0])
    total += deconv((4 * g0) ** 2, dims[0], dims[0])
    total += conv(g0 ** 2, D, dims[1], 1)                      # fine
    total += deconv((2 * g0) ** 2, dims[1], dims[1])
    total += conv((g0 // 2) ** 2, D, dims[2], 1)               # mid
    total += deconv(g0 ** 2, dims[2], dims[2])
    total += conv(grid ** 2, D, dims[3], 1)                    # coarse
    total += deconv((2 * grid) ** 2, dims[3], dims[3])
    total += deconv((2 * grid) ** 2, D, dims[3])               # lowres
    total += conv((2 * grid) ** 2, 2 * dims[3], dims[3], 1)    # fuse

    # decoder projections (conv_0 is identity)
    lv = {1: (4 * g0) ** 2, 2: (2 * g0) ** 2, 3: g0 ** 2,
          4: (g0 // 2) ** 2}
    chan = {1: dims[0], 2: dims[1], 3: dims[2], 4: dims[3]}
    for i in range(1, 5):
        total += conv(lv[i], chan[i], dd)
    # fusion blocks: resnets (2 convs each) + deconv + 1x1 out
    px = {4: lv[4], 3: lv[3], 2: lv[2], 1: lv[1], 0: (8 * g0) ** 2}
    for i in (4, 3, 2, 1, 0):
        n_res = 2 if i == 4 else 4   # fusion_4 has no skip resnet applied
        total += n_res * conv(px[i], dd, dd)
        out_px = px[i - 1] if i > 0 else px[0]
        if i > 0:
            total += deconv(out_px, dd, dd)
        total += conv(out_px if i > 0 else px[0], dd, dd, 1)   # out_conv

    # depth head
    head_in = px[0]
    total += conv(head_in, dd, dd // 2)
    total += deconv(4 * head_in, dd // 2, dd // 2)
    total += conv(4 * head_in, dd // 2, 32)
    total += conv(4 * head_in, 32, 1, 1)

    if cfg.use_fov_head:
        total += conv((2 * grid) ** 2 // 4, dd, dd // 2)       # downsample s2
        if cfg.use_fov_encoder:
            T = enc.num_patches + 1
            total += 2.0 * batch * T * D * (dd // 2)           # neck linear
        total += conv(grid ** 2 // 4, dd // 2, math.ceil(dd / 4))
        total += conv(grid ** 2 // 16, math.ceil(dd / 4), math.ceil(dd / 8))
        k = grid // 4
        total += 2.0 * batch * math.ceil(dd / 8) * k * k
    return total


def sbs_roofline(height: int, width: int, params=None) -> dict:
    """The JAX package's per-frame stage model of the SBS program, on the
    card's rates.

    Each stage is max(bytes / HBM_BYTES_S, vector_ops / LANE_OPS_S): its
    inputs read and outputs written once at f32, and the f32 multiply-adds
    of its filter taps, an exp at TRANSCENDENTAL_COST. The stage model,
    bytes and operations are the JAX package's. The port's path moves u8
    planes between its kernels, so this is not a bound on its time: that
    is ``sbs_least_time``.

    Returns {"ms": total, "stages": {name: {"bytes", "vops", "ms"}}}.
    """
    from vsc_tpu_torch.config import StereoParams
    from vsc_tpu_torch.ops.stereo import sbs_shapes
    params = params or StereoParams()

    s = sbs_shapes(height, width, params)
    H, W = height, width
    SW = s["stretched_w"]
    UH, UW = s["up_h"], s["up_w"]
    CW = s["crop_w"]
    F = 4.0  # f32 bytes

    px_in = H * W
    px_st = H * SW
    px_up = UH * UW

    stages: dict[str, tuple[float, float]] = {}

    # 1. lanczos4 stretch (rgb+depth) + quantize; separable 8-tap resample:
    #    bytes = read in + write out; vops ~ 8 madds/px/axis (W axis only
    #    changes) for 4 channels
    stages["stretch"] = ((px_in + px_st) * 4 * F, px_st * 8 * 4)
    # 2. depth min-max normalize (reduce + rescale)
    stages["normalize"] = (px_st * 2 * F, px_st * 3)
    # 3. supersample rgb (3ch) + depth bilinear (2-tap per axis)
    if params.super_sampling > 1.0:
        stages["supersample"] = ((px_st + px_up) * 4 * F, px_up * 4 * 4)
    # 4. edge softening: separable gaussian k taps x 2 passes on depth
    if params.edge_softness > 0:
        k = max(5, min(int(params.edge_softness * 6) | 1, 31))
        stages["soften"] = (px_up * 2 * F, px_up * 2 * k)
    if params.depth_gamma != 1.0:
        stages["gamma"] = (px_up * 2 * F,
                           px_up * 2 * TRANSCENDENTAL_COST)
    # 6. forward warp: read rgb planes + depth once, write 2 eyes + 2 masks.
    #    vops: each output pixel tests the disparity candidates that can
    #    land on it; the bound assumes ~1/4 of the max_disparity shift
    #    range is live on scene-like depth.
    disp_px = params.max_disparity * (UW / SW if params.super_sampling > 1.0
                                      else 1.0)
    live_shifts = max(4.0, disp_px / 4.0)
    stages["warp"] = ((4 + 8) * px_up * F, 2 * px_up * live_shifts * 6)
    # 7. postprocess per eye x2: quarter-res pyramid estimate (read img+mask,
    #    write quarter) + fused bilateral/dilate/fill/polish (read eye, mask,
    #    quarter estimate; write eye).
    pp_bytes = 2 * ((4 + 1) * px_up + px_up / 16) * F \
        + 2 * ((4 + 1 + 3.0 / 16) * px_up + 3 * px_up) * F
    vops = 0.0
    if params.artifact_smoothing > 0:
        d = max(5, min(int(params.artifact_smoothing * 4), 15))
        r = d // 2
        taps = 3.14159 * r * r  # disc
        # per tap: 3ch diff+abs-sum (4), exp (8), 4 madds -> ~16 slots
        vops += 2 * px_up * taps * (8 + TRANSCENDENTAL_COST)
    vops += 2 * px_up * 9 * 2          # dilate3x3 + hole predication
    vops += 2 * px_up * 3 * 4 * 3      # 3 frontier fill sweeps, 4-nb, 3ch
    stages["postprocess"] = (pp_bytes, vops)
    # 9-10. crop+unsharp+area downscale (fused finish): read cropped eyes,
    #    write 2 x [H, W, 3]; vops: 5-tap separable blur x2 + sharpen.
    fin_px = UH * CW
    stages["finish"] = (2 * (fin_px + H * W) * 3 * F,
                        2 * fin_px * 3 * (10 + 3))
    # SBS pack to u8
    stages["pack"] = (2 * H * W * 3 * (F + 1), 0.0)

    out = {}
    total_ms = 0.0
    for name, (nbytes, nvops) in stages.items():
        ms = 1000.0 * max(nbytes / HBM_BYTES_S, nvops / LANE_OPS_S)
        out[name] = {"bytes": nbytes, "vops": nvops, "ms": round(ms, 3)}
        total_ms += ms
    return {"ms": round(total_ms, 2), "stages": out}


def sbs_least_time(height: int, width: int, params=None) -> dict:
    """Per-frame least time of the port's SBS path on the card.

    The path is ``ops/stereo.py``'s planar-u8 branch, which ``StereoParams()``
    takes at any real frame size (ValueError for the compat branch). Each
    kernel launch is a stage with the bytes of the tensors it reads and
    writes and the f32 operations chip_smoke.py bounds it with; each torch
    glue stage (the Lanczos stretch, the normalize, the edge pad between
    the pools or the pools themselves at an odd width, the SBS pack) reads
    its inputs and writes its outputs once at the dtypes the path hands
    over. A stage's time is its ``least_time``, and the path's is their sum.
    The postprocess counts its bilateral on every pixel and leaves out the
    fill and polish of the hole pixels, which depend on the data, so the
    sum stays below the time of any run.

    Returns {"ms": total, "stages": {name: {"bytes", "ops", "ms",
    "bound_by"}}}.
    """
    from vsc_tpu_torch.config import StereoParams
    from vsc_tpu_torch.ops.stereo import (_crop_offsets,
                                          _planar_u8_geometry_ok, sbs_shapes)
    params = params or StereoParams()
    s = sbs_shapes(height, width, params)
    if not (params.super_sampling > 1.0
            and float(s["scale_ratio"]).is_integer()
            and _planar_u8_geometry_ok(s, params)):
        raise ValueError(f"sbs_least_time covers the planar-u8 branch; "
                         f"{height} x {width} at {params} takes the compat "
                         f"branch")
    H, W, SW = height, width, s["stretched_w"]
    UH, UW, CW = s["up_h"], s["up_w"], _crop_offsets(height, width, params)[2]
    px_in, px_st, px_up = H * W, H * SW, UH * UW
    N = 2                                   # eyes: the pair's frames
    stages: dict[str, tuple[float, float]] = {}   # name: (bytes, f32 ops)

    # glue: u8 rgb + depth -> f32 stretched rgb planes and depth (8-tap
    # Lanczos along W, a multiply-add per tap and channel); min-max
    # normalize (reduce, subtract, divide)
    stages["stretch"] = (4 * px_in + 16 * px_st, 2.0 * 8 * 4 * px_st)
    stages["normalize"] = (8 * px_st, 3.0 * px_st)
    # upsample kernel: the RGB planes to u8, the depth in f32 (~6 f32
    # operations per output element)
    stages["upsample_u8"] = (12 * px_st + 3 * px_up, 6.0 * 3 * px_up)
    stages["upsample_f32"] = (4 * px_st + 4 * px_up, 6.0 * px_up)
    if params.edge_softness > 0:
        # two k-tap passes (a multiply-add each) and the gamma
        k = max(5, min(int(params.edge_softness * 6) | 1, 31))
        stages["blur"] = (8 * px_up, (4.0 * k + 4.0) * px_up)
    elif params.depth_gamma != 1.0:
        stages["gamma"] = (8 * px_up, 2.0 * TRANSCENDENTAL_COST * px_up)
    # warp: u8 RGB planes and f32 depth in, the [4, 2, H', W'] u8 pair out
    stages["warp_planar_u8"] = (3 * px_up + 4 * px_up + 4 * N * px_up,
                                40.0 * px_up)
    # the pools to the f32 quarter stack [4, 2, qh, qw] (~5 operations per
    # input pixel of a masked pool, ~1 per input element of the f32 pool)
    if UH % 4 == 0 and UW % 4 == 0:
        qh, qw = UH // 4, UW // 4
        stages["pool4_eye4"] = (4 * N * px_up + 16 * N * qh * qw,
                                5.0 * N * px_up)
    elif UH % 2 == 0 and UW % 2 == 0:
        h, w = UH // 2, UW // 2
        he, we = h + (h & 1), w + (w & 1)
        qh, qw = he // 2, we // 2
        stages["pool_eye4"] = (4 * N * px_up + 16 * N * h * w,
                               5.0 * N * px_up)
        if (h | w) & 1:
            stages["edge_even"] = (16 * N * (h * w + he * we), 0.0)
        stages["pool_f32"] = (16 * N * (he * we + qh * qw), 4.0 * N * he * we)
    else:
        # two 2x2 pools in torch, each edge-padding an odd side
        qh, qw = (-(-(-(-n // 2)) // 2) for n in (UH, UW))
        stages["pool_glue"] = (4 * N * px_up + 16 * N * qh * qw,
                               5.0 * N * px_up)
    # pyramid: the quarter stack in, the [3, 2, qh, qw] f32 estimate out
    # (~10 operations per input element)
    stages["pyramid"] = (28 * N * qh * qw, 10.0 * 4 * N * qh * qw)
    # postprocess: the pair and the estimate in, [3, 2, H', W'] u8 out
    stages["postprocess"] = (4 * N * px_up + 12 * N * qh * qw + 3 * N * px_up,
                             bilateral_ops(params.artifact_smoothing,
                                           N * px_up))
    # finish: each eye's crop read once, [3, 2, H, W] u8 out; 5 + 5 taps,
    # the unsharp and the box: ~26 operations per cropped pixel
    stages["finish"] = (3 * N * UH * CW + 3 * N * px_in,
                        26.0 * 3 * N * UH * CW)
    # glue: the eyes side by side, channel-last
    stages["pack"] = (2 * 3 * N * px_in, 0.0)

    out, total = {}, 0.0
    for name, (nbytes, ops) in stages.items():
        t = least_time(nbytes, f32=ops)
        out[name] = {"bytes": nbytes, "ops": ops, "ms": t["bound_ms"],
                     "bound_by": t["bound_by"]}
        total += t["bound_ms"]
    return {"ms": total, "stages": out}
