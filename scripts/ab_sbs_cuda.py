"""Times the SBS stage of one tree of the port, for an A/B of two trees on
one card.

Imports ``vsc_tpu_torch`` from ``--repo`` (its kernel library is built
there, under build/, on first use) and prints one JSON line:

- ``sbs_ss1_ms_frame`` / ``sbs_ss3_ms_frame``: ``generate_sbs`` on a
  2-frame 1080p batch at super_sampling 1 and at the ``StereoParams()``
  defaults (3), mean of 10 calls after a warm-up (CUDA events), on
  chip_smoke's frames (``frames_u8``, seed 10) and their depth from
  full-width DepthPro (seed 0, bf16): what chip_smoke's phase 3 times;
- ``sbs_split_ms_frame``: the same at the defaults under
  ``VSC_TPU_PP_SPLIT=1`` (the split bilateral route);
- ``upsample_u8_ms``, ``upsample_f32_ms``, ``finish_ms``: those kernels
  through the tree's public entries at the defaults' shapes (RGB [6, 1080,
  2030] and depth [2, 1080, 2030] x3; the [3, 4, 3240, 6090] pair cropped
  as the defaults crop it), mean of 20 launches after a warm-up;
- ``pyramid_ladder_ms``: the whole push-pull ladder from the default
  path's [4, 4, 810, 1523] f32 quarter (``_pyramid_fill_planar_coarse``
  with that quarter given, whatever the tree hands to its pyramid
  kernel), and ``pyramid_203_ms``: ``pyramid_fill_below`` on the
  [4, 4, 203, 381] level two pools below it;
- ``bilateral_ms``: ``bilateral_pool_planar`` (filter and quarter) on the
  [4, 4, 3240, 6090] u8 pair at the defaults' smoothing;
- ``postprocess_own_pair_ms``: ``postprocess_eye`` on the pair and
  coarse fill that the default path's ``generate_sbs`` hands it on these
  frames; ``postprocess_scattered_ms``: on the u8 pair above (uniform
  colors, ~16 % scattered holes) and its coarse fill;
  each a mean of 20 launches after a warm-up.

Run each tree in a process of its own, in the order parent, change,
change, parent, for example with the parent unpacked under build/:

    python3 scripts/ab_sbs_cuda.py --repo build/parent --label parent
    python3 scripts/ab_sbs_cuda.py --repo . --label change
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", type=Path, required=True)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ERROR: no card", file=sys.stderr)
        return 2
    repo = args.repo.resolve()
    sys.path.insert(0, str(repo))
    # chip_smoke's frames and timer, from this script's tree
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import vsc_tpu_torch
    from vsc_tpu_torch.ops import inpaint, stereo
    from vsc_tpu_torch.ops.bilateral_cuda import bilateral_pool_planar
    from vsc_tpu_torch.ops.finish_cuda import sharpen_downscale_planar
    from vsc_tpu_torch.ops.pyramid_cuda import pyramid_fill_below
    from vsc_tpu_torch.ops.upsample_cuda import upsample_bilinear_int
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depth_fn
    if Path(vsc_tpu_torch.__file__).resolve().parents[1] != repo:
        raise SystemExit(f"vsc_tpu_torch came from {vsc_tpu_torch.__file__}")

    dev = torch.device("cuda")
    B, H, W = 2, 1080, 1920
    frames = smoke.frames_u8(B, dev, 10)
    depth_fn = build_depth_fn("depthpro", 1536, H, W, False, device=dev,
                              seed=0)
    depth = depth_fn(frames)
    del depth_fn
    torch.cuda.empty_cache()
    res = {"tree": args.label or str(args.repo)}
    for key, ss in (("sbs_ss1_ms_frame", 1.0), ("sbs_ss3_ms_frame", 3.0)):
        p = stereo.StereoParams(super_sampling=ss)
        res[key] = smoke.time_ms(lambda: stereo.generate_sbs(frames, depth,
                                                             p), reps=10) / B
    p = stereo.StereoParams()
    with smoke.env_set("VSC_TPU_PP_SPLIT", "1"):
        res["sbs_split_ms_frame"] = smoke.time_ms(
            lambda: stereo.generate_sbs(frames, depth, p), reps=10) / B
    # the postprocess's arguments on the default path, recorded
    seen = []
    postprocess_eye = stereo.postprocess_eye
    stereo.postprocess_eye = lambda *a: seen.append(a) or postprocess_eye(*a)
    try:
        stereo.generate_sbs(frames, depth, p)
    finally:
        stereo.postprocess_eye = postprocess_eye
    res["postprocess_own_pair_ms"] = smoke.time_ms(
        lambda: postprocess_eye(*seen[0]))
    del seen

    p = stereo.StereoParams()
    s = stereo.sbs_shapes(H, W, p)
    g = torch.Generator(dev).manual_seed(0)
    rgb = torch.floor(256 * torch.rand((3 * B, H, s["stretched_w"]),
                                       generator=g, device=dev))
    d = torch.rand((B, H, s["stretched_w"]), generator=g, device=dev)
    res["upsample_u8_ms"] = smoke.time_ms(
        lambda: upsample_bilinear_int(rgb, 3, quantize_u8=True))
    res["upsample_f32_ms"] = smoke.time_ms(
        lambda: upsample_bilinear_int(d, 3))
    lo, ro, crop_w = stereo._crop_offsets(H, W, p)
    pair = torch.randint(0, 256, (3, 2 * B, s["up_h"], s["up_w"]),
                         generator=g, device=dev, dtype=torch.uint8)
    res["finish_ms"] = smoke.time_ms(lambda: sharpen_downscale_planar(
        pair, 3, float(p.sharpen), H, W, crop_w, (lo, ro)))
    del pair
    eye4 = torch.randint(0, 256, (4, 2 * B, s["up_h"], s["up_w"]),
                         generator=g, device=dev, dtype=torch.uint8)
    eye4[3] = (eye4[3] > 40).to(torch.uint8)       # ~16 % holes
    eye4[:3] *= eye4[3]
    sm = p.artifact_smoothing
    res["bilateral_ms"] = smoke.time_ms(lambda: bilateral_pool_planar(eye4,
                                                                      sm))
    _, q = bilateral_pool_planar(eye4, sm)
    res["pyramid_ladder_ms"] = smoke.time_ms(
        lambda: inpaint._pyramid_fill_planar_coarse(None, quarter4=q))
    smooth_q = inpaint._pyramid_fill_planar_coarse(None, quarter4=q)
    res["postprocess_scattered_ms"] = smoke.time_ms(
        lambda: postprocess_eye(eye4, smooth_q, sm))
    del eye4, smooth_q
    q2 = inpaint._avgpool2_hw(inpaint._avgpool2_hw(q)).contiguous()
    res["pyramid_203_ms"] = smoke.time_ms(lambda: pyramid_fill_below(q2))
    res["pyramid_shapes"] = [list(q.shape), list(q2.shape)]
    res["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
