"""
Dry run of the sharded full step
================================

The port's counterpart of ``__graft_entry__.dryrun_multichip``: a small
DepthPro with the full tiling topology (embed 256, 4 heads, 2 blocks, both
hooks) on an (N/2 data x 2 model) mesh with ``seq_shard``, through
``build_depth_fn`` (tensor-parallel attention on the kernel route where a
card is present: in bf16 each rank's 2 heads at head dim 64 go to the qkv
kernel), then the SBS stage data-parallel at the JAX dry run's two
parameter sets (compat at super_sampling 1, planar-u8 at 2). One frame a
data row, seeded. Each result is held against the unsharded run on the
same weights and frames: the SBS bit for bit (on the sharded depth), the
u8 depth within 1 code in float32 (the CPU) and within a mean of 1 and a
maximum of 16 codes in bf16 (a card: each rank's partial product rounds to
bf16 before the sum).

    python -m vsc_tpu_torch.parallel.dryrun 8                 # one process
    python -m vsc_tpu_torch.parallel.dryrun 8 --processes 2   # 2 over gloo

With ``--processes P`` it starts P processes joined over gloo
(``parallel/distributed.initialize``), each with N/P mesh devices and its
own slice of the batch; the outputs are all-gathered as host tensors and
process 0 compares them. The devices are the visible cards, each named as
often as the mesh needs (one card: cuda:0 N times), else the CPU. Prints
one ``dryrun_multichip OK: ...`` line, as the JAX dry run does.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

__all__ = ["small_config", "sbs_params", "local_devices", "run", "main"]

SIZE = 96
REPO = Path(__file__).resolve().parents[2]


def small_config():
    from vsc_tpu_torch.models import DepthProConfig, ViTConfig
    return DepthProConfig(
        img_size=SIZE, tile_size=SIZE // 4,
        encoder=ViTConfig(img_size=SIZE // 4, patch_size=3, embed_dim=256,
                          depth=2, num_heads=4, seq_shard=True),
        hook_block_ids=(0, 1), decoder_features=16,
        dims_encoder=(16, 16, 16, 16), use_fov_head=False)


def sbs_params() -> dict:
    """The JAX dry run's two SBS parameter sets, by branch."""
    from vsc_tpu_torch.config import StereoParams
    return {
        "compat": StereoParams(max_disparity=4.0, convergence=0.0,
                               super_sampling=1.0, edge_softness=1.0,
                               artifact_smoothing=0.0, depth_gamma=0.5,
                               sharpen=0.0),
        "planar-u8": StereoParams(max_disparity=4.0, convergence=0.0,
                                  super_sampling=2.0, edge_softness=1.0,
                                  artifact_smoothing=1.0, depth_gamma=0.5,
                                  sharpen=1.0),
    }


def _check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"dryrun check failed: {what}")


def local_devices(n: int, process_id: int = 0) -> list:
    """``n`` mesh devices for process ``process_id``: the visible cards
    from card ``process_id * n`` on, cycled; else the CPU ``n`` times."""
    import torch
    cards = torch.cuda.device_count()
    if cards:
        return [torch.device("cuda", (process_id * n + i) % cards)
                for i in range(n)]
    return [torch.device("cpu")] * n


def run(n_devices: int, process_id: int = 0, num_processes: int = 1) -> str:
    """The dry run over ``n_devices`` mesh devices in all, this process's
    share of them; returns the OK line (process 0) or "" (the others).
    Raises RuntimeError when a check fails."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from vsc_tpu_torch.ops import _cuda
    from vsc_tpu_torch.ops.stereo import generate_sbs
    from vsc_tpu_torch.parallel.auto import gather, shard_batch
    from vsc_tpu_torch.parallel.mesh import make_mesh
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depth_fn

    model_par = 2 if n_devices % 2 == 0 else 1
    data_par = n_devices // model_par
    if data_par % num_processes:
        raise ValueError(f"{data_par} data rows do not split over "
                         f"{num_processes} processes")
    rows = data_par // num_processes
    devices = local_devices(rows * model_par, process_id)
    mesh = make_mesh(rows, model_par, devices)
    cfg = small_config()
    frames = np.random.default_rng(0).integers(
        0, 256, (data_par, SIZE, SIZE, 3), np.uint8)   # one frame a row
    mine = frames[process_id * rows:(process_id + 1) * rows]

    _cuda.reset_launches()
    depth_fn = build_depth_fn("depthpro", SIZE, SIZE, SIZE, False,
                              model_cfg=cfg, mesh=mesh, seed=0)
    x = shard_batch(mine, devices[0], mesh)
    depth = depth_fn(x)
    sets = sbs_params()
    outs = [gather(depth)] + [gather(generate_sbs(x, depth, p))
                              for p in sets.values()]
    launches = dict(_cuda.LAUNCHES)
    if num_processes > 1:
        full = []
        for t in outs:
            parts = [torch.empty_like(t) for _ in range(num_processes)]
            dist.all_gather(parts, t)
            full.append(torch.cat(parts))
        outs = full
    if process_id:
        return ""

    # the unsharded run on the same weights and frames
    dev = devices[0]
    ref_fn = build_depth_fn("depthpro", SIZE, SIZE, SIZE, False,
                            model_cfg=cfg, device=dev, seed=0)
    with torch.inference_mode():
        ref = ref_fn(torch.from_numpy(frames).to(dev)).cpu()
    got = outs[0]
    _check(got.shape == ref.shape == (data_par, SIZE, SIZE), got.shape)
    diff = (got.int() - ref.int()).abs().float()
    mean, top = float(diff.mean()), int(diff.max())
    _check(int(ref.max()) > int(ref.min()), "the depth is constant")
    bf16 = dev.type == "cuda"
    _check((mean <= 1.0 and top <= 16) if bf16 else top <= 1,
           f"sharded u8 depth vs unsharded: mean {mean}, max {top} codes")
    rgb = torch.from_numpy(frames).to(dev)
    for (k, p), got_sbs in zip(sets.items(), outs[1:]):
        want = generate_sbs(rgb, got.to(dev), p).cpu()
        _check(got_sbs.shape == (data_par, SIZE, 2 * SIZE, 3), got_sbs.shape)
        _check(torch.equal(got_sbs, want), f"{k} SBS differs from unsharded")
    counted = ", ".join(f"{k} {v}" for k, v in launches.items() if v)
    return (f"dryrun_multichip OK: mesh=({data_par} data x {model_par} "
            f"model) over {num_processes} process(es) on "
            f"{sorted({str(d) for d in devices})}, depth {tuple(got.shape)} "
            f"(tensor- and sequence-parallel ViT, "
            f"{'bf16' if bf16 else 'float32'}; u8 vs unsharded: mean "
            f"{mean:.4f}, max {top} codes), sbs {tuple(outs[1].shape)} "
            f"compat + planar-u8 equal to unsharded; process 0 kernel "
            f"launches: {counted or 'none (CPU)'}")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n: int, processes: int, timeout: float) -> int:
    """Start the ``processes`` ranks on this host, wait for all; the first
    nonzero exit code, or 0."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vsc_tpu_torch.parallel.dryrun", str(n),
         "--processes", str(processes), "--process-id", str(r),
         "--coordinator", coordinator], cwd=REPO, env=env)
        for r in range(processes)]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return next((c for c in codes if c), 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Dry run of the sharded depth + SBS step at a small size")
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds to wait for the processes")
    args = ap.parse_args(argv)
    if args.processes > 1 and args.process_id is None:
        return _spawn(args.n_devices, args.processes, args.timeout)
    pid = args.process_id or 0
    if args.processes > 1:
        from vsc_tpu_torch.parallel.distributed import initialize
        initialize(args.coordinator, args.processes, pid, backend="gloo")
    try:
        line = run(args.n_devices, pid, args.processes)
    finally:
        if args.processes > 1:
            import torch.distributed as dist
            dist.destroy_process_group()
    if line:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
