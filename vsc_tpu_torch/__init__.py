"""
vsc_tpu_torch — the PyTorch / CUDA port of vsc_tpu
==================================================

A second package beside ``vsc_tpu`` (the JAX reference it is held against).
It mirrors the reference's sub-package layout and module names:

  ops/       resampling, filters, warp, inpaint, stereo glue, and the
             wrappers of the hand-written Hopper kernels (``*_cuda.py``)
  models/    the DepthPro ViT encoder/decoder as ``nn.Module``s, the stub
             depth model, and the JAX-parameter carrier
  pipeline/  ``build_depth_fn`` and the streaming converter CLI
  parallel/  the accelerator health probe
  config/, io/, utils/, native/, pipeline/{chunk_generator,
             video_concatenator}  the port's own copies of the JAX package's
             framework-free layers (workflow config, media engine, probe)
  csrc/      CUDA C++ sources of the kernels (built with nvcc at first use)

Public functions keep the reference's layouts ([B, H, W, 3] u8 frames,
[B, H, W] depth, [B, H, 2W, 3] SBS). Nothing here imports jax, flax or
``vsc_tpu``. The entry points run on the card unless the caller asks for
the CPU.
"""

__all__ = ["default_device"]


def default_device(force_cpu: bool = False):
    """CUDA device 0, or the CPU when ``force_cpu`` asks for it. Raises
    RuntimeError when there is no card and the CPU was not asked for: the
    port never falls back to the CPU on its own."""
    import torch
    if force_cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless "
                           "the CPU is asked for (force_cpu=True, --cpu, "
                           "device='cpu')")
    return torch.device("cuda", 0)
