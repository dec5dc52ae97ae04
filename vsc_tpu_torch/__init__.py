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
  csrc/      CUDA C++ sources of the kernels (built with nvcc at first use)

Public functions keep the reference's layouts ([B, H, W, 3] u8 frames,
[B, H, W] depth, [B, H, 2W, 3] SBS). Nothing here imports jax or flax.
"""

__all__ = ["default_device"]


def default_device(force_cpu: bool = False):
    """CUDA device 0 when a card is present (and not forced off), else CPU."""
    import torch
    if not force_cpu and torch.cuda.is_available():
        return torch.device("cuda", 0)
    return torch.device("cpu")
