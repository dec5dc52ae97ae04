"""Depth models of the port: DepthPro (ViT-L/16 encoders + multires conv
decoder) as ``nn.Module``s, the luminance stub, and the JAX-parameter
carrier."""

from vsc_tpu_torch.models.depthpro import DepthPro, DepthProConfig
from vsc_tpu_torch.models.vit import ViT, ViTConfig, init_flax_like

__all__ = ["DepthPro", "DepthProConfig", "ViT", "ViTConfig", "init_flax_like"]
