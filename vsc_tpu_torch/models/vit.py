"""
Vision Transformer backbone (PyTorch)
=====================================

Port of ``vsc_tpu/models/vit.py``: the DINOv2-style ViT-L/16 DepthPro uses
as its patch and image encoders, as ``nn.Module``s named after timm's
ViT (the keys of Apple's ``depth_pro.pt``): ``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.{norm1, attn.qkv, attn.proj,
ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma}``, ``norm``.

The fused qkv projection keeps PyTorch's [q | k | v] row order; the
attention kernels (ops/attention_cuda.py) read q, k and v out of it through
strides: the qkv kernel for bf16 at head dim 64 up to 640 tokens (input
1536), the split-q/k/v kernel for float32 (``VSC_TPU_DEPTH_DTYPE=float32``),
other head dims and more tokens (input 2048 and up), as ``attention_route``
decides (the JAX module's choice at
``vsc_tpu/models/vit.py:185-221``). Matmuls are ``nn.Linear`` (the JAX
package leaves them to XLA). The folded-LayerNorm and sequence-sharding variants of the JAX module are
not ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from vsc_tpu_torch.ops.attention_cuda import (attention_route, qkv_attention,
                                              short_seq_attention)

__all__ = ["ViTConfig", "ViT", "init_flax_like"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Architecture hyper-parameters; defaults = dinov2l16_384."""
    img_size: int = 384
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    layerscale_init: float = 1.0e-5

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.init_value = init
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x):
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(nn.functional.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = 1.0 / math.sqrt(dim // num_heads)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        qkv = self.qkv(x)
        B, T, D3 = qkv.shape
        H, Dh = self.num_heads, D3 // (3 * self.num_heads)
        if attention_route(qkv.dtype, Dh, T) == "qkv":
            out = qkv_attention(qkv.contiguous(), H, self.scale)
        else:
            q, k, v = qkv.view(B, T, 3, H, Dh).unbind(2)
            out = short_seq_attention(q, k, v, self.scale).reshape(B, T, -1)
        return self.proj(out)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        D = cfg.embed_dim
        self.norm1 = nn.LayerNorm(D, eps=1e-6)
        self.attn = Attention(D, cfg.num_heads)
        self.ls1 = LayerScale(D, cfg.layerscale_init)
        self.norm2 = nn.LayerNorm(D, eps=1e-6)
        self.mlp = Mlp(D, int(D * cfg.mlp_ratio))
        self.ls2 = LayerScale(D, cfg.layerscale_init)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)    # [B, T, D]


class ViT(nn.Module):
    """Returns the final (normed) tokens and the outputs of the hooked
    blocks; cls token first."""

    def __init__(self, cfg: ViTConfig, hook_block_ids: tuple[int, ...] = ()):
        super().__init__()
        self.cfg = cfg
        self.hook_block_ids = tuple(hook_block_ids)
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.num_patches, D))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=1e-6)

    def forward(self, images, hook_batch: int | None = None):
        """images: [B, 3, h, w] in the model's input scale. ``hook_batch``
        keeps only the first rows of each hooked block output (DepthPro
        needs the fine tiles' hooks alone); it must not exceed B."""
        B = images.shape[0]
        if hook_batch is not None and hook_batch > B:
            raise ValueError(f"hook_batch {hook_batch} exceeds the "
                             f"{B} rows of the batch")
        x = self.patch_embed(images)
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        x = x + self.pos_embed
        hooks = {}
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.hook_block_ids:
                hooks[i] = x if hook_batch is None else x[:hook_batch]
        return self.norm(x), hooks


def _lecun_normal_(w, fan_in: int, generator):
    """flax's lecun_normal: truncated normal on [-2, 2] std, variance
    1 / fan_in after the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_flax_like(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every parameter following the JAX package's flax init laws:
    xavier-uniform for Linear and the patch conv, lecun-normal for other
    convs and transposed convs, zero biases, LayerNorm (1, 0), LayerScale at
    its init value, cls token 0, pos_embed N(0, 0.02)."""
    from vsc_tpu_torch.models.depthpro import ConvT2x2
    for name, m in module.named_modules():
        if isinstance(m, nn.Linear) or (isinstance(m, nn.Conv2d)
                                        and name.endswith("patch_embed.proj")):
            nn.init.xavier_uniform_(m.weight, generator=generator)
        elif isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, ConvT2x2):
            # flax kernel [kh, kw, I, O]: fan_in = kh * kw * I
            _lecun_normal_(m.weight, m.weight.shape[0] * m.weight[0, 0].numel(),
                           generator)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
        elif isinstance(m, LayerScale):
            m.gamma.fill_(m.init_value)
        elif isinstance(m, ViT):
            m.cls_token.zero_()
            nn.init.normal_(m.pos_embed, 0.0, 0.02, generator=generator)
        bias = getattr(m, "bias", None)
        if isinstance(bias, torch.Tensor) and not isinstance(m, LayerScale):
            bias.zero_()
