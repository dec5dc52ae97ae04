"""
Vision Transformer backbone (PyTorch)
=====================================

Port of ``vsc_tpu/models/vit.py``: the DINOv2-style ViT-L/16 DepthPro uses
as its patch, image and FOV encoders, as ``nn.Module``s named after timm's
ViT (the keys of Apple's ``depth_pro.pt``): ``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.{norm1, attn.qkv, attn.proj,
ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma}``, ``norm``. The same
module is Depth Anything V2's DINOv2 ViT-L/14 (``models/depth_anything.py``,
the same names under ``pretrained.``): it takes any [H/p, W/p] token grid,
and a grid other than its table's square one gets the table interpolated
as DINOv2's ``interpolate_pos_encoding`` does (``pos_table``), once per
grid; DepthPro's tiles match the table, which is then used as it is.

The fused qkv projection keeps PyTorch's [q | k | v] row order; the
attention kernels (ops/attention_cuda.py) read q, k and v out of it through
strides: the qkv kernel for bf16 at head dim 64 up to 640 tokens (input
1536), the flash kernel for bf16 at head dim 64 beyond (DepthPro at input
2048 and up, Depth Anything V2's 2,443 tokens), the split-q/k/v kernel for
float32 (``VSC_TPU_DEPTH_DTYPE=float32``) and other head dims, as
``attention_route`` decides (the JAX module's choice at
``vsc_tpu/models/vit.py:185-221``, with the flash route added). Matmuls
are ``nn.Linear`` (the JAX package leaves them to XLA). The
folded-LayerNorm variant of the JAX module is not ported.

Tensor and sequence parallelism (``vsc_tpu/models/vit.py:141-233``):
``parallel/sharding.shard_params`` gives every block of a replica its
model-axis ranks (``Block.ranks``), each a narrower ``Block`` on its own
device holding H/mp heads of qkv and proj and 1/mp of the MLP hidden
width. The blocks then run column-parallel (qkv, fc1) and row-parallel
(proj, fc2), with one float32 sum of the partial products across ranks
each, the Megatron pattern of ``vsc_tpu/parallel/sharding.py``; each rank
picks its attention route for its own H/mp heads. With
``ViTConfig.seq_shard`` the token stream between blocks is split over the
model axis (T padded to a multiple of mp): it is all-gathered, and the pad
dropped, before each LayerNorm, and the row-parallel sum is a
reduce-scatter, so the attention never sees a pad token. The values equal
the JAX module's ``_seq_constraint`` form. In bf16 each rank's partial
product is rounded to bf16 before the float32 sum, one rounding more than
the unsharded ``nn.Linear`` makes.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from vsc_tpu_torch.ops.attention_cuda import (attention_route,
                                              qkv_attention,
                                              short_seq_attention)
from vsc_tpu_torch.parallel.collectives import (all_gather, all_reduce,
                                                broadcast, gather_tokens,
                                                reduce_scatter, split_tokens)
from vsc_tpu_torch.parallel.mesh import on_device

__all__ = ["ViTConfig", "ViT", "init_flax_like", "pos_table", "POS_OFFSET"]

# DINOv2's ``interpolate_offset``: added to the target grid before the
# scale factor of the table's bicubic resize
POS_OFFSET = 0.1


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
    # split the token axis over the "model" mesh axis between blocks
    # (sequence parallelism); takes effect once the blocks are sharded
    seq_shard: bool = False

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

    def hidden(self, x):
        return nn.functional.gelu(self.fc1(x))

    def forward(self, x):
        return self.fc2(self.hidden(x))


class Attention(nn.Module):
    """``inner`` (default ``dim``) is the width of the heads: a model-axis
    rank holds ``num_heads`` = H/mp heads and ``inner`` = D/mp."""

    def __init__(self, dim: int, num_heads: int, inner: int | None = None):
        super().__init__()
        inner = dim if inner is None else inner
        self.num_heads = num_heads
        self.scale = 1.0 / math.sqrt(inner // num_heads)
        self.qkv = nn.Linear(dim, 3 * inner)
        self.proj = nn.Linear(inner, dim)

    def core(self, x):
        """The attention output before ``proj``, [B, T, inner]."""
        qkv = self.qkv(x)
        B, T, D3 = qkv.shape
        H, Dh = self.num_heads, D3 // (3 * self.num_heads)
        if attention_route(qkv.dtype, Dh, T) in ("qkv", "flash"):
            # qkv_attention hands the flash route on itself
            return qkv_attention(qkv.contiguous(), H, self.scale)
        q, k, v = qkv.view(B, T, 3, H, Dh).unbind(2)
        return short_seq_attention(q, k, v, self.scale).reshape(B, T, -1)

    def forward(self, x):
        return self.proj(self.core(x))


class Block(nn.Module):
    """A pre-LN transformer block; ``shards`` > 1 builds one model-axis
    rank's share of it (H / shards heads, 1 / shards of the MLP hidden
    width). ``ranks`` is None, or the list of such rank blocks, one per
    device of the model axis, that ``parallel/sharding.shard_params``
    gives the block (not registered as submodules: they live on their own
    devices and are not part of the state dict)."""

    def __init__(self, cfg: ViTConfig, shards: int = 1):
        super().__init__()
        D, H = cfg.embed_dim, cfg.num_heads
        if H % shards or D % shards or int(D * cfg.mlp_ratio) % shards:
            raise ValueError(f"{H} heads, width {D} do not split over "
                             f"{shards} model-axis ranks")
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(D, eps=1e-6)
        self.attn = Attention(D, H // shards, inner=D // shards)
        self.ls1 = LayerScale(D, cfg.layerscale_init)
        self.norm2 = nn.LayerNorm(D, eps=1e-6)
        self.mlp = Mlp(D, int(D * cfg.mlp_ratio) // shards)
        self.ls2 = LayerScale(D, cfg.layerscale_init)
        self.ranks = None

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))

    def forward_sharded(self, xs, tokens: int | None = None) -> list:
        """The block over its model-axis ranks. ``xs[r]`` is rank r's
        activation on its device: a copy of the [B, T, D] stream (tensor
        parallel, ``tokens`` None), or its token chunk of a stream of
        ``tokens`` real tokens (sequence parallel, ``split_tokens``).
        Returns the same form."""
        ranks = self.ranks
        devices = [r.norm1.weight.device for r in ranks]
        for which in ("attn", "mlp"):
            full = xs if tokens is None else all_gather(xs, devices, tokens)
            partial = []
            for r, d, x in zip(ranks, devices, full):
                with on_device(d):      # a rank's kernels on its own card
                    partial.append(r._partial(which, x))
            sums = (all_reduce(partial, devices) if tokens is None
                    else reduce_scatter(partial, devices))
            xs = [r._residual(which, x, s) for r, x, s in zip(ranks, xs, sums)]
        return xs

    def _partial(self, which: str, x):
        """This rank's row-parallel product of sublayer ``which`` ("attn"
        or "mlp") on the full stream ``x``, without its bias."""
        if which == "attn":
            return nn.functional.linear(self.attn.core(self.norm1(x)),
                                        self.attn.proj.weight)
        return nn.functional.linear(self.mlp.hidden(self.norm2(x)),
                                    self.mlp.fc2.weight)

    def _residual(self, which: str, x, total):
        """``x`` plus the layer-scaled sublayer output, from the float32
        sum of the ranks' products: the bias added once, one cast."""
        out, ls = ((self.attn.proj, self.ls1) if which == "attn"
                   else (self.mlp.fc2, self.ls2))
        return x + ls((total + out.bias).to(x.dtype))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)    # [B, T, D]


def pos_table(pos, grid: int, rows: int, cols: int):
    """The [1, 1 + grid^2, D] position table ``pos`` for a [rows, cols]
    token grid, as DINOv2's ``interpolate_pos_encoding``: the cls entry as
    it is, the grid in float32 through ``F.interpolate(scale_factor=((rows
    + 0.1) / grid, (cols + 0.1) / grid), mode="bicubic", antialias=False)``
    (the offset makes the output exactly [rows, cols]), cast back."""
    D = pos.shape[-1]
    pe = pos.float()
    patch = pe[:, 1:].reshape(1, grid, grid, D).permute(0, 3, 1, 2)
    patch = nn.functional.interpolate(
        patch, scale_factor=((rows + POS_OFFSET) / grid,
                             (cols + POS_OFFSET) / grid),
        mode="bicubic", antialias=False)
    if tuple(patch.shape[-2:]) != (rows, cols):
        raise ValueError(f"position table: {tuple(patch.shape[-2:])} from "
                         f"a {grid} x {grid} table, wanted {(rows, cols)}")
    patch = patch.permute(0, 2, 3, 1).reshape(1, rows * cols, D)
    return torch.cat([pe[:, :1], patch], dim=1).to(pos.dtype)


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
        self._pos = {}      # (rows, cols) -> (the table's state, its table)

    def pos_for(self, rows: int, cols: int):
        """The position table for a [rows, cols] token grid: ``pos_embed``
        itself on the table's own grid, else ``pos_table``'s, kept until
        the table changes (its version, storage, dtype or device)."""
        g, pe = self.cfg.grid_size, self.pos_embed
        if (rows, cols) == (g, g):
            return pe
        key = (pe._version, pe.data_ptr(), pe.dtype, pe.device,
               torch.is_inference_mode_enabled())
        hit = self._pos.get((rows, cols))
        if hit is None or hit[0] != key:
            hit = self._pos[(rows, cols)] = (key, pos_table(pe, g, rows,
                                                            cols))
        return hit[1]

    def forward(self, images, hook_batch: int | None = None):
        """images: [B, 3, h, w] in the model's input scale, h and w
        multiples of the patch size. ``hook_batch`` keeps only the first
        rows of each hooked block output (DepthPro needs the fine tiles'
        hooks alone); it must not exceed B."""
        B = images.shape[0]
        if hook_batch is not None and hook_batch > B:
            raise ValueError(f"hook_batch {hook_batch} exceeds the "
                             f"{B} rows of the batch")
        p = self.cfg.patch_size
        x = self.patch_embed(images)
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        x = x + self.pos_for(images.shape[-2] // p, images.shape[-1] // p)
        if len(self.blocks) and self.blocks[0].ranks is not None:
            return self._forward_sharded(x, hook_batch)
        hooks = {}
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.hook_block_ids:
                hooks[i] = x if hook_batch is None else x[:hook_batch]
        return self.norm(x), hooks

    def _forward_sharded(self, x, hook_batch: int | None):
        """The blocks over their model-axis ranks: the stream copied to
        every rank, or split over the ranks' token chunks under
        ``cfg.seq_shard``; joined on the first rank's device (this
        module's) for the hooks and the final norm."""
        devices = [r.norm1.weight.device for r in self.blocks[0].ranks]
        tokens = x.shape[1] if self.cfg.seq_shard else None
        xs = (broadcast(x, devices) if tokens is None
              else split_tokens(x, devices))

        def whole(xs):
            return (xs[0] if tokens is None
                    else gather_tokens(xs, devices[0], tokens))

        hooks = {}
        for i, blk in enumerate(self.blocks):
            xs = blk.forward_sharded(xs, tokens)
            if i in self.hook_block_ids:
                h = whole(xs)
                hooks[i] = h if hook_batch is None else h[:hook_batch]
        return self.norm(whole(xs)), hooks


def _lecun_normal_(w, fan_in: int, generator):
    """flax's lecun_normal: truncated normal on [-2, 2] std, variance
    1 / fan_in after the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_flax_like(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every parameter following the JAX package's flax init laws:
    xavier-uniform for the ViT's Linear and the patch conv, lecun-normal for
    other convs, transposed convs and the FOV encoder's Linear (a flax
    default Dense), zero biases, LayerNorm (1, 0), LayerScale at its init
    value, cls token 0, pos_embed N(0, 0.02). Depth Anything V2's head has
    ``nn.ConvTranspose2d`` layers (4 x 4 and 2 x 2): lecun-normal with a
    fan-in of kh * kw * Cin, as a flax ConvTranspose's."""
    from vsc_tpu_torch.models.depthpro import ConvT2x2
    for name, m in module.named_modules():
        if name.endswith("fov.encoder.1"):
            _lecun_normal_(m.weight, m.weight.shape[1], generator)
        elif isinstance(m, nn.Linear) or (
                isinstance(m, nn.Conv2d) and name.endswith("patch_embed.proj")):
            nn.init.xavier_uniform_(m.weight, generator=generator)
        elif isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, nn.ConvTranspose2d):
            _lecun_normal_(m.weight, m.weight[:, 0].numel(), generator)
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
