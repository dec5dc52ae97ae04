"""
Plain DepthPro, the benchmark's reference for the depth layer
=============================================================

A frozen copy of the forward pass of ``vsc_tpu_torch/models/vit.py`` and
``vsc_tpu_torch/models/depthpro.py`` as of commit 0b643e2 (DepthPro as
published in apple/ml-depth-pro, arXiv:2410.02073), with every kernel
replaced by plain PyTorch: the attention is softmax(q k^T) v, the 2x2
transposed convolutions are ``conv_transpose2d``. It imports nothing of the
program. Module names are the keys of Apple's ``depth_pro.pt`` (timm's ViT
names), so ``load_apple`` reads the benchmark's weight file as it is.

``precision``:
  "float32"  the reference: float32 everywhere; the caller turns TF32 off
  "fp8"      the control: the inputs and weights of every matmul and
             convolution rounded to float8 e4m3 with one scale per tensor
             (amax / 448), the rest in float32: the step below bf16 that
             would tempt a later change

Also ``depth_u8``: the depth step's post-processing (bilinear to the
model's input, x / 127.5 - 1, the model, bilinear back, per-frame min-max,
round to u8), frozen from ``pipeline/depth_map_generator.build_depth_fn``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.nn import functional as F

from reference.resize import resize

__all__ = ["ViTCfg", "DepthProCfg", "DepthPro", "cfg_from_dict",
           "load_apple", "depth_u8"]

FP8_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class ViTCfg:
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


@dataclasses.dataclass(frozen=True)
class DepthProCfg:
    img_size: int = 1536
    tile_size: int = 384
    encoder: ViTCfg = ViTCfg()
    hook_block_ids: tuple = (5, 11)
    decoder_features: int = 256
    dims_encoder: tuple = (256, 512, 1024, 1024)
    use_fov_head: bool = False
    use_fov_encoder: bool = False

    @property
    def grid(self) -> int:
        return self.tile_size // self.encoder.patch_size


def cfg_from_dict(d: dict) -> DepthProCfg:
    """A configuration file's "model" object -> DepthProCfg (the FOV head
    is not part of the reference: the pipeline builds DepthPro without
    it)."""
    if d.get("use_fov_head", False):
        raise ValueError("the reference DepthPro has no FOV head")
    enc = ViTCfg(**d["encoder"])
    return DepthProCfg(img_size=d["img_size"], tile_size=d["tile_size"],
                       encoder=enc,
                       hook_block_ids=tuple(d["hook_block_ids"]),
                       decoder_features=d["decoder_features"],
                       dims_encoder=tuple(d["dims_encoder"]))


def _lowp(x, precision: str):
    if precision == "float32":
        return x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    scale = torch.clamp(x.abs().amax().float(), min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Op:
    """The precision every matmul and convolution of a model runs at."""
    precision = "float32"


def _linear(op, x, w, b):
    p = op.precision
    return F.linear(_lowp(x, p), _lowp(w, p), b)


def _conv(op, x, w, b, padding):
    p = op.precision
    return F.conv2d(_lowp(x, p), _lowp(w, p), b, padding=padding)


def _convT(op, x, w, b):
    p = op.precision
    return F.conv_transpose2d(_lowp(x, p), _lowp(w, p), b, stride=2)


class Linear(nn.Module):
    def __init__(self, op, cin, cout, bias=True):
        super().__init__()
        self.op = op
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return _linear(self.op, x, self.weight, self.bias)


class Conv(nn.Module):
    def __init__(self, op, cin, cout, k, bias=True):
        super().__init__()
        self.op = op
        self.k = k
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return _conv(self.op, x, self.weight, self.bias, self.k // 2)


class ConvT2x2(nn.Module):
    def __init__(self, op, cin, cout, bias=False):
        super().__init__()
        self.op = op
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return _convT(self.op, x, self.weight, self.bias)


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, op, dim, hidden):
        super().__init__()
        self.fc1 = Linear(op, dim, hidden)
        self.fc2 = Linear(op, hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, op, dim, heads):
        super().__init__()
        self.op = op
        self.heads = heads
        self.qkv = Linear(op, dim, 3 * dim)
        self.proj = Linear(op, dim, dim)

    def forward(self, x):
        B, T, D = x.shape
        H, Dh = self.heads, D // self.heads
        q, k, v = self.qkv(x).view(B, T, 3, H, Dh).permute(2, 0, 3, 1, 4)
        p = self.op.precision
        logits = torch.matmul(_lowp(q, p), _lowp(k, p).transpose(-1, -2))
        att = torch.softmax(logits * (1.0 / math.sqrt(Dh)), dim=-1)
        out = torch.matmul(_lowp(att, p), _lowp(v, p))
        return self.proj(out.transpose(1, 2).reshape(B, T, D))


class Block(nn.Module):
    def __init__(self, op, cfg: ViTCfg):
        super().__init__()
        D = cfg.embed_dim
        self.norm1 = nn.LayerNorm(D, eps=1e-6)
        self.attn = Attention(op, D, cfg.num_heads)
        self.ls1 = LayerScale(D)
        self.norm2 = nn.LayerNorm(D, eps=1e-6)
        self.mlp = Mlp(op, D, int(D * cfg.mlp_ratio))
        self.ls2 = LayerScale(D)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, op, cfg: ViTCfg):
        super().__init__()
        self.op = op
        self.p = cfg.patch_size
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(
            torch.empty(cfg.embed_dim, 3, self.p, self.p))
        self.proj.bias = nn.Parameter(torch.empty(cfg.embed_dim))

    def forward(self, x):
        p = self.op.precision
        y = F.conv2d(_lowp(x, p), _lowp(self.proj.weight, p),
                     self.proj.bias, stride=self.p)
        return y.flatten(2).transpose(1, 2)


class ViT(nn.Module):
    def __init__(self, op, cfg: ViTCfg, hooks=()):
        super().__init__()
        D = cfg.embed_dim
        self.hooks = tuple(hooks)
        self.patch_embed = PatchEmbed(op, cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, D))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + cfg.num_patches, D))
        self.blocks = nn.ModuleList(Block(op, cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=1e-6)

    def forward(self, images, hook_batch=None):
        B = images.shape[0]
        x = self.patch_embed(images)
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        x = x + self.pos_embed
        hooked = {}
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.hooks:
                hooked[i] = x if hook_batch is None else x[:hook_batch]
        return self.norm(x), hooked


def _downscale2tap(x, f: int):
    x = (x[:, :, f // 2 - 1::f] + x[:, :, f // 2::f]) * 0.5
    return (x[:, :, :, f // 2 - 1::f] + x[:, :, :, f // 2::f]) * 0.5


def _tile(images, tile: int, stride: int):
    B, C, S, _ = images.shape
    n = (S - tile) // stride + 1
    tiles = [images[:, :, i * stride:i * stride + tile,
                    j * stride:j * stride + tile]
             for i in range(n) for j in range(n)]
    return torch.stack(tiles, dim=1).reshape(B * n * n, C, tile, tile)


def _mosaic(feats, B: int, n: int, trim: int):
    t = feats.shape[-1]
    feats = feats.reshape(B, n, n, feats.shape[1], t, t)
    rows = []
    for i in range(n):
        y0, y1 = (0 if i == 0 else trim), (t if i == n - 1 else t - trim)
        cols = []
        for j in range(n):
            x0, x1 = (0 if j == 0 else trim), (t if j == n - 1 else t - trim)
            cols.append(feats[:, i, j, :, y0:y1, x0:x1])
        rows.append(torch.cat(cols, dim=3))
    return torch.cat(rows, dim=2)


def _tokens_to_map(tokens, grid: int):
    N, _, D = tokens.shape
    return tokens[:, 1:, :].reshape(N, grid, grid, D).permute(0, 3, 1, 2)


def _proj_upsample(op, cin, dim_out, n_up, dim_int=None):
    dim_int = dim_out if dim_int is None else dim_int
    layers = [Conv(op, cin, dim_int, 1, bias=False)]
    for i in range(n_up):
        layers.append(ConvT2x2(op, dim_int if i == 0 else dim_out, dim_out))
    return nn.Sequential(*layers)


def _apply_proj_upsample(seq, x, mosaic=None):
    x = seq[0](x)
    if mosaic is not None:
        x = mosaic(x)
    for layer in list(seq)[1:]:
        x = layer(x)
    return x


class Encoder(nn.Module):
    def __init__(self, op, cfg: DepthProCfg):
        super().__init__()
        self.cfg = cfg
        D = cfg.encoder.embed_dim
        dims, dd = cfg.dims_encoder, cfg.decoder_features
        self.patch_encoder = ViT(op, cfg.encoder, cfg.hook_block_ids)
        self.image_encoder = ViT(op, cfg.encoder)
        self.upsample_latent0 = _proj_upsample(op, D, dd, 3, dims[0])
        self.upsample_latent1 = _proj_upsample(op, D, dims[0], 2)
        self.upsample0 = _proj_upsample(op, D, dims[1], 1)
        self.upsample1 = _proj_upsample(op, D, dims[2], 1)
        self.upsample2 = _proj_upsample(op, D, dims[3], 1)
        self.upsample_lowres = ConvT2x2(op, D, dims[3], bias=True)
        self.fuse_lowres = Conv(op, 2 * dims[3], dims[3], 1)

    def forward(self, x):
        cfg = self.cfg
        B, _, S, _ = x.shape
        tile, grid = cfg.tile_size, cfg.grid
        x_half = _downscale2tap(x, 2)
        x_quar = _downscale2tap(x, 4)
        n_f = (S - tile) // (3 * tile // 4) + 1
        n_m = (S // 2 - tile) // (tile // 2) + 1
        tiles = torch.cat([_tile(x, tile, 3 * tile // 4),
                           _tile(x_half, tile, tile // 2), x_quar])
        nf2, nm2 = B * n_f * n_f, B * n_m * n_m
        tokens, hooks = self.patch_encoder(tiles, hook_batch=nf2)
        trim_f = (grid - 3 * grid // 4) // 2
        trim_m = (grid - grid // 2) // 2

        def fine(tok):
            return _tokens_to_map(tok[:nf2], grid)

        def mos_f(m):
            return _mosaic(m, B, n_f, trim_f)

        h0, h1 = cfg.hook_block_ids
        latent0 = _apply_proj_upsample(self.upsample_latent0, fine(hooks[h0]),
                                       mos_f)
        latent1 = _apply_proj_upsample(self.upsample_latent1, fine(hooks[h1]),
                                       mos_f)
        fine0 = _apply_proj_upsample(self.upsample0, fine(tokens), mos_f)
        mid = _apply_proj_upsample(
            self.upsample1, _tokens_to_map(tokens[nf2:nf2 + nm2], grid),
            lambda m: _mosaic(m, B, n_m, trim_m))
        coarse = _apply_proj_upsample(
            self.upsample2, _tokens_to_map(tokens[nf2 + nm2:], grid))
        img_tokens, _ = self.image_encoder(x_quar)
        glob = self.upsample_lowres(_tokens_to_map(img_tokens, grid))
        glob = self.fuse_lowres(torch.cat([coarse, glob], dim=1))
        return [latent0, latent1, fine0, mid, glob]


class PreActResidual(nn.Sequential):
    def __init__(self, op, dim):
        super().__init__(nn.ReLU(), Conv(op, dim, dim, 3), nn.ReLU(),
                         Conv(op, dim, dim, 3))

    def forward(self, x):
        return x + super().forward(x)


class Fusion(nn.Module):
    def __init__(self, op, dim, deconv: bool, skip: bool):
        super().__init__()
        if skip:
            self.resnet1 = PreActResidual(op, dim)
        self.resnet2 = PreActResidual(op, dim)
        if deconv:
            self.deconv = ConvT2x2(op, dim, dim)
        self.out_conv = Conv(op, dim, dim, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resnet1(skip)
        x = self.resnet2(x)
        if hasattr(self, "deconv"):
            x = self.deconv(x)
        return self.out_conv(x)


class Decoder(nn.Module):
    def __init__(self, op, cfg: DepthProCfg):
        super().__init__()
        dd, dims = cfg.decoder_features, cfg.dims_encoder
        self.convs = nn.ModuleList(
            [nn.Identity()] + [Conv(op, c, dd, 3, bias=False) for c in dims])
        self.fusions = nn.ModuleList(
            Fusion(op, dd, deconv=i != 0, skip=i != 4) for i in range(5))

    def forward(self, enc):
        proj = [conv(e) for conv, e in zip(self.convs, enc)]
        x = self.fusions[4](proj[4])
        for i in (3, 2, 1, 0):
            x = self.fusions[i](x, proj[i])
        return x


class DepthPro(nn.Module):
    """images [B, S, S, 3] in [-1, 1] -> canonical inverse depth [B, S', S']
    float32."""

    def __init__(self, cfg: DepthProCfg, precision: str = "float32"):
        super().__init__()
        self.cfg = cfg
        op = _Op()
        op.precision = precision
        self._op = op
        dd = cfg.decoder_features
        self.encoder = Encoder(op, cfg)
        self.decoder = Decoder(op, cfg)
        self.head = nn.Sequential(
            Conv(op, dd, dd // 2, 3),
            ConvT2x2(op, dd // 2, dd // 2, bias=True),
            Conv(op, dd // 2, 32, 3), nn.ReLU(), Conv(op, 32, 1, 1),
            nn.ReLU())

    def set_precision(self, precision: str) -> None:
        _lowp(torch.zeros(1), precision)        # refuse an unknown name
        self._op.precision = precision

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).to(torch.float32)
        return self.head(self.decoder(self.encoder(x)))[:, 0]


def load_apple(path, cfg: DepthProCfg, device) -> DepthPro:
    """The reference model in float32 on ``device`` from an Apple-layout
    state dict (``depth_pro.pt``) that holds exactly its tensors."""
    state = torch.load(str(path), map_location="cpu", weights_only=True)
    with torch.device("meta"):
        model = DepthPro(cfg)
    model = model.to_empty(device=device)
    state = {k: v.to(device=device, dtype=torch.float32)
             for k, v in state.items()}
    model.load_state_dict(state, strict=True)
    return model.eval()


@torch.no_grad()
def depth_u8(model: DepthPro, frames_u8, block: int = 1):
    """u8 frames [B, H, W, 3] on the model's device -> u8 depth [B, H, W],
    ``block`` frames at a time."""
    S = model.cfg.img_size
    _, H, W, _ = frames_u8.shape
    outs = []
    for i in range(0, frames_u8.shape[0], block):
        x = frames_u8[i:i + block].to(torch.float32)
        x = resize(x, S, S, "bilinear", channel_last=True)
        d = model(x / 127.5 - 1.0)
        d = resize(d, H, W, "bilinear")
        lo = d.amin(dim=(1, 2), keepdim=True)
        hi = d.amax(dim=(1, 2), keepdim=True)
        n = (d - lo) / torch.clamp(hi - lo, min=1e-12)
        outs.append(torch.round(n * 255.0).to(torch.uint8))
    return torch.cat(outs)
