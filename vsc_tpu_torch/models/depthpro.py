"""
DepthPro monocular depth estimator (PyTorch)
============================================

Port of ``vsc_tpu/models/depthpro.py``, the FOV head included. Modules
carry the key names of Apple's ``depth_pro.pt`` as
``vsc_tpu/models/convert.py``'s ``_apple_mapping`` reads them:

  encoder.patch_encoder / encoder.image_encoder   two ViT-L/16 (models/vit.py)
  encoder.upsample_latent0|latent1|0|1|2           Sequential(1x1 conv,
                                                   ConvTranspose 2x2/s2 ...)
  encoder.upsample_lowres, encoder.fuse_lowres
  decoder.convs.{1..4}  (convs.0 is the identity)
  decoder.fusions.{i}.resnet1|resnet2 (Sequential(ReLU, Conv, ReLU, Conv)),
                      .deconv, .out_conv
  head.{0,1,2,4}
  fov.encoder.0 (a third ViT), fov.encoder.1 (Linear), fov.downsample.0,
  fov.head.{0,2,4}; without the FOV encoder fov.head.{0,2,4,6}, the
  downsample conv first

The coarsest fusion block has no skip input, so (as in the JAX parameter
tree) it has no ``resnet1``. Tensors have the [N, C, H, W] shape inside
and channels-last memory: ``DepthPro.forward`` takes the JAX package's
[B, S, S, 3] layout and permutes it (``_tokens_to_map`` does the same to
the tokens), and cuDNN's convolutions keep that format. Convolutions are
``F.conv2d`` / ``F.conv_transpose2d`` (the JAX package leaves them to XLA),
except that ``VSC_TPU_PALLAS_DECONV=1`` sends every ``ConvT2x2`` site the
guard ``deconv2x2_supported`` accepts to the deconv kernel
(ops/deconv_cuda.py), as the JAX module does at
``vsc_tpu/models/depthpro.py:200-220``; the route is off by default.

The FOV head (``use_fov_head``, on by default as in the JAX package) adds
the field of view in degrees and scales the canonical inverse depth to the
metric one. The pipeline builds DepthPro with the head off, as the JAX
package's does (``vsc_tpu/pipeline/depth_map_generator.py:58-76``): it
min-max normalizes the depth, so the head cannot change its output.

On a mesh with a model axis, ``parallel/sharding.shard_params`` gives the
blocks of every encoder (the FOV encoder's too) their model-axis ranks
(tensor parallel, and sequence parallel under ``encoder.seq_shard``;
``models/vit.py``); the convolutions, the FOV encoder's Linear and the
decoder stay whole on the replica's device, as
``vsc_tpu/parallel/sharding.param_shardings`` leaves them replicated.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
from torch import nn

from vsc_tpu_torch.models.vit import ViT, ViTConfig
from vsc_tpu_torch.ops.deconv_cuda import (deconv2x2, deconv2x2_supported,
                                           pack_weight)
from vsc_tpu_torch.utils.profiling import span

__all__ = ["DepthProConfig", "DepthPro", "ConvT2x2", "DECONV_ENV",
           "preprocess_frames"]

DECONV_ENV = "VSC_TPU_PALLAS_DECONV"


@dataclasses.dataclass(frozen=True)
class DepthProConfig:
    img_size: int = 1536
    tile_size: int = 384
    encoder: ViTConfig = ViTConfig()
    hook_block_ids: tuple[int, int] = (5, 11)
    decoder_features: int = 256
    dims_encoder: tuple[int, int, int, int] = (256, 512, 1024, 1024)
    use_fov_head: bool = True
    # Apple's full model runs a third ViT for the FOV branch; without it the
    # FOV head works from the decoder's global feature alone.
    use_fov_encoder: bool = True

    def __post_init__(self):
        if self.img_size != 4 * self.tile_size:
            raise ValueError(f"img_size ({self.img_size}) must be 4 * "
                             f"tile_size ({self.tile_size})")
        grid = self.tile_size // self.encoder.patch_size
        if grid * self.encoder.patch_size != self.tile_size or grid % 8:
            raise ValueError(f"tile_size/patch_size token grid ({grid}) "
                             "must be a multiple of 8")

    @property
    def grid(self) -> int:
        return self.tile_size // self.encoder.patch_size

    @staticmethod
    def tiny() -> "DepthProConfig":
        """The JAX package's test config: the same topology at a 64^2
        input, 16^2 tiles (8 x 8 tokens) and a shallow ViT."""
        return DepthProConfig(
            img_size=64, tile_size=16,
            encoder=ViTConfig(img_size=16, patch_size=2, embed_dim=32,
                              depth=4, num_heads=2),
            hook_block_ids=(0, 2), decoder_features=16,
            dims_encoder=(16, 24, 32, 32))


def preprocess_frames(rgb_u8):
    """uint8 [B, H, W, 3] RGB -> the model's input in [-1, 1]
    (x / 127.5 - 1, DepthPro's normalization), on the frames' device."""
    return rgb_u8.to(torch.float32) / 127.5 - 1.0


def _downscale2tap(x, factor: int):
    """F.interpolate(scale_factor=1/f, bilinear, align_corners=False) for
    even integer f: an exact 2-tap average with stride f (NCHW)."""
    f = factor
    x = (x[:, :, f // 2 - 1::f] + x[:, :, f // 2::f]) * 0.5
    return (x[:, :, :, f // 2 - 1::f] + x[:, :, :, f // 2::f]) * 0.5


def _tile(images, tile: int, stride: int):
    """[B, C, S, S] -> overlapping tiles [B*n*n, C, tile, tile] (b, i, j)."""
    B, C, S, _ = images.shape
    n = (S - tile) // stride + 1
    tiles = [images[:, :, i * stride:i * stride + tile,
                    j * stride:j * stride + tile]
             for i in range(n) for j in range(n)]
    return torch.stack(tiles, dim=1).reshape(B * n * n, C, tile, tile)


def _mosaic(feats, B: int, n: int, trim: int):
    """Inverse of _tile in feature space: [B*n*n, C, t, t] -> [B, C, G, G],
    trimming ``trim`` overlap rows/cols from interior tile edges."""
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
    """[N, 1+T, D] -> [N, D, grid, grid] (cls dropped)."""
    N, _, D = tokens.shape
    return tokens[:, 1:, :].reshape(N, grid, grid, D).permute(0, 3, 1, 2)


def _conv(cin: int, cout: int, k: int, bias: bool = True):
    return nn.Conv2d(cin, cout, k, stride=1, padding=k // 2, bias=bias)


class ConvT2x2(nn.Module):
    """ConvTranspose 2x2 / stride 2 / no padding with ``nn.ConvTranspose2d``'s
    parameters (``weight`` [Cin, Cout, 2, 2], optional ``bias`` [Cout]), so
    checkpoints and models/convert.py carry across unchanged. cuDNN's
    transposed convolution by default; the deconv kernel under
    ``VSC_TPU_PALLAS_DECONV=1`` where the guard accepts the input. Both
    read the channels-last activations as they come and return a
    channels-last output; the kernel's packed weight is kept here, packed
    again when the weight changes (its version, storage, dtype or
    device)."""

    def __init__(self, cin: int, cout: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        # nn.ConvTranspose2d's default init (models are re-drawn by
        # init_flax_like or loaded from a checkpoint)
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        if self.bias is not None:
            bound = 1.0 / math.sqrt(cout * 4)
            nn.init.uniform_(self.bias, -bound, bound)
        self._packed = (None, None)

    def packed_weight(self):
        w = self.weight
        key = (w._version, w.data_ptr(), w.dtype, w.device)
        if self._packed[0] != key:
            self._packed = (key, pack_weight(w.detach()))
        return self._packed[1]

    def forward(self, x):
        if (os.environ.get(DECONV_ENV, "0") == "1"
                and deconv2x2_supported(x, self.weight.shape[1])):
            return deconv2x2(x, self.weight, self.bias,
                             packed=self.packed_weight())
        return nn.functional.conv_transpose2d(x, self.weight, self.bias,
                                              stride=2)


def _convT(cin: int, cout: int, bias: bool = False):
    return ConvT2x2(cin, cout, bias=bias)


def _proj_upsample(cin: int, dim_out: int, n_up: int, dim_int=None):
    """Apple's _create_project_upsample_block: 1x1 projection then n_up
    bias-free ConvTranspose 2x2/s2."""
    dim_int = dim_int if dim_int is not None else dim_out
    layers = [_conv(cin, dim_int, 1, bias=False)]
    for i in range(n_up):
        layers.append(_convT(dim_int if i == 0 else dim_out, dim_out))
    return nn.Sequential(*layers)


def _apply_proj_upsample(seq, x, mosaic=None):
    """The 1x1 projection commutes with the tile mosaic, so the mosaic runs
    on the projected (narrower) features, as in the JAX module."""
    x = seq[0](x)
    if mosaic is not None:
        x = mosaic(x)
    for layer in list(seq)[1:]:
        x = layer(x)
    return x


class DepthProEncoder(nn.Module):
    def __init__(self, cfg: DepthProConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.encoder.embed_dim
        dims, dd = cfg.dims_encoder, cfg.decoder_features
        self.patch_encoder = ViT(cfg.encoder, cfg.hook_block_ids)
        self.image_encoder = ViT(cfg.encoder)
        self.upsample_latent0 = _proj_upsample(D, dd, 3, dim_int=dims[0])
        self.upsample_latent1 = _proj_upsample(D, dims[0], 2)
        self.upsample0 = _proj_upsample(D, dims[1], 1)
        self.upsample1 = _proj_upsample(D, dims[2], 1)
        self.upsample2 = _proj_upsample(D, dims[3], 1)
        self.upsample_lowres = _convT(D, dims[3], bias=True)
        self.fuse_lowres = _conv(2 * dims[3], dims[3], 1)

    def forward(self, x):
        """x: [B, 3, S, S] -> five NCHW maps, finest first."""
        cfg = self.cfg
        B, _, S, _ = x.shape
        tile, grid = cfg.tile_size, cfg.grid
        x_half = _downscale2tap(x, 2)
        x_quar = _downscale2tap(x, 4)
        n_f = (S - tile) // (3 * tile // 4) + 1
        n_m = (S // 2 - tile) // (tile // 2) + 1
        all_tiles = torch.cat([_tile(x, tile, 3 * tile // 4),
                               _tile(x_half, tile, tile // 2), x_quar])
        nf2, nm2 = B * n_f * n_f, B * n_m * n_m
        tokens, hooks = self.patch_encoder(all_tiles, hook_batch=nf2)
        trim_f = (grid - 3 * grid // 4) // 2
        trim_m = (grid - grid // 2) // 2

        def fine_maps(tok):
            return _tokens_to_map(tok[:nf2], grid)

        def mosaic_fine(m):
            return _mosaic(m, B, n_f, trim_f)

        def mosaic_mid(m):
            return _mosaic(m, B, n_m, trim_m)

        h0, h1 = cfg.hook_block_ids
        latent0 = _apply_proj_upsample(self.upsample_latent0,
                                       fine_maps(hooks[h0]), mosaic_fine)
        latent1 = _apply_proj_upsample(self.upsample_latent1,
                                       fine_maps(hooks[h1]), mosaic_fine)
        fine = _apply_proj_upsample(self.upsample0, fine_maps(tokens),
                                    mosaic_fine)
        mid = _apply_proj_upsample(
            self.upsample1, _tokens_to_map(tokens[nf2:nf2 + nm2], grid),
            mosaic_mid)
        coarse = _apply_proj_upsample(
            self.upsample2, _tokens_to_map(tokens[nf2 + nm2:], grid))
        img_tokens, _ = self.image_encoder(x_quar)
        glob = self.upsample_lowres(_tokens_to_map(img_tokens, grid))
        glob = self.fuse_lowres(torch.cat([coarse, glob], dim=1))
        return [latent0, latent1, fine, mid, glob]


class PreActResidual(nn.Sequential):
    """x + conv(relu(conv(relu(x)))); Sequential indices 1 and 3 are the
    convs, as in Apple's checkpoint."""

    def __init__(self, dim: int):
        super().__init__(nn.ReLU(), _conv(dim, dim, 3), nn.ReLU(),
                         _conv(dim, dim, 3))

    def forward(self, x):
        return x + super().forward(x)


class FeatureFusion(nn.Module):
    def __init__(self, dim: int, deconv: bool, skip: bool):
        super().__init__()
        if skip:
            self.resnet1 = PreActResidual(dim)
        self.resnet2 = PreActResidual(dim)
        if deconv:
            self.deconv = _convT(dim, dim)
        self.out_conv = _conv(dim, dim, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resnet1(skip)
        x = self.resnet2(x)
        if hasattr(self, "deconv"):
            x = self.deconv(x)
        return self.out_conv(x)


class MultiresConvDecoder(nn.Module):
    def __init__(self, cfg: DepthProConfig):
        super().__init__()
        dd, dims = cfg.decoder_features, cfg.dims_encoder
        self.convs = nn.ModuleList(
            [nn.Identity()] + [_conv(c, dd, 3, bias=False) for c in dims])
        self.fusions = nn.ModuleList(
            FeatureFusion(dd, deconv=i != 0, skip=i != 4) for i in range(5))

    def forward(self, encodings):
        """-> (the features at S/2, the projected global feature at S/32,
        which feeds the FOV head)."""
        projected = [conv(e) for conv, e in zip(self.convs, encodings)]
        x = self.fusions[4](projected[4])
        for i in (3, 2, 1, 0):
            x = self.fusions[i](x, projected[i])
        return x, projected[4]


class FOVNetwork(nn.Module):
    """Apple's FOVNetwork: the decoder's global feature strided down to the
    token grid, plus (with ``use_fov_encoder``) a third ViT on the quarter-
    size input through a Linear, then a funnel of stride-2 convolutions and
    a VALID ``grid/4`` one down to one scalar, the horizontal field of view
    in degrees (no activation). Every convolution pads ``k // 2`` on both
    sides, as the JAX module's ``_conv`` does, stride 2 included."""

    def __init__(self, cfg: DepthProConfig):
        super().__init__()
        self.grid = cfg.grid
        dd = cfg.decoder_features
        c4, c8 = math.ceil(dd / 4), math.ceil(dd / 8)
        down = [nn.Conv2d(dd, dd // 2, 3, stride=2, padding=1), nn.ReLU()]
        head = [nn.Conv2d(dd // 2, c4, 3, stride=2, padding=1), nn.ReLU(),
                nn.Conv2d(c4, c8, 3, stride=2, padding=1), nn.ReLU(),
                nn.Conv2d(c8, 1, cfg.grid // 4)]
        if cfg.use_fov_encoder:
            self.encoder = nn.Sequential(
                ViT(cfg.encoder), nn.Linear(cfg.encoder.embed_dim, dd // 2))
            self.downsample = nn.Sequential(*down)
        else:
            head = down + head
        self.head = nn.Sequential(*head)

    def forward(self, x, global_feature):
        """x: the model's [B, 3, S, S] input, already in its compute dtype
        (the JAX module casts before it downscales); -> [B] float32."""
        if hasattr(self, "encoder"):
            vit, neck = self.encoder
            tokens, _ = vit(_downscale2tap(x, 4))
            feat = (_tokens_to_map(neck(tokens), self.grid)
                    + self.downsample(global_feature))
        else:
            feat = global_feature
        return self.head(feat).reshape(-1).float()


class DepthPro(nn.Module):
    def __init__(self, cfg: DepthProConfig = DepthProConfig()):
        super().__init__()
        self.cfg = cfg
        dd = cfg.decoder_features
        self.encoder = DepthProEncoder(cfg)
        self.decoder = MultiresConvDecoder(cfg)
        self.head = nn.Sequential(
            _conv(dd, dd // 2, 3), _convT(dd // 2, dd // 2, bias=True),
            _conv(dd // 2, 32, 3), nn.ReLU(), _conv(32, 1, 1), nn.ReLU())
        if cfg.use_fov_head:
            self.fov = FOVNetwork(cfg)

    def forward(self, images):
        """images: [B, S, S, 3] in [-1, 1] -> {"canonical_inverse_depth":
        [B, S', S'] float32 (relative nearness), "fov_deg": [B] float32,
        the horizontal field of view (with the FOV head), "inverse_depth":
        the metric inverse depth, canonical * 2 tan(fov / 2) (canonical
        without the head)}. While tracing (``utils/profiling``) the encoder
        and the decoder with the head are device spans, "depth.encoder"
        and "depth.decoder"."""
        dt = self.head[0].weight.dtype
        x = images.permute(0, 3, 1, 2).to(dt)
        with span("depth.encoder", frames=x.shape[0], device=x.is_cuda):
            encodings = self.encoder(x)
        with span("depth.decoder", frames=x.shape[0], device=x.is_cuda):
            feats, glob = self.decoder(encodings)
            canonical = self.head(feats)[:, 0].float()
        out = {"canonical_inverse_depth": canonical}
        if not self.cfg.use_fov_head:
            out["inverse_depth"] = canonical
            return out
        fov_deg = self.fov(x, glob)
        # W / f_px with f_px = 0.5 W / tan(fov / 2), in float32
        tan_half = torch.tan(torch.deg2rad(fov_deg) / 2.0)
        out["fov_deg"] = fov_deg
        out["inverse_depth"] = canonical * (2.0 * tan_half)[:, None, None]
        return out
