"""
Depth Anything V2 monocular depth estimator (PyTorch)
=====================================================

Depth Anything V2 (github.com/DepthAnything/Depth-Anything-V2,
``depth_anything_v2/dpt.py`` and ``dinov2.py``; arXiv:2406.09414): a
DINOv2 ViT encoder and a DPT head, here at the published Large widths
(ViT-L/14: embed 1024, 24 blocks, 16 heads, position table 37 x 37 + 1,
no register tokens; DPT features 256, out channels 256, 512, 1024, 1024).
Not in the JAX package, which has DepthPro alone; the port's own model.
Modules carry the keys of the official ``depth_anything_v2_vitl.pth``:

  pretrained                      the ViT (models/vit.py): patch_embed.proj,
                                  cls_token, pos_embed, blocks.{i}, norm
                                  (the file's ``pretrained.mask_token``,
                                  masked pretraining only, is not held)
  depth_head.projects.{0..3}      1x1 convs from the tokens
  depth_head.resize_layers.{0,1,3}
                                  ConvTranspose 4x4/s4, ConvTranspose
                                  2x2/s2, (identity), Conv 3x3/s2
  depth_head.scratch.layer{1..4}_rn
                                  3x3 convs to 256, no bias
  depth_head.scratch.refinenet{1..4}.{resConfUnit1, resConfUnit2}.{conv1,
                                  conv2}, .out_conv
  depth_head.scratch.output_conv1, output_conv2.{0,2}

``DepthAnythingV2.forward`` takes images [B, h, w, 3] (h, w multiples of
14, ImageNet-normalized: ``preprocess_frames``) and returns the relative
inverse depth [B, h, w] in float32, the same sense as DepthPro's
``canonical_inverse_depth``. Per hook (blocks 4, 11, 17, 23) the block's
output through the final ``norm``, the class token dropped, to a map
[B, 1024, h/14, w/14], its projection and resize layer; the four maps to
256 channels (``layerN_rn``); the fusion blocks from the coarsest up
(out = x + RCU1(skip), RCU2, bilinear ``align_corners=True`` to the next
map's size or x2, 1x1 ``out_conv``; RCU(x) = x + conv2(relu(conv1(relu(x))))),
``output_conv1``, bilinear ``align_corners=True`` to (h, w), 3x3 to 32,
ReLU, 1x1 to 1, ReLU, and the model's own final ReLU. Maps are [N, C, H,
W] in channels-last memory (the tokens' own order), as in DepthPro;
convolutions are cuDNN's, the bilinear passes ``F.interpolate``. While
tracing (``utils/profiling``) the encoder (patch embedding through the
last hooked norm) is the device span "depth.encoder" and the head (through
the final ReLU) "depth.decoder".

The input rule (``input_size_for``) is the repository's
``Resize(518, 518, keep_aspect_ratio=True, ensure_multiple_of=14,
resize_method="lower_bound")``: the side that scales less reaches 518,
both sides then rounded to a multiple of 14 (not below 518): 1080 x 1920
-> 518 x 924, portrait the transpose. ``DepthAnythingV2.prepare`` resizes
frames to it with cv2's INTER_CUBIC taps (``ops/resize``, "cubic") and
normalizes them, as ``DepthPro.prepare`` does for its own input;
``inverse_depth`` is the output both models share.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from vsc_tpu_torch.models.vit import ViT, ViTConfig
from vsc_tpu_torch.ops.resize import resize
from vsc_tpu_torch.utils.profiling import span

__all__ = ["DepthAnythingV2Config", "DepthAnythingV2", "input_size_for",
           "preprocess_frames", "IMAGENET_MEAN", "IMAGENET_STD",
           "IGNORED_KEYS"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# tensors of the official checkpoint the model has no use for
IGNORED_KEYS = ("pretrained.mask_token",)


@dataclasses.dataclass(frozen=True)
class DepthAnythingV2Config:
    """Defaults: Depth Anything V2 Large (``encoder='vitl'``)."""
    encoder: ViTConfig = ViTConfig(img_size=518, patch_size=14,
                                   embed_dim=1024, depth=24, num_heads=16,
                                   mlp_ratio=4.0, layerscale_init=1.0)
    hook_block_ids: tuple[int, ...] = (4, 11, 17, 23)
    features: int = 256
    out_channels: tuple[int, int, int, int] = (256, 512, 1024, 1024)
    input_size: int = 518

    def __post_init__(self):
        if len(self.hook_block_ids) != 4 or not all(
                0 <= i < self.encoder.depth for i in self.hook_block_ids):
            raise ValueError(f"hook_block_ids {self.hook_block_ids}: four "
                             f"blocks of the {self.encoder.depth}")

    @staticmethod
    def tiny() -> "DepthAnythingV2Config":
        """The same topology at test size: embed 32, 4 blocks, 2 heads,
        patch 2, a 6 x 6 table, features 16, input 12."""
        return DepthAnythingV2Config(
            encoder=ViTConfig(img_size=12, patch_size=2, embed_dim=32,
                              depth=4, num_heads=2, mlp_ratio=4.0,
                              layerscale_init=1.0),
            hook_block_ids=(0, 1, 2, 3), features=16,
            out_channels=(8, 16, 32, 32), input_size=12)


def input_size_for(height: int, width: int, input_size: int = 518,
                   multiple: int = 14) -> tuple[int, int]:
    """The model's (h, w) for a ``height`` x ``width`` frame: DAv2's
    lower-bound resize with the aspect kept (the side that scales less
    reaches ``input_size``), each side rounded to a multiple of
    ``multiple`` (half to even, as numpy rounds) and raised to the next
    one where that falls below ``input_size``."""
    sh, sw = input_size / height, input_size / width
    if sw > sh:
        sh = sw
    else:
        sw = sh

    def constrain(x):
        y = int(np.round(x / multiple) * multiple)
        if y < input_size:
            y = int(np.ceil(x / multiple) * multiple)
        return y
    return constrain(sh * height), constrain(sw * width)


@functools.lru_cache(maxsize=16)
def _imagenet(device: torch.device):
    """ImageNet's mean and std on ``device``, made once: a tensor made from
    host values on a card is a pageable copy, which waits for the stream
    and would stall the host every batch."""
    return (torch.tensor(IMAGENET_MEAN, device=device),
            torch.tensor(IMAGENET_STD, device=device))


def preprocess_frames(rgb):
    """RGB [B, H, W, 3] on the 0-255 scale (u8 or float) -> (x / 255 -
    mean) / std in float32, on the frames' device."""
    mean, std = _imagenet(rgb.device)
    return (rgb.to(torch.float32) / 255.0 - mean) / std


class ResidualConvUnit(nn.Module):
    """x + conv2(relu(conv1(relu(x)))), 3x3 convs with bias."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """DPT's fusion block as ``_make_fusion_block`` builds it (no batch
    norm, no deconv, ``align_corners=True``). The coarsest block never
    takes a skip, but holds ``resConfUnit1`` as the checkpoint does."""

    def __init__(self, features: int):
        super().__init__()
        self.out_conv = nn.Conv2d(features, features, 1)
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if size is None:
            x = F.interpolate(x, scale_factor=2, mode="bilinear",
                              align_corners=True)
        else:
            x = F.interpolate(x, size=size, mode="bilinear",
                              align_corners=True)
        return self.out_conv(x)


class DPTHead(nn.Module):
    def __init__(self, cfg: DepthAnythingV2Config):
        super().__init__()
        D, f, oc = cfg.encoder.embed_dim, cfg.features, cfg.out_channels
        self.projects = nn.ModuleList(nn.Conv2d(D, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        scratch = nn.Module()
        for i, c in enumerate(oc, 1):
            setattr(scratch, f"layer{i}_rn",
                    nn.Conv2d(c, f, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(scratch, f"refinenet{i}", FeatureFusionBlock(f))
        scratch.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        scratch.output_conv2 = nn.Sequential(
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU(), nn.Identity())
        self.scratch = scratch

    def forward(self, maps, out_hw):
        """maps: the four hooked token maps [B, D, h0, w0] -> [B, 1, h, w]
        (before the model's final ReLU)."""
        s = self.scratch
        layers = [rs(pj(m)) for m, pj, rs in
                  zip(maps, self.projects, self.resize_layers)]
        l1, l2, l3, l4 = (rn(x) for rn, x in zip(
            (s.layer1_rn, s.layer2_rn, s.layer3_rn, s.layer4_rn), layers))
        p = s.refinenet4(l4, size=l3.shape[2:])
        p = s.refinenet3(p, l3, size=l2.shape[2:])
        p = s.refinenet2(p, l2, size=l1.shape[2:])
        p = s.refinenet1(p, l1)
        out = F.interpolate(s.output_conv1(p), size=out_hw, mode="bilinear",
                            align_corners=True)
        return s.output_conv2(out)


class DepthAnythingV2(nn.Module):
    def __init__(self, cfg: DepthAnythingV2Config = DepthAnythingV2Config()):
        super().__init__()
        self.cfg = cfg
        self.pretrained = ViT(cfg.encoder, cfg.hook_block_ids)
        self.depth_head = DPTHead(cfg)

    def prepare(self, frames):
        """float32 frames [B, H, W, 3] on the 0-255 scale -> the input
        ``forward`` takes: resized with cv2's INTER_CUBIC taps to
        ``input_size_for`` at ``cfg.input_size``, then
        ``preprocess_frames``."""
        h, w = input_size_for(frames.shape[1], frames.shape[2],
                              self.cfg.input_size,
                              self.cfg.encoder.patch_size)
        return preprocess_frames(resize(frames, h, w, "cubic",
                                        channel_last=True))

    def inverse_depth(self, images):
        """``forward``: the model's output is the relative inverse depth."""
        return self(images)

    def forward(self, images):
        """images: [B, h, w, 3] normalized (``preprocess_frames``), h and w
        multiples of the patch size -> relative inverse depth [B, h, w]
        float32."""
        dt = self.depth_head.projects[0].weight.dtype
        x = images.permute(0, 3, 1, 2).to(dt)
        B, _, h, w = x.shape
        p = self.cfg.encoder.patch_size
        h0, w0 = h // p, w // p
        last = self.cfg.encoder.depth - 1
        with span("depth.encoder", frames=B, device=x.is_cuda):
            vit = self.pretrained
            tokens, hooks = vit(x)
            feats = [tokens if i == last else vit.norm(hooks[i])
                     for i in self.cfg.hook_block_ids]
        with span("depth.decoder", frames=B, device=x.is_cuda):
            maps = [f[:, 1:].reshape(B, h0, w0, -1).permute(0, 3, 1, 2)
                    for f in feats]
            depth = self.depth_head(maps, (h0 * p, w0 * p))
            return F.relu(depth)[:, 0].float()
