"""
Plain Depth Anything V2, the reference for the port's model
===========================================================

Depth Anything V2 (github.com/DepthAnything/Depth-Anything-V2,
``depth_anything_v2/dpt.py``, ``dinov2.py`` and ``util/transform.py``;
arXiv:2406.09414) written out in plain PyTorch: it imports neither JAX nor
the port. Module names are the keys of the official
``depth_anything_v2_vitl.pth`` (``pretrained.*``, ``depth_head.*``, the
mask token included), so ``load_official`` reads such a file as it is. The
same file serves the CPU tests (``tests/``) and the benchmark's output
check (``benchmark/reference/``, a byte copy).

``precision``:
  "float32"  the reference: float32 everywhere; the caller turns TF32 off
  "fp8"      the control: the inputs and weights of every matmul and
             convolution rounded to float8 e4m3 with one scale per tensor
             (amax / 448), the rest in float32

Also ``input_size_for`` (the repository's lower-bound resize rule),
``resize`` (its own cv2 INTER_CUBIC taps, and half-pixel bilinear taps)
and ``depth_u8`` (the port's depth step around the model).

Departures from the published code, each one a rule of the port's depth
step or of this file's use:
  - the frames are resized from u8 values on the 0-255 scale in float32
    with cv2's INTER_CUBIC weights (cv2 resizes the x / 255 float64 image),
    then normalized; the same function within float32 rounding;
  - the depth goes back to the frame with half-pixel bilinear taps
    (``align_corners=False``), not ``infer_image``'s
    ``align_corners=True``, then per-frame min-max and rounding to u8: the
    port's depth step does that for every model;
  - frames run as a batch (``infer_image`` takes one image);
  - the attention is softmax(q k^T / sqrt(d)) v as DINOv2's plain
    ``Attention`` computes it (no xformers); the ViT has no drop path,
    no register tokens and no masking (inference).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["DAv2Cfg", "DepthAnythingV2", "cfg_from_dict", "input_size_for",
           "resize", "load_official", "depth_u8", "MEAN", "STD"]

FP8_MAX = 448.0
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DAv2Cfg:
    """Defaults: Depth Anything V2 Large (ViT-L/14, DPT features 256)."""
    patch_size: int = 14
    pos_grid: int = 37
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    hooks: tuple = (4, 11, 17, 23)
    features: int = 256
    out_channels: tuple = (256, 512, 1024, 1024)
    input_size: int = 518


def cfg_from_dict(d: dict) -> DAv2Cfg:
    """A configuration file's "model" object -> DAv2Cfg."""
    enc = d["encoder"]
    return DAv2Cfg(patch_size=enc["patch_size"],
                   pos_grid=enc["img_size"] // enc["patch_size"],
                   embed_dim=enc["embed_dim"], depth=enc["depth"],
                   num_heads=enc["num_heads"], mlp_ratio=enc["mlp_ratio"],
                   hooks=tuple(d["hook_block_ids"]), features=d["features"],
                   out_channels=tuple(d["out_channels"]),
                   input_size=d["input_size"])


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


class Linear(nn.Module):
    def __init__(self, op, cin, cout):
        super().__init__()
        self.op = op
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        p = self.op.precision
        return F.linear(_lowp(x, p), _lowp(self.weight, p), self.bias)


class Conv(nn.Module):
    def __init__(self, op, cin, cout, k, stride=1, padding=0, bias=True):
        super().__init__()
        self.op, self.stride, self.padding = op, stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        p = self.op.precision
        return F.conv2d(_lowp(x, p), _lowp(self.weight, p), self.bias,
                        stride=self.stride, padding=self.padding)


class ConvT(nn.Module):
    """ConvTranspose k x k, stride k, no padding."""

    def __init__(self, op, cin, cout, k):
        super().__init__()
        self.op, self.k = op, k
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        p = self.op.precision
        return F.conv_transpose2d(_lowp(x, p), _lowp(self.weight, p),
                                  self.bias, stride=self.k)


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
        self.op, self.heads = op, heads
        self.qkv = Linear(op, dim, 3 * dim)
        self.proj = Linear(op, dim, dim)

    def forward(self, x):
        B, T, D = x.shape
        H, Dh = self.heads, D // self.heads
        q, k, v = self.qkv(x).view(B, T, 3, H, Dh).permute(2, 0, 3, 1, 4)
        p = self.op.precision
        logits = torch.matmul(_lowp(q * Dh ** -0.5, p),
                              _lowp(k, p).transpose(-1, -2))
        att = torch.softmax(logits, dim=-1)
        out = torch.matmul(_lowp(att, p), _lowp(v, p))
        return self.proj(out.transpose(1, 2).reshape(B, T, D))


class Block(nn.Module):
    def __init__(self, op, cfg: DAv2Cfg):
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
    def __init__(self, op, cfg: DAv2Cfg):
        super().__init__()
        self.proj = Conv(op, 3, cfg.embed_dim, cfg.patch_size,
                         stride=cfg.patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class DINOv2(nn.Module):
    def __init__(self, op, cfg: DAv2Cfg):
        super().__init__()
        D = cfg.embed_dim
        self.cfg = cfg
        self.patch_embed = PatchEmbed(op, cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, D))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + cfg.pos_grid ** 2, D))
        self.mask_token = nn.Parameter(torch.empty(1, D))
        self.blocks = nn.ModuleList(Block(op, cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=1e-6)

    def interpolate_pos_encoding(self, rows: int, cols: int):
        """dinov2.py's: the table as it is on its own square grid, else
        its grid through bicubic at scale ((rows + 0.1) / N, (cols + 0.1) /
        N) in float32, no antialias."""
        N = self.cfg.pos_grid
        if rows == cols == N:
            return self.pos_embed
        pe = self.pos_embed.float()
        D = pe.shape[-1]
        patch = F.interpolate(
            pe[:, 1:].reshape(1, N, N, D).permute(0, 3, 1, 2),
            scale_factor=((rows + 0.1) / N, (cols + 0.1) / N),
            mode="bicubic", antialias=False)
        assert patch.shape[-2:] == (rows, cols)
        patch = patch.permute(0, 2, 3, 1).reshape(1, -1, D)
        return torch.cat([pe[:, :1], patch], dim=1).to(self.pos_embed.dtype)

    def get_intermediate_layers(self, x):
        """The hooked blocks' outputs through the final norm, class token
        dropped: [B, rows * cols, D] each."""
        B, _, h, w = x.shape
        p = self.cfg.patch_size
        t = self.patch_embed(x)
        t = torch.cat([self.cls_token.expand(B, -1, -1), t], dim=1)
        t = t + self.interpolate_pos_encoding(h // p, w // p)
        outs = []
        for i, blk in enumerate(self.blocks):
            t = blk(t)
            if i in self.cfg.hooks:
                outs.append(t)
        return [self.norm(o)[:, 1:] for o in outs]


class RCU(nn.Module):
    """ResidualConvUnit: x + conv2(relu(conv1(relu(x))))."""

    def __init__(self, op, f):
        super().__init__()
        self.conv1 = Conv(op, f, f, 3, padding=1)
        self.conv2 = Conv(op, f, f, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class Fusion(nn.Module):
    """FeatureFusionBlock (no bn, no deconv, align_corners=True)."""

    def __init__(self, op, f):
        super().__init__()
        self.out_conv = Conv(op, f, f, 1)
        self.resConfUnit1 = RCU(op, f)
        self.resConfUnit2 = RCU(op, f)

    def forward(self, *xs, size=None):
        out = xs[0]
        if len(xs) == 2:
            out = out + self.resConfUnit1(xs[1])
        out = self.resConfUnit2(out)
        kw = {"scale_factor": 2} if size is None else {"size": size}
        out = F.interpolate(out, mode="bilinear", align_corners=True, **kw)
        return self.out_conv(out)


class DPTHead(nn.Module):
    def __init__(self, op, cfg: DAv2Cfg):
        super().__init__()
        D, f, oc = cfg.embed_dim, cfg.features, cfg.out_channels
        self.projects = nn.ModuleList(Conv(op, D, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            ConvT(op, oc[0], oc[0], 4), ConvT(op, oc[1], oc[1], 2),
            nn.Identity(), Conv(op, oc[3], oc[3], 3, stride=2, padding=1)])
        s = nn.Module()
        for i, c in enumerate(oc, 1):
            setattr(s, f"layer{i}_rn", Conv(op, c, f, 3, padding=1,
                                            bias=False))
        for i in range(1, 5):
            setattr(s, f"refinenet{i}", Fusion(op, f))
        s.output_conv1 = Conv(op, f, f // 2, 3, padding=1)
        s.output_conv2 = nn.Sequential(
            Conv(op, f // 2, 32, 3, padding=1), nn.ReLU(),
            Conv(op, 32, 1, 1), nn.ReLU(), nn.Identity())
        self.scratch = s

    def forward(self, feats, ph: int, pw: int, patch: int):
        outs = []
        for i, x in enumerate(feats):
            x = x.permute(0, 2, 1).reshape(x.shape[0], x.shape[-1], ph, pw)
            outs.append(self.resize_layers[i](self.projects[i](x)))
        s = self.scratch
        l1, l2, l3, l4 = (getattr(s, f"layer{i}_rn")(x)
                          for i, x in enumerate(outs, 1))
        p4 = s.refinenet4(l4, size=l3.shape[2:])
        p3 = s.refinenet3(p4, l3, size=l2.shape[2:])
        p2 = s.refinenet2(p3, l2, size=l1.shape[2:])
        p1 = s.refinenet1(p2, l1)
        out = s.output_conv1(p1)
        out = F.interpolate(out, (ph * patch, pw * patch), mode="bilinear",
                            align_corners=True)
        return s.output_conv2(out)


class DepthAnythingV2(nn.Module):
    """images [B, h, w, 3] normalized -> relative inverse depth [B, h, w]
    float32 (h, w multiples of the patch)."""

    def __init__(self, cfg: DAv2Cfg = DAv2Cfg(), precision: str = "float32"):
        super().__init__()
        self.cfg = cfg
        self._op = _Op()
        self._op.precision = precision
        self.pretrained = DINOv2(self._op, cfg)
        self.depth_head = DPTHead(self._op, cfg)

    def set_precision(self, precision: str) -> None:
        _lowp(torch.zeros(1), precision)        # refuse an unknown name
        self._op.precision = precision

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).to(torch.float32)
        p = self.cfg.patch_size
        ph, pw = x.shape[-2] // p, x.shape[-1] // p
        feats = self.pretrained.get_intermediate_layers(x)
        depth = self.depth_head(feats, ph, pw, p)
        return F.relu(depth)[:, 0]


def load_official(path, cfg: DAv2Cfg, device) -> DepthAnythingV2:
    """The reference model in float32 on ``device`` from a state dict in
    the official key layout that holds exactly its tensors."""
    state = torch.load(str(path), map_location="cpu", weights_only=True)
    with torch.device("meta"):
        model = DepthAnythingV2(cfg)
    model = model.to_empty(device=device)
    state = {k: v.to(device=device, dtype=torch.float32)
             for k, v in state.items()}
    model.load_state_dict(state, strict=True)
    return model.eval()


def input_size_for(height: int, width: int, input_size: int = 518,
                   multiple: int = 14) -> tuple:
    """transform.py's Resize(input_size, input_size, keep_aspect_ratio=True,
    ensure_multiple_of=multiple, resize_method="lower_bound").get_size."""
    scale_h, scale_w = input_size / height, input_size / width
    if scale_w > scale_h:
        scale_h = scale_w
    else:
        scale_w = scale_h

    def constrain(x):
        y = (np.round(x / multiple) * multiple).astype(int)
        if y < input_size:
            y = (np.ceil(x / multiple) * multiple).astype(int)
        return int(y)
    return constrain(scale_h * height), constrain(scale_w * width)


def _cubic_taps(src: int, dst: int):
    """cv2 resize's INTER_CUBIC: fx = float32((o + 0.5) * scale - 0.5),
    scale = 1 / (dst / src), taps floor(fx) - 1 .. + 2 clamped to the
    image, interpolateCubic's float32 weights with A = -0.75."""
    scale = 1.0 / (dst / src)
    fx = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx)
    x = (fx - sx).astype(np.float32)
    A, one = np.float32(-0.75), np.float32(1.0)
    c0 = ((A * (x + one) - 5 * A) * (x + one) + 8 * A) * (x + one) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + one
    c2 = ((A + 2) * (one - x) - (A + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(sx.astype(np.int64)[:, None] + np.arange(-1, 3), 0, src - 1)
    return idx, np.stack([c0, c1, c2, c3], axis=1).astype(np.float32)


def _bilinear_taps(src: int, dst: int):
    """Half-pixel bilinear (align_corners=False), edges clamped."""
    sx = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    x0 = np.floor(sx)
    f = (sx - x0).astype(np.float32)
    x0 = x0.astype(np.int64)
    idx = np.stack([np.clip(x0, 0, src - 1), np.clip(x0 + 1, 0, src - 1)], 1)
    return idx, np.stack([1.0 - f, f], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _taps(src: int, dst: int, method: str, device: str):
    idx, w = {"cubic": _cubic_taps, "bilinear": _bilinear_taps}[method](
        src, dst)
    return (torch.as_tensor(idx).to(device), torch.as_tensor(w).to(device))


def _resample(img, axis: int, dst: int, method: str):
    src = img.shape[axis]
    if src == dst:
        return img
    idx, w = _taps(src, dst, method, str(img.device))
    shape = [1] * img.ndim
    shape[axis] = dst
    out = None
    for t in range(idx.shape[1]):
        term = img.index_select(axis, idx[:, t]) * w[:, t].reshape(shape)
        out = term if out is None else out + term
    return out


def resize(img, out_h: int, out_w: int, method: str,
           channel_last: bool = False):
    """A float tensor resized over its last two axes ((-3, -2) with
    ``channel_last``), rows first."""
    h_axis = img.ndim - (3 if channel_last else 2)
    img = _resample(img, h_axis, out_h, method)
    return _resample(img, h_axis + 1, out_w, method)


@torch.no_grad()
def depth_u8(model: DepthAnythingV2, frames_u8, block: int = 1):
    """u8 frames [B, H, W, 3] on the model's device -> u8 depth [B, H, W],
    ``block`` frames at a time: cubic to ``input_size_for``, (x / 255 -
    mean) / std, the model, bilinear back, per-frame min-max, round."""
    cfg = model.cfg
    _, H, W, _ = frames_u8.shape
    h, w = input_size_for(H, W, cfg.input_size, cfg.patch_size)
    mean = torch.tensor(MEAN, device=frames_u8.device)
    std = torch.tensor(STD, device=frames_u8.device)
    outs = []
    for i in range(0, frames_u8.shape[0], block):
        x = resize(frames_u8[i:i + block].to(torch.float32), h, w, "cubic",
                   channel_last=True)
        d = model((x / 255.0 - mean) / std)
        d = resize(d, H, W, "bilinear")
        lo = d.amin(dim=(1, 2), keepdim=True)
        hi = d.amax(dim=(1, 2), keepdim=True)
        n = (d - lo) / torch.clamp(hi - lo, min=1e-12)
        outs.append(torch.round(n * 255.0).to(torch.uint8))
    return torch.cat(outs)


def init_seeded(model: DepthAnythingV2, seed: int) -> dict:
    """A state dict for ``model`` (the official key layout) drawn on the
    CPU from ``seed`` by the laws the port's seeded init follows (flax's:
    variance 2 / (fan_in + fan_out) for Linear and the patch convolution,
    1 / fan_in for every other convolution and transposed one, fan-in kh *
    kw * Cin; LayerNorm (1, 0), LayerScale 1, zero biases, class and mask
    tokens, position table N(0, 0.02)), in float32. The head's last 1x1
    convolution (``output_conv2.2``) takes the absolute values of its
    draw: its input is a ReLU's, so the depth is then >= 0 everywhere and
    the final ReLUs clip nothing, as a trained model's positive inverse
    depth; with signed weights the seeded model's depth is clipped to 0
    over most or all of the frame."""
    g = torch.Generator().manual_seed(int(seed))
    out = {}
    for name, p in model.state_dict().items():
        shape, std, mean = tuple(p.shape), 0.0, 0.0
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pos_embed":
            std = 0.02
        elif leaf == "gamma" or (leaf == "weight" and len(shape) == 1):
            mean = 1.0
        elif leaf == "weight" and "patch_embed" in name:
            k = shape[2] * shape[3]
            std = math.sqrt(2.0 / (shape[1] * k + shape[0] * k))
        elif leaf == "weight" and len(shape) == 2:
            std = math.sqrt(2.0 / (shape[0] + shape[1]))
        elif leaf == "weight" and (".resize_layers.0." in name
                                   or ".resize_layers.1." in name):
            std = math.sqrt(1.0 / (shape[0] * shape[2] * shape[3]))
        elif leaf == "weight":
            std = math.sqrt(1.0 / (shape[1] * shape[2] * shape[3]))
        t = torch.randn(shape, generator=g) * std + mean
        out[name] = t.abs() if name.endswith("output_conv2.2.weight") else t
    return out
