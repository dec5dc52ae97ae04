"""
Seeded DepthPro weights as an Apple-layout checkpoint
=====================================================

The benchmark makes the model's weights itself, on the device, from the
configuration's ``weights_seed``, at the scales of the port's seeded init
(the JAX package's flax laws: variance 2 / (fan_in + fan_out) for the ViT's
Linear layers and patch convolution, 1 / fan_in for the other convolutions
and the 2x2 transposed ones, LayerNorm (1, 0), LayerScale at its init
value, zero biases and cls token, position tables N(0, 0.02)), drawn as
normal values in three large calls and stored in bf16, the type the model
is served in. The file holds the tensors of Apple's ``depth_pro.pt`` that
a DepthPro without its FOV head reads, under Apple's names, so the
program loads it through its normal checkpoint path
(``build_depth_fn(..., checkpoint=...)``) and the reference reads the same
tensors.

The file is written once per checkout, under ``benchmark/.cache/``, and
read by every later run: about 1.2 GiB at the published widths.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from pathlib import Path

import torch
from torch import nn

from reference.depthpro import (ConvT2x2, Conv, DepthPro, DepthProCfg,
                                LayerScale, Linear, PatchEmbed, ViT)

__all__ = ["CACHE", "weight_specs", "weight_file"]

CACHE = Path(__file__).resolve().parents[1] / ".cache"


def weight_specs(cfg: DepthProCfg) -> list:
    """[(name, shape, mean, std)] of every tensor, in the model's order."""
    with torch.device("meta"):
        model = DepthPro(cfg)
    specs = []
    for mname, m in model.named_modules():
        own = dict(m.named_parameters(recurse=False))
        if isinstance(m, PatchEmbed):
            w = m.proj.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            fan_out = w.shape[0] * w.shape[2] * w.shape[3]
            specs.append((f"{mname}.proj.weight", w.shape, 0.0,
                          math.sqrt(2.0 / (fan_in + fan_out))))
            specs.append((f"{mname}.proj.bias", m.proj.bias.shape, 0.0, 0.0))
            continue
        if mname.endswith(".proj") and isinstance(
                model.get_submodule(mname.rsplit(".", 1)[0]), PatchEmbed):
            continue
        for pname, p in own.items():
            full = f"{mname}.{pname}" if mname else pname
            mean, std = 0.0, 0.0
            if pname == "bias":
                pass
            elif isinstance(m, Linear):
                std = math.sqrt(2.0 / (p.shape[0] + p.shape[1]))
            elif isinstance(m, Conv):
                std = math.sqrt(1.0 / p[0].numel())
            elif isinstance(m, ConvT2x2):
                std = math.sqrt(1.0 / (p.shape[0] * 4))
            elif isinstance(m, nn.LayerNorm):
                mean = 1.0
            elif isinstance(m, LayerScale):
                mean = cfg.encoder.layerscale_init
            elif isinstance(m, ViT) and pname == "pos_embed":
                std = 0.02
            elif isinstance(m, ViT) and pname == "cls_token":
                pass
            else:
                raise ValueError(f"no init law for {full}")
            specs.append((full, tuple(p.shape), mean, std))
    return specs


@torch.no_grad()
def _draw(cfg: DepthProCfg, seed: int, device) -> dict:
    specs = weight_specs(cfg)
    counts = torch.tensor([math.prod(s[1]) for s in specs], device=device)
    means = torch.tensor([s[2] for s in specs], device=device)
    stds = torch.tensor([s[3] for s in specs], device=device)
    n = int(counts.sum())
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(n, generator=g, device=device)
    flat.mul_(torch.repeat_interleave(stds, counts))
    flat.add_(torch.repeat_interleave(means, counts))
    flat = flat.to(torch.bfloat16).cpu()
    out, off = {}, 0
    for name, shape, _, _ in specs:
        k = math.prod(shape)
        out[name] = flat[off:off + k].view(shape)
        off += k
    return out


def weight_file(model: dict, cfg: DepthProCfg, seed: int, device) -> Path:
    """The checkpoint of ``model`` (the configuration's "model" object)
    drawn from ``seed``: made on ``device`` and written on first use,
    atomically, then found by its name."""
    tag = hashlib.sha256(json.dumps(model, sort_keys=True).encode()
                         ).hexdigest()[:12]
    path = CACHE / "weights" / f"depthpro-{tag}-seed{int(seed)}.pt"
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    state = _draw(cfg, seed, device)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    try:
        torch.save(state, str(tmp))
        tmp.replace(path)
    finally:
        tmp.unlink(missing_ok=True)
    return path
