"""
Weight carrier: JAX parameter tree -> the port's state_dict
===========================================================

Takes the JAX package's DepthPro (or bare ViT) parameters as numpy arrays,
flattened to "/"-joined names (``flax.core.meta.unbox(variables["params"])``
through ``vsc_tpu.models.convert._flatten``, or an npz written by
``vsc_tpu.models.convert.save_params``), and returns the port's
``state_dict``. It inverts the layout maps of
``vsc_tpu/models/convert.py:87-117``:

  Dense          [in, out]        -> Linear weight [out, in]
  Conv           [kh, kw, I, O]   -> Conv2d weight [O, I, kh, kw]
  ConvTranspose  [kh, kw, I, O]   -> ConvTranspose2d weight [I, O, kh, kw]
  LayerNorm      scale            -> weight
  fused qkv      per-head interleaved columns -> plain [q | k | v] rows

The carrier is strict both ways: every port parameter must be filled and
every JAX leaf consumed, with matching shapes, or it raises
``ConversionError``. Apple's ``depth_pro.pt`` also holds ``fov.*`` and the
unused ``decoder.fusions.4.resnet1.*``; a loader for that file drops them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ConversionError", "state_dict_from_jax", "load_jax_npz"]


class ConversionError(RuntimeError):
    pass


def _linear(w):
    return np.asarray(w).T


def _conv(w):
    return np.asarray(w).transpose(3, 2, 0, 1)


def _convT(w):
    return np.asarray(w).transpose(2, 3, 0, 1)


def _same(w):
    return np.asarray(w)


def _deinterleave_qkv(arr, num_heads: int):
    """Inverse of vsc_tpu.models.convert._interleave_qkv on the last axis:
    [q_h0 | k_h0 | v_h0 | q_h1 ...] -> [q_all | k_all | v_all]."""
    arr = np.asarray(arr)
    d3 = arr.shape[-1]
    dh = d3 // (3 * num_heads)
    x = arr.reshape(arr.shape[:-1] + (num_heads, 3, dh))
    x = np.moveaxis(x, -2, -3)          # [..., 3, heads, dh]
    return np.ascontiguousarray(x.reshape(arr.shape[:-1] + (d3,)))


def _vit_table(tp: str, jp: str, depth: int, heads: int) -> dict:
    """{port key: (jax key, transform)} for one ViT."""
    m = {f"{tp}cls_token": (f"{jp}cls_token", _same),
         f"{tp}pos_embed": (f"{jp}pos_embed", _same),
         f"{tp}patch_embed.proj.weight": (f"{jp}patch_embed/kernel", _conv),
         f"{tp}patch_embed.proj.bias": (f"{jp}patch_embed/bias", _same),
         f"{tp}norm.weight": (f"{jp}norm/scale", _same),
         f"{tp}norm.bias": (f"{jp}norm/bias", _same)}
    for i in range(depth):
        t, j = f"{tp}blocks.{i}.", f"{jp}block_{i}/"
        for ln in ("norm1", "norm2"):
            m[f"{t}{ln}.weight"] = (f"{j}{ln}/scale", _same)
            m[f"{t}{ln}.bias"] = (f"{j}{ln}/bias", _same)
        m[f"{t}attn.qkv.weight"] = (
            f"{j}attn/qkv/kernel",
            lambda w, h=heads: _deinterleave_qkv(w, h).T)
        m[f"{t}attn.qkv.bias"] = (
            f"{j}attn/qkv/bias", lambda b, h=heads: _deinterleave_qkv(b, h))
        for lin in ("attn/proj", "mlp/fc1", "mlp/fc2"):
            tk = lin.replace("/", ".")
            m[f"{t}{tk}.weight"] = (f"{j}{lin}/kernel", _linear)
            m[f"{t}{tk}.bias"] = (f"{j}{lin}/bias", _same)
        for ls in ("ls1", "ls2"):
            m[f"{t}{ls}.gamma"] = (f"{j}{ls}/gamma", _same)
    return m


def _depthpro_table(cfg) -> dict:
    """The port-side inverse of vsc_tpu.models.convert._apple_mapping (FOV
    off) plus both ViTs."""
    m = {}
    depth, heads = cfg.encoder.depth, cfg.encoder.num_heads
    m.update(_vit_table("encoder.patch_encoder.", "encoder/patch_encoder/",
                        depth, heads))
    m.update(_vit_table("encoder.image_encoder.", "encoder/image_encoder/",
                        depth, heads))

    def conv(tk, jk, bias):
        m[f"{tk}.weight"] = (f"{jk}/kernel", _conv)
        if bias:
            m[f"{tk}.bias"] = (f"{jk}/bias", _same)

    def convT(tk, jk, bias):
        m[f"{tk}.weight"] = (f"{jk}/kernel", _convT)
        if bias:
            m[f"{tk}.bias"] = (f"{jk}/bias", _same)

    for name, n_up in (("upsample_latent0", 3), ("upsample_latent1", 2),
                       ("upsample0", 1), ("upsample1", 1), ("upsample2", 1)):
        conv(f"encoder.{name}.0", f"encoder/{name}/proj", bias=False)
        for i in range(n_up):
            convT(f"encoder.{name}.{i + 1}", f"encoder/{name}/deconv{i}",
                  bias=False)
    convT("encoder.upsample_lowres", "encoder/upsample_lowres", bias=True)
    conv("encoder.fuse_lowres", "encoder/fuse_lowres", bias=True)
    for i in range(1, 5):
        conv(f"decoder.convs.{i}", f"decoder/conv_{i}", bias=False)
    for i in range(5):
        jk = f"decoder/fusion_{i}"
        for rn in (("resnet1", "resnet2") if i != 4 else ("resnet2",)):
            conv(f"decoder.fusions.{i}.{rn}.1", f"{jk}/{rn}/conv1", bias=True)
            conv(f"decoder.fusions.{i}.{rn}.3", f"{jk}/{rn}/conv2", bias=True)
        if i != 0:
            convT(f"decoder.fusions.{i}.deconv", f"{jk}/deconv", bias=False)
        conv(f"decoder.fusions.{i}.out_conv", f"{jk}/out_conv", bias=True)
    conv("head.0", "head_conv1", bias=True)
    convT("head.1", "head_deconv", bias=True)
    conv("head.2", "head_conv2", bias=True)
    conv("head.4", "head_out", bias=True)
    return m


def state_dict_from_jax(flat: dict, model) -> dict:
    """Flat JAX parameters {"a/b/kernel": ndarray} -> the port model's
    state_dict (float32 CPU tensors). ``model`` is a port ``DepthPro`` or
    ``ViT``; raises ConversionError unless both sides match exactly."""
    from vsc_tpu_torch.models.depthpro import DepthPro
    if isinstance(model, DepthPro):
        table = _depthpro_table(model.cfg)
    else:
        cfg = model.cfg
        table = _vit_table("", "", cfg.depth, cfg.num_heads)
    want = model.state_dict()
    problems = [f"port parameter with no JAX rule: {k}"
                for k in want if k not in table]
    out, used = {}, set()
    for key, ref in want.items():
        if key not in table:
            continue
        jk, fn = table[key]
        if jk not in flat:
            problems.append(f"missing JAX leaf {jk} for {key}")
            continue
        arr = fn(flat[jk])
        used.add(jk)
        if tuple(arr.shape) != tuple(ref.shape):
            problems.append(f"shape mismatch {key}: JAX {arr.shape} vs "
                            f"port {tuple(ref.shape)}")
            continue
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    problems += [f"unconsumed JAX leaf: {k}" for k in sorted(set(flat) - used)]
    if problems:
        raise ConversionError(
            f"parameter carry incomplete ({len(problems)} problems):\n  "
            + "\n  ".join(problems[:20]))
    return out


def load_jax_npz(path, model) -> None:
    """Load an npz written by vsc_tpu.models.convert.save_params into
    ``model`` (strict)."""
    with np.load(str(path)) as data:
        flat = {k: data[k] for k in data.files}
    model.load_state_dict(state_dict_from_jax(flat, model), strict=True)
