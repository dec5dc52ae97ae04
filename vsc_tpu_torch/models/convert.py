"""
Checkpoints: the JAX parameter tree, Apple's and HuggingFace's files
=====================================================================

Three formats load into the port's DepthPro (and the first into a bare
ViT), each strictly both ways: every port parameter must be filled and
every tensor of the file consumed (less the ones named below), with
matching shapes, or ``ConversionError`` is raised.

1. The JAX package's parameter tree, flattened to "/"-joined names
   (``flax.core.meta.unbox(variables["params"])`` through
   ``vsc_tpu.models.convert._flatten``, or an npz written by
   ``vsc_tpu.models.convert.save_params``, which is also the weight cache
   of ``models/bootstrap.py``): ``state_dict_from_jax`` inverts the layout
   maps of ``vsc_tpu/models/convert.py:87-117``, and ``jax_flat_from_state_dict``
   applies them, so the port writes the cache the JAX package reads:

     Dense          [in, out]        <-> Linear weight [out, in]
     Conv           [kh, kw, I, O]   <-> Conv2d weight [O, I, kh, kw]
     ConvTranspose  [kh, kw, I, O]   <-> ConvTranspose2d weight [I, O, kh, kw]
     LayerNorm      scale            <-> weight
     fused qkv      per-head interleaved columns <-> plain [q | k | v] rows

2. Apple's ml-depth-pro ``depth_pro.pt``: the port's module names are its
   keys, so the table is the identity (``vsc_tpu/models/convert.py``'s
   ``_apple_mapping`` composed with the port's inverse of it).
3. HuggingFace's ``apple/DepthPro-hf`` (transformers
   ``DepthProForDepthEstimation``), ``model.safetensors`` or a ``.pt`` of
   its state dict: its DINOv2 names are renamed to Apple's (separate q, k, v
   projections stacked into one) and the rest through
   ``vsc_tpu/models/convert.py``'s ``_hf_mapping`` composed with Apple's.

4. Depth Anything V2's official ``depth_anything_v2_vitl.pth``
   (``depth_anything_v2_state_dict``): the port's module names are its keys
   (``models/depth_anything.py``), less ``pretrained.mask_token``, which
   is dropped; anything else missing, unexpected or of another shape
   raises.

``convert_torch_checkpoint`` reads 2 and 3 (``.safetensors`` by
``read_safetensors``, which needs no ``safetensors`` package; ``.pt`` and
``.pth`` by ``torch.load(weights_only=True)``). The FOV head maps in all
three formats: Apple's ``fov.encoder.0`` (timm's ViT), ``fov.encoder.1``
(the Linear neck), ``fov.downsample.0`` and ``fov.head.{0,2,4}`` (without
the FOV encoder ``fov.head.{0,2,4,6}``, the downsample conv first); HF's
``fov_model.fov_encoder.model`` (DINOv2), ``.neck``, ``fov_model.conv`` and
``fov_model.head.layers.{0,2,4}``; the JAX tree's ``fov/...``. Both files
hold tensors a model may have no use for, and the converters drop exactly
those: the FOV head's (``fov.*`` / ``fov_model.*``) when the model has no
head, the FOV encoder's when it has the head without the encoder (as the
JAX package's conversion leaves them unread), the coarsest fusion block's
first residual (``decoder.fusions.4.resnet1.*`` / ``fusion_stage.
intermediate.0.residual_layer1.*``: that block has no skip input) and
DINOv2's ``mask_token`` (masked pretraining only). A model with the head
refuses a file without its tensors and names them, as the JAX package's
``convert_torch_checkpoint`` does. A position table trained at another
tile grid is resized as the JAX package resizes it (Keys cubic,
``jax.image.resize``), the FOV encoder's too.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch

__all__ = ["ConversionError", "state_dict_from_jax", "load_jax_npz",
           "jax_flat_from_state_dict", "convert_state_dict",
           "convert_torch_checkpoint", "read_safetensors",
           "interpolate_pos_embedding", "depth_anything_v2_state_dict"]


class ConversionError(RuntimeError):
    pass


def _interleave_qkv(arr, num_heads: int):
    """[q_all | k_all | v_all] -> per-head interleaved [q_h0 | k_h0 | v_h0 |
    q_h1 ...] on the last axis (``vsc_tpu.models.convert._interleave_qkv``)."""
    arr = np.asarray(arr)
    d3 = arr.shape[-1]
    dh = d3 // (3 * num_heads)
    x = arr.reshape(arr.shape[:-1] + (3, num_heads, dh))
    x = np.moveaxis(x, -3, -2)          # [..., heads, 3, dh]
    return np.ascontiguousarray(x.reshape(arr.shape[:-1] + (d3,)))


def _deinterleave_qkv(arr, num_heads: int):
    """Inverse of ``_interleave_qkv``."""
    arr = np.asarray(arr)
    d3 = arr.shape[-1]
    dh = d3 // (3 * num_heads)
    x = arr.reshape(arr.shape[:-1] + (num_heads, 3, dh))
    x = np.moveaxis(x, -2, -3)          # [..., 3, heads, dh]
    return np.ascontiguousarray(x.reshape(arr.shape[:-1] + (d3,)))


# layout transforms by name: (JAX leaf -> port tensor, port tensor -> JAX
# leaf); "qkv_w" and "qkv_b" take the head count
_TO_PORT = {
    "linear": lambda w: np.asarray(w).T,
    "conv": lambda w: np.asarray(w).transpose(3, 2, 0, 1),
    "convT": lambda w: np.asarray(w).transpose(2, 3, 0, 1),
    "same": np.asarray,
    "qkv_w": lambda w, h: _deinterleave_qkv(w, h).T,
    "qkv_b": _deinterleave_qkv,
}
_TO_JAX = {
    "linear": lambda w: np.asarray(w).T,
    "conv": lambda w: np.asarray(w).transpose(2, 3, 1, 0),
    "convT": lambda w: np.asarray(w).transpose(2, 3, 0, 1),
    "same": np.asarray,
    "qkv_w": lambda w, h: _interleave_qkv(np.asarray(w).T, h),
    "qkv_b": _interleave_qkv,
}


def _vit_table(tp: str, jp: str, depth: int) -> dict:
    """{port key: (jax key, transform name)} for one ViT."""
    m = {f"{tp}cls_token": (f"{jp}cls_token", "same"),
         f"{tp}pos_embed": (f"{jp}pos_embed", "same"),
         f"{tp}patch_embed.proj.weight": (f"{jp}patch_embed/kernel", "conv"),
         f"{tp}patch_embed.proj.bias": (f"{jp}patch_embed/bias", "same"),
         f"{tp}norm.weight": (f"{jp}norm/scale", "same"),
         f"{tp}norm.bias": (f"{jp}norm/bias", "same")}
    for i in range(depth):
        t, j = f"{tp}blocks.{i}.", f"{jp}block_{i}/"
        for ln in ("norm1", "norm2"):
            m[f"{t}{ln}.weight"] = (f"{j}{ln}/scale", "same")
            m[f"{t}{ln}.bias"] = (f"{j}{ln}/bias", "same")
        m[f"{t}attn.qkv.weight"] = (f"{j}attn/qkv/kernel", "qkv_w")
        m[f"{t}attn.qkv.bias"] = (f"{j}attn/qkv/bias", "qkv_b")
        for lin in ("attn/proj", "mlp/fc1", "mlp/fc2"):
            tk = lin.replace("/", ".")
            m[f"{t}{tk}.weight"] = (f"{j}{lin}/kernel", "linear")
            m[f"{t}{tk}.bias"] = (f"{j}{lin}/bias", "same")
        for ls in ("ls1", "ls2"):
            m[f"{t}{ls}.gamma"] = (f"{j}{ls}/gamma", "same")
    return m


def _depthpro_table(cfg) -> dict:
    """The port-side inverse of vsc_tpu.models.convert._apple_mapping plus
    every ViT."""
    m = {}
    depth = cfg.encoder.depth
    vits = [("encoder.patch_encoder.", "encoder/patch_encoder/"),
            ("encoder.image_encoder.", "encoder/image_encoder/")]
    if cfg.use_fov_head and cfg.use_fov_encoder:
        vits.append(("fov.encoder.0.", "fov/encoder_vit/"))
    for tp, jp in vits:
        m.update(_vit_table(tp, jp, depth))

    def conv(tk, jk, bias, kind="conv"):
        m[f"{tk}.weight"] = (f"{jk}/kernel", kind)
        if bias:
            m[f"{tk}.bias"] = (f"{jk}/bias", "same")

    for name, n_up in (("upsample_latent0", 3), ("upsample_latent1", 2),
                       ("upsample0", 1), ("upsample1", 1), ("upsample2", 1)):
        conv(f"encoder.{name}.0", f"encoder/{name}/proj", bias=False)
        for i in range(n_up):
            conv(f"encoder.{name}.{i + 1}", f"encoder/{name}/deconv{i}",
                 bias=False, kind="convT")
    conv("encoder.upsample_lowres", "encoder/upsample_lowres", bias=True,
         kind="convT")
    conv("encoder.fuse_lowres", "encoder/fuse_lowres", bias=True)
    for i in range(1, 5):
        conv(f"decoder.convs.{i}", f"decoder/conv_{i}", bias=False)
    for i in range(5):
        jk = f"decoder/fusion_{i}"
        for rn in (("resnet1", "resnet2") if i != 4 else ("resnet2",)):
            conv(f"decoder.fusions.{i}.{rn}.1", f"{jk}/{rn}/conv1", bias=True)
            conv(f"decoder.fusions.{i}.{rn}.3", f"{jk}/{rn}/conv2", bias=True)
        if i != 0:
            conv(f"decoder.fusions.{i}.deconv", f"{jk}/deconv", bias=False,
                 kind="convT")
        conv(f"decoder.fusions.{i}.out_conv", f"{jk}/out_conv", bias=True)
    conv("head.0", "head_conv1", bias=True)
    conv("head.1", "head_deconv", bias=True, kind="convT")
    conv("head.2", "head_conv2", bias=True)
    conv("head.4", "head_out", bias=True)
    if cfg.use_fov_head:
        jks = ["fov/downsample_conv", "fov/head_conv0", "fov/head_conv1",
               "fov/head_out"]
        if cfg.use_fov_encoder:
            m["fov.encoder.1.weight"] = ("fov/encoder_linear/kernel",
                                         "linear")
            m["fov.encoder.1.bias"] = ("fov/encoder_linear/bias", "same")
            conv("fov.downsample.0", jks.pop(0), bias=True)
        for i, jk in enumerate(jks):
            conv(f"fov.head.{2 * i}", jk, bias=True)
    return m


def _table(model) -> tuple[dict, int]:
    """(the table, the head count) of a port ``DepthPro`` or ``ViT``."""
    from vsc_tpu_torch.models.depthpro import DepthPro
    if isinstance(model, DepthPro):
        return _depthpro_table(model.cfg), model.cfg.encoder.num_heads
    return _vit_table("", "", model.cfg.depth), model.cfg.num_heads


def _apply(fns: dict, kind: str, arr, heads: int):
    return fns[kind](arr, heads) if kind.startswith("qkv") else \
        fns[kind](arr)


def _raise_if(problems: list[str], what: str) -> None:
    if problems:
        raise ConversionError(
            f"{what} incomplete ({len(problems)} problems):\n  "
            + "\n  ".join(problems[:20]))


def state_dict_from_jax(flat: dict, model) -> dict:
    """Flat JAX parameters {"a/b/kernel": ndarray} -> the port model's
    state_dict (float32 CPU tensors). ``model`` is a port ``DepthPro`` or
    ``ViT``; raises ConversionError unless both sides match exactly."""
    table, heads = _table(model)
    want = model.state_dict()
    problems = [f"port parameter with no JAX rule: {k}"
                for k in want if k not in table]
    out, used = {}, set()
    for key, ref in want.items():
        if key not in table:
            continue
        jk, kind = table[key]
        if jk not in flat:
            problems.append(f"missing JAX leaf {jk} for {key}")
            continue
        arr = _apply(_TO_PORT, kind, flat[jk], heads)
        used.add(jk)
        if tuple(arr.shape) != tuple(ref.shape):
            problems.append(f"shape mismatch {key}: JAX {arr.shape} vs "
                            f"port {tuple(ref.shape)}")
            continue
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    problems += [f"unconsumed JAX leaf: {k}" for k in sorted(set(flat) - used)]
    _raise_if(problems, "parameter carry")
    return out


def jax_flat_from_state_dict(state: dict, model) -> dict:
    """The inverse of ``state_dict_from_jax``: the port model's state_dict
    -> flat JAX parameters {"a/b/kernel": float32 ndarray}, the layout
    ``vsc_tpu.models.convert.save_params`` writes and ``load_params``
    reads. Strict both ways."""
    table, heads = _table(model)
    problems = [f"port tensor with no JAX rule: {k}"
                for k in state if k not in table]
    problems += [f"missing port tensor: {k}" for k in table if k not in state]
    _raise_if(problems, "parameter carry")
    return {jk: np.ascontiguousarray(_apply(
                _TO_JAX, kind, state[key].detach().float().cpu().numpy(),
                heads), dtype=np.float32)
            for key, (jk, kind) in table.items()}


def load_jax_npz(path, model) -> None:
    """Load an npz written by vsc_tpu.models.convert.save_params into
    ``model`` (strict)."""
    with np.load(str(path)) as data:
        flat = {k: data[k] for k in data.files}
    model.load_state_dict(state_dict_from_jax(flat, model), strict=True)


# --------------------------------------------------------------------------
# Apple's depth_pro.pt and HuggingFace's apple/DepthPro-hf

# tensors of the files that no port DepthPro uses, by format; then those of
# the FOV head and those of its encoder, used only by a model that has them
_UNUSED = {"apple": r"^decoder\.fusions\.4\.resnet1\.|\.mask_token$",
           "hf": r"^fusion_stage\.intermediate\.0\.residual_layer1\."
                 r"|\.mask_token$"}
_FOV = {"apple": (r"^fov\.", r"^fov\.encoder\."),
        "hf": (r"^fov_model\.", r"^fov_model\.fov_encoder\.")}


def _unused(fmt: str, cfg):
    """The pattern of the tensors of a ``fmt`` file that a model of
    ``cfg`` has no use for."""
    head, encoder = _FOV[fmt]
    extra = ("" if cfg.use_fov_head and cfg.use_fov_encoder else
             "|" + (encoder if cfg.use_fov_head else head))
    return re.compile(_UNUSED[fmt] + extra)


# HF DINOv2 names -> Apple's (timm's) within one ViT; q, k, v apart
_HF_VITS = {"depth_pro.encoder.patch_encoder.model.": "encoder.patch_encoder.",
            "depth_pro.encoder.image_encoder.model.": "encoder.image_encoder.",
            "fov_model.fov_encoder.model.": "fov.encoder.0."}
_HF_VIT_RENAMES = [
    (re.compile(r"^embeddings\.cls_token$"), "cls_token"),
    (re.compile(r"^embeddings\.position_embeddings$"), "pos_embed"),
    (re.compile(r"^embeddings\.patch_embeddings\.projection\."),
     "patch_embed.proj."),
    (re.compile(r"^encoder\.layer\.(\d+)\.attention\.output\.dense\."),
     r"blocks.\1.attn.proj."),
    (re.compile(r"^encoder\.layer\.(\d+)\.layer_scale([12])\.lambda1$"),
     r"blocks.\1.ls\2.gamma"),
    (re.compile(r"^encoder\.layer\.(\d+)\.(norm[12]|mlp\.fc[12])\."),
     r"blocks.\1.\2."),
    (re.compile(r"^layernorm\."), "norm."),
]
_HF_QKV = re.compile(r"^encoder\.layer\.(\d+)\.attention\.attention\."
                     r"(query|key|value)\.(weight|bias)$")


def _hf_names() -> dict:
    """{HF key: JAX name} of the non-ViT tensors: the names of
    ``vsc_tpu/models/convert.py``'s ``_hf_mapping`` with the FOV head and
    its encoder on."""
    m = {}

    def conv(tk, jk, bias):
        m[f"{tk}.weight"] = f"{jk}/kernel"
        if bias:
            m[f"{tk}.bias"] = f"{jk}/bias"

    up = "depth_pro.neck.feature_upsample"
    conv(f"{up}.image_block.layers.0", "encoder/upsample_lowres", bias=True)
    # scaled_images are listed lowest-resolution first
    for hf_i, name in ((0, "upsample2"), (1, "upsample1"), (2, "upsample0")):
        conv(f"{up}.scaled_images.{hf_i}.layers.0",
             f"encoder/{name}/proj", bias=False)
        conv(f"{up}.scaled_images.{hf_i}.layers.1",
             f"encoder/{name}/deconv0", bias=False)
    for hf_i, (name, n_up) in ((0, ("upsample_latent1", 2)),
                               (1, ("upsample_latent0", 3))):
        conv(f"{up}.intermediate.{hf_i}.layers.0", f"encoder/{name}/proj",
             bias=False)
        for k in range(n_up):
            conv(f"{up}.intermediate.{hf_i}.layers.{k + 1}",
                 f"encoder/{name}/deconv{k}", bias=False)
    conv("depth_pro.neck.fuse_image_with_low_res", "encoder/fuse_lowres",
         bias=True)
    for hf_i, mine in ((0, 4), (1, 3), (2, 2), (3, 1)):
        conv(f"depth_pro.neck.feature_projection.projections.{hf_i}",
             f"decoder/conv_{mine}", bias=False)

    def fusion(tk, jk, deconv):
        for hf_rn, rn in (("residual_layer1", "resnet1"),
                          ("residual_layer2", "resnet2")):
            conv(f"{tk}.{hf_rn}.convolution1", f"{jk}/{rn}/conv1", bias=True)
            conv(f"{tk}.{hf_rn}.convolution2", f"{jk}/{rn}/conv2", bias=True)
        if deconv:
            conv(f"{tk}.deconv", f"{jk}/deconv", bias=False)
        conv(f"{tk}.projection", f"{jk}/out_conv", bias=True)

    for hf_i, mine in ((0, 4), (1, 3), (2, 2), (3, 1)):
        fusion(f"fusion_stage.intermediate.{hf_i}", f"decoder/fusion_{mine}",
               deconv=True)
    fusion("fusion_stage.final", "decoder/fusion_0", deconv=False)
    conv("head.layers.0", "head_conv1", bias=True)
    conv("head.layers.1", "head_deconv", bias=True)
    conv("head.layers.2", "head_conv2", bias=True)
    conv("head.layers.4", "head_out", bias=True)
    conv("fov_model.conv", "fov/downsample_conv", bias=True)
    for hf_i, jk in ((0, "head_conv0"), (2, "head_conv1"), (4, "head_out")):
        conv(f"fov_model.head.layers.{hf_i}", f"fov/{jk}", bias=True)
    conv("fov_model.fov_encoder.neck", "fov/encoder_linear", bias=True)
    return m


def _hf_to_apple(state: dict, cfg) -> dict:
    """HF keys -> Apple's; a key no rule knows keeps its HF name (and is
    then reported as unconsumed)."""
    to_port = {jk: pk for pk, (jk, _) in _depthpro_table(cfg).items()}
    non_vit = _hf_names()
    out, qkv = {}, {}
    for key, t in state.items():
        prefix = next((p for p in _HF_VITS if key.startswith(p)), None)
        if prefix is None:
            jk = non_vit.get(key)
            out[to_port[jk] if jk in to_port else key] = t
            continue
        rel, ap = key[len(prefix):], _HF_VITS[prefix]
        m = _HF_QKV.match(rel)
        if m:
            blk, part, kind = m.groups()
            qkv.setdefault(f"{ap}blocks.{blk}.attn.qkv.{kind}", {})[part] = t
            continue
        for pat, repl in _HF_VIT_RENAMES:
            if pat.match(rel):
                out[ap + pat.sub(repl, rel, count=1)] = t
                break
        else:
            out[key] = t
    for key, parts in qkv.items():
        if set(parts) != {"query", "key", "value"}:
            raise ConversionError(f"{key}: the checkpoint holds only "
                                  f"{sorted(parts)} of query, key, value")
        out[key] = torch.cat([torch.as_tensor(parts[p]) for p in
                              ("query", "key", "value")], dim=0)
    return out


def _detect_format(state: dict) -> str:
    if any(k.startswith(("depth_pro.", "fusion_stage.")) for k in state):
        return "hf"
    if any(k.startswith("encoder.patch_encoder.") for k in state):
        return "apple"
    raise ConversionError(
        "unrecognized checkpoint format: expected Apple ml-depth-pro keys "
        "(encoder.patch_encoder.*) or transformers DepthPro keys "
        "(depth_pro.*/fusion_stage.*)")


def _keys_cubic(x):
    """The Keys cubic kernel (a = -0.5) of jax.image.resize."""
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in: int, n_out: int):
    """[n_in, n_out] weights of jax.image.resize(method="cubic",
    antialias=True) along one axis (``compute_weight_mat``)."""
    inv = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    w = _keys_cubic((sample[None, :] - np.arange(n_in)[:, None])
                    / max(inv, 1.0))
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def interpolate_pos_embedding(pos, src_grid: int, dst_grid: int):
    """Resize a [1, 1 + src^2, D] position table to [1, 1 + dst^2, D] as
    ``vsc_tpu.models.vit.interpolate_pos_embedding`` does (the cls row kept,
    the grid through jax.image.resize's cubic weights, in float64)."""
    pos = np.asarray(pos)
    if src_grid == dst_grid:
        return pos
    D = pos.shape[-1]
    grid = pos[0, 1:].reshape(src_grid, src_grid, D).astype(np.float64)
    w = _resize_weights(src_grid, dst_grid)
    grid = np.einsum("hwd,hH,wW->HWd", grid, w, w)
    return np.concatenate([pos[:, :1], grid.reshape(1, -1, D).astype(
        pos.dtype)], axis=1)


def convert_state_dict(state: dict, model) -> dict:
    """An Apple (``depth_pro.pt``) or HF (``apple/DepthPro-hf``) state dict
    -> the port ``DepthPro``'s state_dict (float32 CPU tensors). The
    tensors the model has no use for (the FOV head's or its encoder's where
    the model lacks them, the coarsest fusion block's first residual,
    DINOv2's mask token) are dropped; any other tensor left over, any port
    parameter left unfilled (a model with the FOV head and a file without
    it) or a shape that disagrees raises ConversionError. Position tables
    of another tile grid are resized."""
    fmt = _detect_format(state)
    unused = _unused(fmt, model.cfg)
    state = {k: v for k, v in state.items() if not unused.search(k)}
    if fmt == "hf":
        state = _hf_to_apple(state, model.cfg)
    want = model.state_dict()
    problems = [f"unused checkpoint tensor: {k}"
                for k in sorted(set(state) - set(want))]
    out = {}
    for key, ref in want.items():
        if key not in state:
            problems.append(f"missing checkpoint tensor: {key} "
                            f"{tuple(ref.shape)}")
            continue
        arr = np.asarray(torch.as_tensor(state[key]).float().cpu())
        if key.endswith("pos_embed") and arr.shape != tuple(ref.shape):
            arr = interpolate_pos_embedding(
                arr, int(round((arr.shape[1] - 1) ** 0.5)),
                int(round((ref.shape[1] - 1) ** 0.5)))
        if tuple(arr.shape) != tuple(ref.shape):
            problems.append(f"shape mismatch {key}: checkpoint {arr.shape} "
                            f"vs port {tuple(ref.shape)}")
            continue
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    _raise_if(problems, f"checkpoint conversion ({fmt} format)")
    return out


# safetensors dtype tags -> torch
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path) -> dict:
    """A ``.safetensors`` file -> {name: CPU tensor}, without the
    ``safetensors`` package: an 8-byte little-endian header length, a JSON
    header ({name: {"dtype", "shape", "data_offsets": [begin, end]}}, plus
    "__metadata__"), then the raw little-endian tensors, offsets counted
    from the end of the header."""
    path = Path(path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = bytearray(path.stat().st_size - 8 - n)
        if f.readinto(buf) != len(buf):
            raise ConversionError(f"{path}: truncated safetensors file")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ConversionError(f"{path}: tensor {name} has dtype "
                                  f"{info['dtype']}, which the reader "
                                  f"does not take")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        size = torch.empty((), dtype=dtype).element_size()
        if end - begin != size * int(np.prod(shape, dtype=np.int64)):
            raise ConversionError(f"{path}: tensor {name} holds {end - begin}"
                                  f" bytes for shape {shape}")
        # the tensors share the file's buffer
        t = torch.frombuffer(buf, dtype=dtype, count=(end - begin) // size,
                             offset=begin) if end > begin else \
            torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def convert_torch_checkpoint(path, model) -> dict:
    """Read an Apple or HF DepthPro checkpoint (``.safetensors``, or a
    ``.pt`` / ``.pth`` state dict, possibly under "state_dict") and convert
    it with ``convert_state_dict`` into the port model's state_dict."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(path)
    if path.suffix == ".safetensors":
        state = read_safetensors(path)
    else:
        # weights_only: never run pickled code from a downloaded file
        state = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return convert_state_dict(state, model)


def depth_anything_v2_state_dict(path, model) -> dict:
    """An official Depth Anything V2 checkpoint (``.pth`` / ``.pt``, possibly
    under "state_dict" or "model", or ``.safetensors``) -> the port model's
    state_dict, in its dtypes: the keys are the model's own, less
    ``IGNORED_KEYS`` (the mask token); anything missing, unexpected or of
    another shape raises ``ConversionError``, naming the keys."""
    from vsc_tpu_torch.models.depth_anything import IGNORED_KEYS
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(path)
    if path.suffix == ".safetensors":
        state = read_safetensors(path)
    else:
        # weights_only: never run pickled code from a downloaded file
        state = torch.load(str(path), map_location="cpu", weights_only=True)
    for wrap in ("state_dict", "model"):
        if isinstance(state, dict) and isinstance(state.get(wrap), dict):
            state = state[wrap]
    own = model.state_dict()
    state = {k: v for k, v in state.items() if k not in IGNORED_KEYS}
    problems = [f"missing {k}" for k in own if k not in state]
    problems += [f"unexpected {k}" for k in state if k not in own]
    problems += [f"{k}: shape {tuple(state[k].shape)}, the model's "
                 f"{tuple(v.shape)}" for k, v in own.items()
                 if k in state and state[k].shape != v.shape]
    _raise_if(problems, f"{path} as Depth Anything V2")
    return {k: state[k].to(v.dtype) for k, v in own.items()}
