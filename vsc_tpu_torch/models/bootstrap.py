"""
Depth weights: where they come from
===================================

The JAX package's order (``vsc_tpu/models/bootstrap.py``), and its files:

1. ``$VSC_TPU_DEPTH_CHECKPOINT``, an explicit local checkpoint, wins.
2. Else the converted cache ``$VSC_TPU_CACHE/depthpro_hf_v2.npz`` (default
   ``~/.cache/vsc_tpu``), the JAX parameter tree's flat npz layout, which
   both packages read and write: one cache file serves both.
3. Else ``apple/DepthPro-hf``'s ``model.safetensors`` through
   ``huggingface_hub.hf_hub_download`` (its own cache, proxies and tokens);
   once converted, ``maybe_cache_npz`` writes it to the cache of 2.
4. With no ``huggingface_hub`` or no way to the hub, the offline remedy is
   printed and ``resolve_checkpoint`` returns None: the caller runs the
   (labeled) luminance stub.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

__all__ = ["CHECKPOINT_ENV", "HF_REPO", "HF_FILE", "cache_dir",
           "npz_cache_path", "resolve_checkpoint", "maybe_cache_npz"]

CHECKPOINT_ENV = "VSC_TPU_DEPTH_CHECKPOINT"
HF_REPO = "apple/DepthPro-hf"
HF_FILE = "model.safetensors"


def cache_dir() -> Path:
    return Path(os.environ.get("VSC_TPU_CACHE",
                               "~/.cache/vsc_tpu")).expanduser()


def npz_cache_path() -> Path:
    # the JAX package's name: _v2 since its fused-qkv columns became
    # per-head interleaved
    return cache_dir() / "depthpro_hf_v2.npz"


def resolve_checkpoint(verbose: bool = True) -> str | None:
    """A loadable checkpoint path (npz, .pt or .safetensors) in the order
    above, or None after printing the offline remedy."""
    explicit = os.environ.get(CHECKPOINT_ENV)
    if explicit:
        return explicit
    cached = npz_cache_path()
    if cached.exists():
        if verbose:
            print(f"Using cached converted weights: {cached}")
        return str(cached)
    try:
        from huggingface_hub import hf_hub_download
        if verbose:
            print(f"Downloading depth model weights from {HF_REPO} "
                  "(first run only; cached by huggingface_hub)...")
        return hf_hub_download(repo_id=HF_REPO, filename=HF_FILE)
    except Exception as e:  # no package, no network, proxy failure, ...
        if verbose:
            print("\033[33m"
                  f"Could not download {HF_REPO}/{HF_FILE}: {e}\n"
                  "To use real depth weights offline, either:\n"
                  f"  * set {CHECKPOINT_ENV}=/path/to/depth_pro.pt "
                  "(Apple ml-depth-pro checkpoint), or\n"
                  f"  * set {CHECKPOINT_ENV}=/path/to/model.safetensors "
                  "(apple/DepthPro-hf), or\n"
                  f"  * place a converted cache at {cached}\n"
                  "\033[0m")
        return None


def maybe_cache_npz(source_path, model) -> None:
    """After converting a checkpoint that the hub download brought (a path
    in huggingface_hub's ``models--org--name`` layout; a user's own file is
    the user's to manage), write ``model``'s weights to the npz cache in the
    JAX package's layout, atomically. The cache holds the tree the JAX
    package's pipeline writes, the FOV head's leaves left out (both
    pipelines build DepthPro without it, and load the cache strictly). A
    failed write is reported, never fatal."""
    if os.sep + "models--" not in str(source_path):
        return
    from vsc_tpu_torch.models.convert import jax_flat_from_state_dict
    dest = npz_cache_path()
    # must end in .npz, or np.savez appends the extension itself
    tmp = dest.with_name(dest.stem + ".tmp.npz")
    try:
        dest.parent.mkdir(parents=True, exist_ok=True)
        flat = jax_flat_from_state_dict(model.state_dict(), model)
        np.savez_compressed(str(tmp), **{k: v for k, v in flat.items()
                                         if not k.startswith("fov/")})
        os.replace(tmp, dest)
        print(f"Converted weights cached: {dest}")
    except OSError as e:
        print(f"(could not write weight cache {dest}: {e})")
        tmp.unlink(missing_ok=True)
