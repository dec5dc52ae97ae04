"""The port's checkpoint loading (vsc_tpu_torch.models.convert and
.bootstrap) against transformers' DepthPro and the JAX package: a
DepthProForDepthEstimation at a tiny config with random weights, saved as
HF ``.pt`` and ``.safetensors`` and renamed into Apple's ``depth_pro.pt``
layout as tests/test_convert.py does, loads into the port's DepthPro,
which then reproduces the HF model's depth (the bounds of
tests/test_convert.py) and the JAX package's depth from the same file; the
weight cache the port writes is the JAX package's; the resolution order is
the JAX package's. No download: the hub is monkeypatched."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from test_convert import TINY, hf_state_to_apple, make_hf_model
from vsc_tpu.models import DepthPro as JDepthPro
from vsc_tpu.models import DepthProConfig as JCfg
from vsc_tpu.models.convert import convert_torch_checkpoint as jax_convert
from vsc_tpu.models.convert import load_params
from vsc_tpu.models.vit import interpolate_pos_embedding as jax_interp
from vsc_tpu_torch.models import DepthPro, DepthProConfig, ViTConfig
from vsc_tpu_torch.models import bootstrap
from vsc_tpu_torch.models.convert import (ConversionError,
                                          convert_torch_checkpoint,
                                          interpolate_pos_embedding,
                                          read_safetensors)
from vsc_tpu_torch.pipeline.depth_map_generator import build_depthpro

# tests/test_convert.py's TINY in the port's config (no FOV head)
PORT_TINY = DepthProConfig(
    img_size=TINY.img_size, tile_size=TINY.tile_size,
    encoder=ViTConfig(img_size=TINY.encoder.img_size,
                      patch_size=TINY.encoder.patch_size,
                      embed_dim=TINY.encoder.embed_dim,
                      depth=TINY.encoder.depth,
                      num_heads=TINY.encoder.num_heads,
                      layerscale_init=TINY.encoder.layerscale_init),
    hook_block_ids=TINY.hook_block_ids,
    decoder_features=TINY.decoder_features,
    dims_encoder=TINY.dims_encoder, use_fov_head=False)
JAX_TINY_NO_FOV = JCfg(img_size=TINY.img_size, tile_size=TINY.tile_size,
                       encoder=TINY.encoder,
                       hook_block_ids=TINY.hook_block_ids,
                       decoder_features=TINY.decoder_features,
                       dims_encoder=TINY.dims_encoder, use_fov_head=False)
# tests/test_convert.py:164, for the port against the HF model and against
# the JAX package's model: three float32 CPU implementations whose
# convolutions round differently (port vs JAX here: max 5.9e-4 on outputs
# up to ~600)
BOUND = dict(atol=5e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The HF model's input and depth, and its weights as HF .pt, HF
    .safetensors and Apple .pt files."""
    from safetensors.torch import save_file
    hf = make_hf_model()
    x = np.random.default_rng(0).uniform(
        -1.0, 1.0, (1, TINY.img_size, TINY.img_size, 3)).astype(np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(x).permute(0, 3, 1, 2)).predicted_depth
    d = tmp_path_factory.mktemp("ckpt")
    state = {k: v.detach().clone().contiguous()
             for k, v in hf.state_dict().items()}
    paths = {"hf_pt": d / "hf_depth_pro.pt", "hf_st": d / "model.safetensors",
             "apple_pt": d / "depth_pro.pt"}
    torch.save(state, paths["hf_pt"])
    save_file(state, str(paths["hf_st"]))
    torch.save(hf_state_to_apple(state, TINY), paths["apple_pt"])
    return x, want.numpy(), paths


def port_depth(state_dict, x):
    model = DepthPro(PORT_TINY).eval()
    model.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        return model(torch.from_numpy(x))["canonical_inverse_depth"].numpy()


def jax_depth(params, x):
    out = JDepthPro(JAX_TINY_NO_FOV).apply({"params": params},
                                           jnp.asarray(x))
    return np.asarray(out["canonical_inverse_depth"])


@pytest.mark.parametrize("which", ["hf_pt", "hf_st", "apple_pt"])
def test_checkpoint_depth_matches_hf_and_jax(files, which):
    x, want, paths = files
    model = DepthPro(PORT_TINY)
    got = port_depth(convert_torch_checkpoint(paths[which], model), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **BOUND)
    params = jax_convert(paths[which], JDepthPro(JAX_TINY_NO_FOV),
                         verbose=False)
    np.testing.assert_allclose(got, jax_depth(params, x), **BOUND)


@pytest.mark.parametrize("change", ["missing", "unused", "shape"])
def test_conversion_is_strict(files, change):
    _, _, paths = files
    state = torch.load(paths["apple_pt"], weights_only=True)
    if change == "missing":
        del state["decoder.fusions.2.resnet1.1.weight"]
    elif change == "unused":
        state["decoder.fusions.2.extra.weight"] = torch.zeros(3)
    else:
        state["head.0.bias"] = torch.zeros(7)
    with pytest.raises(ConversionError, match={
            "missing": "missing checkpoint tensor",
            "unused": "unused checkpoint tensor",
            "shape": "shape mismatch"}[change]):
        from vsc_tpu_torch.models.convert import convert_state_dict
        convert_state_dict(state, DepthPro(PORT_TINY))


def test_hf_checkpoint_missing_a_projection_raises(files, tmp_path):
    _, _, paths = files
    state = torch.load(paths["hf_pt"], weights_only=True)
    del state["depth_pro.encoder.patch_encoder.model.encoder.layer.1."
              "attention.attention.key.weight"]
    torch.save(state, tmp_path / "partial.pt")
    with pytest.raises(ConversionError, match="query, key, value"):
        convert_torch_checkpoint(tmp_path / "partial.pt",
                                 DepthPro(PORT_TINY))


def test_safetensors_reader_is_bit_exact(files, tmp_path):
    from safetensors.torch import load_file, save_file
    _, _, paths = files
    want = load_file(str(paths["hf_st"]))
    got = read_safetensors(paths["hf_st"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    # the half types and an empty tensor, bit for bit
    g = torch.Generator().manual_seed(1)
    mixed = {"bf16": torch.randn((3, 5), generator=g).to(torch.bfloat16),
             "f16": torch.randn((4,), generator=g).half(),
             "empty": torch.zeros((0, 2)), "i64": torch.arange(6)}
    save_file(mixed, str(tmp_path / "mixed.safetensors"))
    got = read_safetensors(tmp_path / "mixed.safetensors")
    for k, v in mixed.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert torch.equal(got[k].view(torch.uint8) if v.numel() else got[k],
                           v.view(torch.uint8) if v.numel() else v)


@pytest.mark.parametrize("src,dst", [(4, 6), (6, 4), (24, 32)])
def test_pos_embed_resize_matches_jax(src, dst):
    pos = np.random.default_rng(src).normal(
        size=(1, 1 + src * src, 8)).astype(np.float32)
    got = interpolate_pos_embedding(pos, src, dst)
    want = np.asarray(jax_interp(jnp.asarray(pos), src, dst))
    assert got.shape == (1, 1 + dst * dst, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.fixture()
def no_hub(tmp_path, monkeypatch):
    """An empty cache under tmp_path, no env checkpoint, and a hub that
    must not be reached unless a test says so."""
    monkeypatch.setenv("VSC_TPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.delenv(bootstrap.CHECKPOINT_ENV, raising=False)

    def boom(**kw):
        raise AssertionError("unexpected download attempt")
    monkeypatch.setattr("huggingface_hub.hf_hub_download", boom)
    return tmp_path


def test_resolve_checkpoint_env_wins(no_hub, monkeypatch):
    bootstrap.npz_cache_path().parent.mkdir(parents=True)
    bootstrap.npz_cache_path().touch()
    monkeypatch.setenv(bootstrap.CHECKPOINT_ENV, "/some/depth_pro.pt")
    assert bootstrap.resolve_checkpoint(verbose=False) == "/some/depth_pro.pt"


def test_resolve_checkpoint_cache_before_hub(no_hub):
    cached = bootstrap.npz_cache_path()
    assert cached == no_hub / "cache" / "depthpro_hf_v2.npz"
    cached.parent.mkdir(parents=True)
    cached.touch()
    assert bootstrap.resolve_checkpoint(verbose=False) == str(cached)


def test_resolve_checkpoint_hub_last(no_hub, monkeypatch):
    calls = []

    def fake(**kw):
        calls.append(kw)
        return "/hub/models--apple--DepthPro-hf/snapshots/x/model.safetensors"
    monkeypatch.setattr("huggingface_hub.hf_hub_download", fake)
    got = bootstrap.resolve_checkpoint(verbose=False)
    assert got.endswith("model.safetensors")
    assert calls == [{"repo_id": "apple/DepthPro-hf",
                      "filename": "model.safetensors"}]


def test_resolve_checkpoint_offline_is_none(no_hub, monkeypatch, capsys):
    def offline(**kw):
        raise OSError("no network")
    monkeypatch.setattr("huggingface_hub.hf_hub_download", offline)
    assert bootstrap.resolve_checkpoint() is None
    assert bootstrap.CHECKPOINT_ENV in capsys.readouterr().out


def test_cache_npz_is_the_jax_layout(files, no_hub):
    """A hub download converted by build_depthpro leaves the npz cache,
    which loads into the JAX package's model (load_params) as JAX's own
    conversion of the same file, and back into the port (load_jax_npz)."""
    import shutil
    x, _, paths = files
    hub = no_hub / "hub" / "models--apple--DepthPro-hf" / "snapshots" / "x"
    hub.mkdir(parents=True)
    shutil.copy(paths["hf_st"], hub / "model.safetensors")
    model = build_depthpro(PORT_TINY.img_size, "cpu", cfg=PORT_TINY,
                           checkpoint=str(hub / "model.safetensors"))
    cache = bootstrap.npz_cache_path()
    assert cache.exists()
    jmodel = JDepthPro(JAX_TINY_NO_FOV)
    like = meta.unbox(jmodel.init(jax.random.PRNGKey(0), jnp.zeros(
        (1, TINY.img_size, TINY.img_size, 3)))["params"])
    from_cache = load_params(cache, like)
    ref = jax_convert(paths["hf_st"], jmodel, verbose=False)
    for a, b in zip(jax.tree_util.tree_leaves(from_cache),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(jax_depth(from_cache, x),
                                  jax_depth(ref, x))
    again = build_depthpro(PORT_TINY.img_size, "cpu", cfg=PORT_TINY,
                           checkpoint=str(cache))
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


def test_user_checkpoint_is_not_cached(files, no_hub):
    _, _, paths = files
    build_depthpro(PORT_TINY.img_size, "cpu", cfg=PORT_TINY,
                   checkpoint=str(paths["apple_pt"]))
    assert not bootstrap.npz_cache_path().exists()
