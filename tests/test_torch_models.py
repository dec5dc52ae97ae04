"""The port's ViT and DepthPro (vsc_tpu_torch.models) against the JAX
modules, with the JAX parameters carried across by
vsc_tpu_torch.models.convert, in float32 on the CPU. The config keeps the
head dim at 64 so the JAX run really takes its qkv attention kernel
(interpret mode)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from vsc_tpu.models import DepthPro as JDepthPro
from vsc_tpu.models import DepthProConfig as JCfg
from vsc_tpu.models import ViT as JViT
from vsc_tpu.models import ViTConfig as JViTCfg
from vsc_tpu.models.convert import _flatten
from vsc_tpu_torch.models import DepthPro, DepthProConfig, ViT, ViTConfig
from vsc_tpu_torch.models.convert import ConversionError, state_dict_from_jax

ENC = dict(img_size=32, patch_size=4, embed_dim=128, depth=4, num_heads=2)
SMALL = dict(img_size=128, tile_size=32, hook_block_ids=(0, 2),
             decoder_features=16, dims_encoder=(16, 24, 32, 32))


def jax_small():
    return JCfg(encoder=JViTCfg(flash_attention=True, **ENC),
                use_fov_head=False, **SMALL)


def torch_small():
    return DepthProConfig(encoder=ViTConfig(**ENC), use_fov_head=False,
                          **SMALL)


@pytest.fixture(scope="module")
def carried():
    """JAX DepthPro params (non-trivial LayerScale) and the port model
    holding the same weights."""
    cfg = jax_small()
    model = JDepthPro(cfg)
    dummy = jnp.zeros((1, cfg.img_size, cfg.img_size, 3), jnp.float32)
    params = meta.unbox(model.init(jax.random.PRNGKey(0), dummy)["params"])
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    rng = np.random.default_rng(0)
    for k in flat:      # LayerScale 1e-5 would hide the attention path
        if k.endswith("/gamma"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    tmodel = DepthPro(torch_small()).eval()
    tmodel.load_state_dict(state_dict_from_jax(flat, tmodel), strict=True)
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [jnp.asarray(flat[k]) for k in _flatten(params)])
    return model, jparams, flat, tmodel


def test_vit_matches_jax():
    jcfg = JViTCfg(flash_attention=True, layerscale_init=0.7, **ENC)
    jvit = JViT(jcfg, hook_block_ids=(1,))
    x = np.random.default_rng(1).uniform(-1, 1, (3, 32, 32, 3)).astype(
        np.float32)
    params = meta.unbox(jvit.init(jax.random.PRNGKey(2),
                                  jnp.asarray(x))["params"])
    want, whooks = jvit.apply({"params": params}, jnp.asarray(x))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    tvit = ViT(ViTConfig(layerscale_init=0.7, **ENC), hook_block_ids=(1,))
    tvit.load_state_dict(state_dict_from_jax(flat, tvit), strict=True)
    with torch.no_grad():
        got, hooks = tvit(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hooks[1].numpy(), np.asarray(whooks[1]),
                               rtol=1e-4, atol=1e-4)


def test_vit_hook_batch_larger_than_rows_raises():
    vit = ViT(ViTConfig(**ENC), hook_block_ids=(0,))
    x = torch.zeros((2, 3, 32, 32))
    with torch.no_grad():
        _, hooks = vit(x, hook_batch=1)
        assert hooks[0].shape[0] == 1
        with pytest.raises(ValueError, match="hook_batch 3 exceeds"):
            vit(x, hook_batch=3)


def test_depthpro_matches_jax(carried):
    model, jparams, _, tmodel = carried
    x = np.random.default_rng(3).uniform(-1, 1, (2, 128, 128, 3)).astype(
        np.float32)
    want = np.asarray(model.apply({"params": jparams}, jnp.asarray(x))[
        "canonical_inverse_depth"])
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))["canonical_inverse_depth"].numpy()
    assert got.shape == want.shape == (2, 512, 512)
    assert np.std(want) > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_carrier_is_strict_both_ways(carried):
    _, _, flat, tmodel = carried
    missing = dict(flat)
    del missing["decoder/fusion_2/resnet1/conv1/kernel"]
    with pytest.raises(ConversionError, match="missing JAX leaf"):
        state_dict_from_jax(missing, tmodel)
    extra = dict(flat)
    extra["fov/head_out/kernel"] = np.zeros((1,), np.float32)
    with pytest.raises(ConversionError, match="unconsumed JAX leaf"):
        state_dict_from_jax(extra, tmodel)
    bad = dict(flat)
    bad["head_out/bias"] = np.zeros((2,), np.float32)
    with pytest.raises(ConversionError, match="shape mismatch"):
        state_dict_from_jax(bad, tmodel)


def test_seeded_init_is_deterministic():
    from vsc_tpu_torch.models import init_flax_like
    cfg = torch_small()
    a, b = DepthPro(cfg), DepthPro(cfg)
    init_flax_like(a, torch.Generator().manual_seed(7))
    init_flax_like(b, torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    sd = a.state_dict()
    assert torch.all(sd["encoder.patch_encoder.blocks.0.ls1.gamma"] == 1e-5)
    assert torch.all(sd["head.0.bias"] == 0)
    assert 0.01 < float(sd["encoder.image_encoder.pos_embed"].std()) < 0.03


@pytest.mark.parametrize("stub", ["luminance_depth", "gradient_depth"])
@pytest.mark.parametrize("h, w", [(1, 5), (37, 24), (108, 96)])
def test_stub_depth_equals_jax(stub, h, w):
    """The weight-free depth stubs (vsc_tpu/models/stub.py) on [-1, 1]
    images: the same nearness as JAX's, the ramp bit for bit."""
    import vsc_tpu.models.stub as jstub
    import vsc_tpu_torch.models.stub as tstub
    x = np.random.default_rng(h).uniform(-1, 1, (2, h, w, 3)).astype(
        np.float32)
    want = np.asarray(getattr(jstub, stub)(jnp.asarray(x)))
    got = getattr(tstub, stub)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, h, w)
    if stub == "gradient_depth":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
