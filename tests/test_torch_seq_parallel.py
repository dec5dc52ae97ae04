"""The port's tensor- and sequence-parallel ViT (vsc_tpu_torch/models/vit.py
over vsc_tpu_torch/parallel/{sharding,collectives}.py) against the JAX
package's sharded ViT and DepthPro on its 8 virtual CPU devices
(tests/conftest.py), the port on ``make_mesh(..., devices=[cpu] * 8)``.
Weights cross over through models/convert (JAX -> port, or port -> JAX)
and then the port's ``shard_params``; inputs come from numpy with a seed.
Float32 throughout; the tolerances are the JAX tests' own
(tests/test_seq_parallel.py: atol 2e-5) and, for DepthPro,
tests/test_torch_models.py's (rtol = atol = 1e-4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta
from jax.sharding import NamedSharding, PartitionSpec as P

from vsc_tpu.models import ViT as JViT
from vsc_tpu.models import ViTConfig as JViTCfg
from vsc_tpu.models.convert import _flatten
from vsc_tpu.parallel.mesh import make_mesh as jax_mesh
from vsc_tpu.parallel.sharding import param_shardings as jax_shardings
from vsc_tpu_torch.models import ViT, ViTConfig
from vsc_tpu_torch.models.convert import state_dict_from_jax
from vsc_tpu_torch.ops.attention_cuda import qkv_attention_plain
from vsc_tpu_torch.parallel import collectives
from vsc_tpu_torch.parallel.auto import gather, shard_batch
from vsc_tpu_torch.parallel.mesh import make_mesh
from vsc_tpu_torch.parallel.sharding import (param_shardings, shard_params,
                                             shard_tensor)

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _jax_sharded(model, boxed, x, mesh_shape):
    """``model`` applied under a JAX (data, model) mesh with its parameters
    placed by vsc_tpu.parallel.sharding and the batch over "data"."""
    mesh = jax_mesh(*mesh_shape)
    params = jax.device_put(meta.unbox(boxed), jax_shardings(boxed, mesh))
    xs = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P("data", None, None, None)))
    with jax.set_mesh(mesh):
        out = jax.jit(lambda p, im: model.apply({"params": p}, im))(
            params, xs)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_sharded(model, x, mesh_shape, fn):
    """``fn(replica, nchw shard)`` over each data row of a CPU mesh, joined
    in shard order."""
    mesh = make_mesh(*mesh_shape, devices=CPU8)
    replicas = shard_params(model, mesh)
    batch = shard_batch(x, "cpu", mesh)
    with torch.no_grad():
        parts = [fn(r, p.permute(0, 3, 1, 2)) for r, p in
                 zip(replicas, batch.parts)]
    return torch.cat(parts).numpy()


def _carried_vit(jcfg, tcfg, x):
    jvit = JViT(jcfg)
    boxed = jvit.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    flat = {k: np.asarray(v) for k, v in _flatten(meta.unbox(boxed)).items()}
    tvit = ViT(tcfg).eval()
    tvit.load_state_dict(state_dict_from_jax(flat, tvit), strict=True)
    return jvit, boxed, tvit


def test_tp_vit_matches_jax():
    """tests/test_seq_parallel.py:46's config: embed 256, 4 heads (head dim
    64, the JAX run on its Pallas qkv kernel shard_mapped over "model"),
    mesh (4, 2): each port rank runs 2 heads."""
    kw = dict(img_size=24, patch_size=3, embed_dim=256, depth=2,
              num_heads=4)
    x = _images(0, (4, 24, 24, 3))
    jvit, boxed, tvit = _carried_vit(JViTCfg(**kw, flash_attention=True),
                                     ViTConfig(**kw), x)
    want = _jax_sharded(jvit, boxed, x, (4, 2))[0]
    got = _port_sharded(tvit, x, (4, 2), lambda m, im: m(im)[0])
    assert got.shape == want.shape == (4, 65, 256)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_seq_parallel_vit_matches_jax():
    """tests/test_seq_parallel.py:14's config: embed 32, 2 heads, 65
    tokens, so the token axis does not divide the model axis of 2 (the
    port pads the last chunk; the attention never sees the pad)."""
    kw = dict(img_size=24, patch_size=3, embed_dim=32, depth=2, num_heads=2)
    x = _images(1, (4, 24, 24, 3))
    jvit, boxed, tvit = _carried_vit(JViTCfg(**kw, seq_shard=True),
                                     ViTConfig(**kw, seq_shard=True), x)
    want = _jax_sharded(jvit, boxed, x, (4, 2))[0]
    got = _port_sharded(tvit, x, (4, 2), lambda m, im: m(im)[0])
    assert got.shape == want.shape == (4, 65, 32)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("seq_shard", [False, True], ids=["tp", "tp+sp"])
@pytest.mark.parametrize("mp", [2, 4])
def test_sharded_vit_hooks_equal_unsharded(seq_shard, mp):
    """The port against itself, the attention path made visible
    (LayerScale 0.7): tokens and hooked blocks of the sharded forward
    equal the unsharded one within float32 summation order."""
    from vsc_tpu_torch.models import init_flax_like
    cfg = ViTConfig(img_size=24, patch_size=3, embed_dim=64, depth=3,
                    num_heads=4, layerscale_init=0.7, seq_shard=seq_shard)
    vit = ViT(cfg, hook_block_ids=(0, 2)).eval()
    init_flax_like(vit, torch.Generator().manual_seed(2))
    x = torch.from_numpy(_images(2, (2, 3, 24, 24)))
    with torch.no_grad():
        want, whooks = vit(x, hook_batch=1)
        rep = shard_params(vit, make_mesh(1, mp, devices=CPU8))[0]
        got, hooks = rep(x, hook_batch=1)
    assert rep is not vit and vit.blocks[0].ranks is None
    assert [len(b.ranks) for b in rep.blocks] == [mp] * 3
    assert rep.blocks[0].attn is None and vit.blocks[0].attn is not None
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    assert sorted(hooks) == [0, 2] and hooks[0].shape == (1, 65, 64)
    for i in (0, 2):
        torch.testing.assert_close(hooks[i], whooks[i], atol=2e-5, rtol=0)


def test_tp_sp_depthpro_matches_jax():
    """The dry run's small DepthPro (vsc_tpu_torch/parallel/dryrun.py,
    __graft_entry__.dryrun_multichip): tensor- and sequence-parallel ViT
    encoders on a (4, 2) mesh, both packages on the same weights (the
    port's seeded init, LayerScale drawn in [0.5, 1.5] so the attention
    shows, written into the JAX tree), rtol = atol = 1e-4."""
    from vsc_tpu.models import DepthPro as JDepthPro
    from vsc_tpu.models import DepthProConfig as JCfg
    from vsc_tpu_torch.models import DepthPro, init_flax_like
    from vsc_tpu_torch.models.convert import jax_flat_from_state_dict
    from vsc_tpu_torch.parallel.dryrun import small_config
    cfg = small_config()
    assert cfg.encoder.seq_shard
    tmodel = DepthPro(cfg).eval()
    init_flax_like(tmodel, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in tmodel.named_parameters():
            if name.endswith("gamma"):
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)
    flat = jax_flat_from_state_dict(tmodel.state_dict(), tmodel)
    e = cfg.encoder
    jmodel = JDepthPro(JCfg(
        img_size=cfg.img_size, tile_size=cfg.tile_size,
        encoder=JViTCfg(img_size=e.img_size, patch_size=e.patch_size,
                        embed_dim=e.embed_dim, depth=e.depth,
                        num_heads=e.num_heads, seq_shard=True),
        hook_block_ids=cfg.hook_block_ids,
        decoder_features=cfg.decoder_features,
        dims_encoder=cfg.dims_encoder, use_fov_head=False))
    x = _images(3, (4, cfg.img_size, cfg.img_size, 3))
    boxed = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                           jnp.asarray(x[:1]))["params"]
    leaves = [jnp.asarray(flat[k]) for k in _flatten(meta.unbox(boxed))]
    params = jax.tree_util.tree_unflatten(     # still boxed: the rules
        jax.tree_util.tree_structure(boxed), leaves)
    want = _jax_sharded(jmodel, params, x, (4, 2))["canonical_inverse_depth"]
    got = _port_sharded(tmodel, x, (4, 2), lambda m, im: m(
        im.permute(0, 2, 3, 1))["canonical_inverse_depth"])
    assert got.shape == want.shape == (4, 512, 512)
    assert np.std(want) > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_qkv_shard_holds_whole_heads(mp):
    """A rank's share of the fused [q | k | v] projection is heads
    [r H/mp, (r+1) H/mp) of each of q, k and v; the attention on it equals
    those heads of the unsharded attention bit for bit."""
    H, Dh, D, T = 8, 16, 128, 33
    lin = torch.nn.Linear(D, 3 * D)
    torch.nn.init.normal_(lin.weight, generator=torch.Generator().manual_seed(4))
    mesh = make_mesh(1, mp, devices=CPU8)
    specs = param_shardings(torch.nn.ModuleDict({"attn": torch.nn.ModuleDict(
        {"qkv": lin})}), mesh)
    x = torch.from_numpy(_images(4, (2, T, D)))
    with torch.no_grad():
        full = qkv_attention_plain(lin(x), H, 0.25)
        w = lin.weight.view(3, H, Dh, D)
        b = lin.bias.view(3, H, Dh)
        for r in range(mp):
            heads = slice(r * H // mp, (r + 1) * H // mp)
            ws = shard_tensor("attn.qkv.weight", lin.weight,
                              specs["attn.qkv.weight"], r)
            bs = shard_tensor("attn.qkv.bias", lin.bias,
                              specs["attn.qkv.bias"], r)
            assert torch.equal(ws, w[:, heads].reshape(-1, D))
            assert torch.equal(bs, b[:, heads].reshape(-1))
            local = torch.nn.functional.linear(x, ws, bs)
            got = qkv_attention_plain(local, H // mp, 0.25)
            want = full.view(2, T, H, Dh)[:, :, heads].reshape(2, T, -1)
            assert torch.equal(got, want)


def test_param_shardings_follow_the_logical_rules():
    from vsc_tpu_torch.parallel.sharding import LOGICAL_RULES
    from vsc_tpu.parallel.sharding import LOGICAL_RULES as JAX_RULES
    assert LOGICAL_RULES == JAX_RULES
    vit = ViT(ViTConfig(img_size=24, patch_size=3, embed_dim=32, depth=1,
                        num_heads=2))
    specs = {k: v.spec for k, v in param_shardings(
        vit, make_mesh(4, 2, devices=CPU8)).items()}
    assert specs["blocks.0.attn.qkv.weight"] == ("model", None)
    assert specs["blocks.0.attn.qkv.bias"] == ("model",)
    assert specs["blocks.0.attn.proj.weight"] == (None, "model")
    assert specs["blocks.0.mlp.fc1.weight"] == ("model", None)
    assert specs["blocks.0.mlp.fc2.weight"] == (None, "model")
    for k in ("blocks.0.attn.proj.bias", "blocks.0.mlp.fc2.bias",
              "blocks.0.norm1.weight", "blocks.0.ls1.gamma", "pos_embed",
              "patch_embed.proj.weight"):
        assert specs[k] == (), k


@pytest.mark.parametrize("T, ranks", [(65, 2), (8, 4), (5, 8)])
def test_token_collectives_round_trip(T, ranks):
    """split_tokens / gather_tokens / all_gather invert each other (the
    pad dropped); reduce_scatter is split_tokens of the float32 sum."""
    x = torch.from_numpy(_images(5, (2, T, 3)))
    devs = CPU8[:ranks]
    parts = collectives.split_tokens(x, devs)
    assert len({p.shape[1] for p in parts}) == 1
    assert torch.equal(collectives.gather_tokens(parts, devs[0], T), x)
    for full in collectives.all_gather(parts, devs, T):
        assert torch.equal(full, x)
    ys = [x * (r + 1) for r in range(ranks)]
    total = collectives.psum(ys, devs[0])
    for got, want in zip(collectives.reduce_scatter(ys, devs),
                         collectives.split_tokens(total, devs)):
        assert torch.equal(got, want)


def test_sharded_batch_gathers_in_shard_order():
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    batch = shard_batch(x, "cpu", make_mesh(4, 2, devices=CPU8))
    assert [p.shape for p in batch.parts] == [(2, 3)] * 4
    assert batch.shape == (8, 3)
    np.testing.assert_array_equal(gather(batch).numpy(), x)
