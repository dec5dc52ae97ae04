"""DepthPro's FOV head in the port (vsc_tpu_torch/models/depthpro.py's
FOVNetwork and the FOV tables of vsc_tpu_torch/models/convert.py) against
the JAX package and transformers' DepthPro, in float32 on the CPU:

- the port on JAX's ``DepthPro(DepthProConfig.tiny())`` with its ``init``
  weights carried across, with and without the FOV encoder, batch 3:
  ``fov_deg`` within atol 1e-3 (tests/test_convert.py:163's bound against
  HF), ``canonical_inverse_depth`` and ``inverse_depth`` within
  test_torch_checkpoints.BOUND; the same weights through an Apple-layout
  file; each row of a batch equal to its frame alone; the ``fov/...`` npz
  names both ways; the tensor- and sequence-parallel port on a CPU mesh;
- the port's ``fov_deg`` against transformers' ``field_of_view`` from HF
  ``.pt``, ``.safetensors`` and Apple ``.pt`` files, and the strictness of
  the conversion with and without the head;
- the pipeline's DepthPro keeps the head off, as the JAX pipeline's does.

The JAX model is built and run once per module fixture (jitted: the
un-jitted init alone takes most of a minute here)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from test_convert import TINY, hf_state_to_apple, make_hf_model
from test_torch_checkpoints import BOUND
from vsc_tpu.models import DepthPro as JDepthPro
from vsc_tpu.models import DepthProConfig as JCfg
from vsc_tpu.models.convert import _apple_mapping, _flatten, _hf_mapping
from vsc_tpu_torch.models import DepthPro, DepthProConfig, ViTConfig
from vsc_tpu_torch.models import bootstrap
from vsc_tpu_torch.models.convert import (ConversionError, _depthpro_table,
                                          _hf_names, convert_state_dict,
                                          convert_torch_checkpoint,
                                          interpolate_pos_embedding,
                                          jax_flat_from_state_dict,
                                          load_jax_npz, state_dict_from_jax)

FOV_ATOL = 1e-3     # tests/test_convert.py:163, JAX against HF
CPU8 = [torch.device("cpu")] * 8


def port_cfg(jcfg, **kw):
    """The port's DepthProConfig of a JAX one (``kw`` overrides fields of
    the ViT config, e.g. seq_shard)."""
    e = jcfg.encoder
    return DepthProConfig(
        img_size=jcfg.img_size, tile_size=jcfg.tile_size,
        encoder=ViTConfig(img_size=e.img_size, patch_size=e.patch_size,
                          embed_dim=e.embed_dim, depth=e.depth,
                          num_heads=e.num_heads, mlp_ratio=e.mlp_ratio,
                          layerscale_init=e.layerscale_init, **kw),
        hook_block_ids=jcfg.hook_block_ids,
        decoder_features=jcfg.decoder_features,
        dims_encoder=jcfg.dims_encoder, use_fov_head=jcfg.use_fov_head,
        use_fov_encoder=jcfg.use_fov_encoder)


def port_model(cfg, state):
    model = DepthPro(cfg).eval()
    model.load_state_dict(state, strict=True)
    return model


def run(model, x):
    with torch.no_grad():
        return {k: v.numpy() for k, v in model(torch.from_numpy(x)).items()}


@pytest.fixture(scope="module", params=[True, False],
                ids=["fov_encoder", "no_fov_encoder"])
def carried(request):
    """JAX's tiny() DepthPro (FOV encoder on or off) on its init weights,
    LayerScale drawn in [0.5, 1.5] so the attention shows and the FOV
    output scaled by 50 around 50 degrees so its spread over the frames is
    tens of degrees; its outputs on a batch of 3, and the flat weights."""
    jcfg = dataclasses.replace(JCfg.tiny(), use_fov_encoder=request.param)
    jmodel = JDepthPro(jcfg)
    S = jcfg.img_size
    params = meta.unbox(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))["params"])
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    rng = np.random.default_rng(0)
    for k in flat:
        if k.endswith("/gamma"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    flat["fov/head_out/kernel"] = flat["fov/head_out/kernel"] * 50.0
    flat["fov/head_out/bias"] = flat["fov/head_out/bias"] + 50.0
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [jnp.asarray(flat[k]) for k in _flatten(params)])
    x = np.random.default_rng(3).uniform(-1, 1, (3, S, S, 3)).astype(
        np.float32)
    out = jax.jit(jmodel.apply)({"params": jparams}, jnp.asarray(x))
    want = {k: np.asarray(v) for k, v in out.items()}
    return jcfg, flat, x, want


def check_against_jax(got, want, fov_atol=FOV_ATOL):
    assert sorted(got) == sorted(want) == ["canonical_inverse_depth",
                                           "fov_deg", "inverse_depth"]
    assert got["fov_deg"].shape == (3,) and got["fov_deg"].dtype == np.float32
    assert np.ptp(want["fov_deg"]) > 1.0       # the head's output shows
    np.testing.assert_allclose(got["fov_deg"], want["fov_deg"],
                               atol=fov_atol, rtol=0)
    for k in ("canonical_inverse_depth", "inverse_depth"):
        assert got[k].shape == want[k].shape == (3, 512, 512)
        assert np.std(want[k]) > 0
        np.testing.assert_allclose(got[k], want[k], **BOUND)


@pytest.mark.parametrize("source", ["jax_tree", "apple_pt"])
def test_fov_matches_jax(carried, source, tmp_path):
    """The JAX weights through state_dict_from_jax, or the port's state
    dict written as an Apple ``depth_pro.pt`` (the port's keys are Apple's:
    ``fov.head.{0,2,4,6}`` without the FOV encoder) and read back by
    convert_torch_checkpoint."""
    jcfg, flat, x, want = carried
    cfg = port_cfg(jcfg)
    state = state_dict_from_jax(flat, DepthPro(cfg))
    if source == "apple_pt":
        heads = sorted(k for k in state if k.startswith("fov.head."))
        assert heads[-1].startswith("fov.head.4." if jcfg.use_fov_encoder
                                    else "fov.head.6.")
        torch.save(state, tmp_path / "depth_pro.pt")
        state = convert_torch_checkpoint(tmp_path / "depth_pro.pt",
                                         DepthPro(cfg))
    check_against_jax(run(port_model(cfg, state), x), want)


def test_fov_batch_rows_are_independent(carried):
    jcfg, flat, x, _ = carried
    cfg = port_cfg(jcfg)
    model = port_model(cfg, state_dict_from_jax(flat, DepthPro(cfg)))
    batch = run(model, x)
    for i in range(len(x)):
        alone = run(model, x[i:i + 1])
        for k, v in alone.items():
            np.testing.assert_allclose(v[0], batch[k][i], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_fov_npz_names_round_trip(carried):
    """The JAX tree's ``fov/...`` names, all of them, to the port and back,
    bit for bit; the port's tables name the Apple and HF keys that
    vsc_tpu/models/convert.py's tables name."""
    jcfg, flat, _, _ = carried
    model = DepthPro(port_cfg(jcfg))
    state = state_dict_from_jax(flat, model)
    back = jax_flat_from_state_dict(state, model)
    assert sorted(back) == sorted(flat)
    assert any(k.startswith("fov/encoder_vit/") for k in flat) \
        == jcfg.use_fov_encoder
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    apple = {tk: fk for tk, (fk, _) in _apple_mapping(jcfg).items()
             if tk.startswith("fov.")}
    table = {tk: jk for tk, (jk, _) in _depthpro_table(port_cfg(jcfg)).items()
             if tk.startswith("fov.") and not tk.startswith("fov.encoder.0.")}
    assert table == apple
    hf = {tk: fk for tk, (fk, _) in _hf_mapping(jcfg).items()
          if tk.startswith("fov_model.")}
    assert hf.items() <= _hf_names().items()


def test_tp_sp_fov_matches_jax(carried):
    """Tensor parallel 2 + seq_shard with the head on, on a (3 data x 2
    model) mesh of the CPU (tests/test_torch_seq_parallel.py's mesh
    devices), against JAX's unsharded run: the FOV encoder's blocks get
    their model-axis ranks, its neck and the FOV convolutions stay
    whole."""
    from vsc_tpu_torch.models.vit import Block
    from vsc_tpu_torch.parallel.auto import shard_batch
    from vsc_tpu_torch.parallel.mesh import make_mesh
    from vsc_tpu_torch.parallel.sharding import shard_params
    jcfg, flat, x, want = carried
    cfg = port_cfg(jcfg, seq_shard=True)
    model = port_model(cfg, state_dict_from_jax(flat, DepthPro(cfg)))
    mesh = make_mesh(3, 2, devices=CPU8)
    replicas = shard_params(model, mesh)
    rep = replicas[0]
    blocks = {n for n, m in rep.named_modules()
              if isinstance(m, Block) and m.ranks is not None}
    fov_blocks = {n for n in blocks if n.startswith("fov.")}
    assert len(fov_blocks) == (cfg.encoder.depth if cfg.use_fov_encoder
                               else 0)
    assert len(blocks) == (3 if cfg.use_fov_encoder else 2) * cfg.encoder.depth
    if cfg.use_fov_encoder:
        assert rep.fov.encoder[1].weight.shape == model.fov.encoder[1].weight.shape
    assert rep.fov.head[0].weight.shape == model.fov.head[0].weight.shape
    batch = shard_batch(x, "cpu", mesh)
    with torch.no_grad():
        parts = [r(p) for r, p in zip(replicas, batch.parts)]
    got = {k: torch.cat([p[k] for p in parts]).numpy() for k in parts[0]}
    check_against_jax(got, want)


# --------------------------------------------------------------------------
# transformers' DepthPro and its files

PORT_TINY = port_cfg(TINY)          # tests/test_convert.py's TINY, head on


@pytest.fixture(scope="module")
def hf_files(tmp_path_factory):
    """transformers' tiny DepthPro: its input, depth and field of view on a
    batch of 2, and its weights as HF .pt, HF .safetensors and Apple .pt."""
    from safetensors.torch import save_file
    hf = make_hf_model()
    x = np.random.default_rng(0).uniform(
        -1.0, 1.0, (2, TINY.img_size, TINY.img_size, 3)).astype(np.float32)
    with torch.no_grad():
        out = hf(torch.from_numpy(x).permute(0, 3, 1, 2))
    d = tmp_path_factory.mktemp("fov_ckpt")
    state = {k: v.detach().clone().contiguous()
             for k, v in hf.state_dict().items()}
    paths = {"hf_pt": d / "hf_depth_pro.pt", "hf_st": d / "model.safetensors",
             "apple_pt": d / "depth_pro.pt"}
    torch.save(state, paths["hf_pt"])
    save_file(state, str(paths["hf_st"]))
    torch.save(hf_state_to_apple(state, TINY), paths["apple_pt"])
    return x, out.predicted_depth.numpy(), out.field_of_view.numpy(), paths


@pytest.mark.parametrize("which", ["hf_pt", "hf_st", "apple_pt"])
def test_fov_matches_hf(hf_files, which):
    x, depth, fov, paths = hf_files
    model = port_model(PORT_TINY, convert_torch_checkpoint(
        paths[which], DepthPro(PORT_TINY)))
    got = run(model, x)
    assert np.ptp(fov) > 1.0
    np.testing.assert_allclose(got["fov_deg"], fov, atol=FOV_ATOL, rtol=0)
    np.testing.assert_allclose(got["canonical_inverse_depth"], depth,
                               **BOUND)
    tan_half = np.tan(np.deg2rad(got["fov_deg"]) / 2.0)
    np.testing.assert_allclose(
        got["inverse_depth"],
        got["canonical_inverse_depth"] * (2.0 * tan_half)[:, None, None],
        rtol=1e-6)


@pytest.mark.parametrize("which", ["hf_pt", "apple_pt"])
def test_fov_conversion_is_strict(hf_files, which):
    """A model with the head refuses a file without the FOV tensors and
    names them; a model without the head loads the full file; a model with
    the head and no FOV encoder reads an HF file's head and leaves its FOV
    encoder unread, as the JAX package's conversion does."""
    _, _, _, paths = hf_files
    state = torch.load(paths[which], weights_only=True)
    prefix = "fov_model." if which == "hf_pt" else "fov."
    no_fov = {k: v for k, v in state.items() if not k.startswith(prefix)}
    with pytest.raises(ConversionError,
                       match=r"missing checkpoint tensor: fov\.encoder\.0\."):
        convert_state_dict(no_fov, DepthPro(PORT_TINY))
    no_enc = DepthPro(dataclasses.replace(PORT_TINY, use_fov_encoder=False))
    with pytest.raises(ConversionError, match=r"8 problems(.|\n)*"
                       r"missing checkpoint tensor: fov\.head\.6\.bias"):
        convert_state_dict(no_fov, no_enc)
    off = DepthPro(dataclasses.replace(PORT_TINY, use_fov_head=False))
    assert not any(k.startswith("fov.") for k in
                   convert_state_dict(state, off))
    if which == "hf_pt":
        got = convert_state_dict(state, no_enc)
        assert sorted(k for k in got if k.startswith("fov.")) == sorted(
            k for k in no_enc.state_dict() if k.startswith("fov."))
    else:       # Apple's full layout is not the no-encoder layout
        with pytest.raises(ConversionError, match="fov.head.6"):
            convert_state_dict(state, no_enc)


def test_fov_pos_embed_is_resized(hf_files):
    """A file trained at a 24-token grid into a model at 32 (input 256;
    production: 1536 -> 2048): the FOV encoder's position table is resized
    as the other two are. The FOV head's last conv spans grid / 4 tokens,
    so its kernel does not carry to another grid: as in the JAX package,
    that one shape mismatch is refused, and a file with a kernel of the
    model's grid loads."""
    _, _, _, paths = hf_files
    enc = dataclasses.replace(PORT_TINY.encoder, img_size=64)
    cfg = dataclasses.replace(PORT_TINY, img_size=256, tile_size=64,
                              encoder=enc)
    src = torch.load(paths["apple_pt"], weights_only=True)
    with pytest.raises(ConversionError, match=r"\(1 problems\):\n  shape "
                       r"mismatch fov\.head\.4\.weight: checkpoint "
                       r"\(1, 2, 6, 6\) vs port \(1, 2, 8, 8\)"):
        convert_state_dict(src, DepthPro(cfg))
    src["fov.head.4.weight"] = torch.zeros((1, 2, 8, 8))
    got = convert_state_dict(src, DepthPro(cfg))
    for vit in ("encoder.patch_encoder", "encoder.image_encoder",
                "fov.encoder.0"):
        key = f"{vit}.pos_embed"
        assert tuple(got[key].shape) == (1, 1 + 32 * 32, enc.embed_dim)
        np.testing.assert_array_equal(
            got[key].numpy(),
            interpolate_pos_embedding(src[key].numpy(), 24, 32))


def test_weight_cache_stays_head_off(hf_files, tmp_path, monkeypatch):
    """A hub file converted into a model with the head leaves the cache
    the JAX pipeline writes (no ``fov/`` leaves: its model has no head),
    which the head-off pipeline model loads strictly."""
    import shutil
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depthpro
    _, _, _, paths = hf_files
    monkeypatch.setenv("VSC_TPU_CACHE", str(tmp_path / "cache"))
    hub = tmp_path / "hub" / "models--apple--DepthPro-hf" / "snapshots" / "x"
    hub.mkdir(parents=True)
    shutil.copy(paths["hf_st"], hub / "model.safetensors")
    on = build_depthpro(PORT_TINY.img_size, "cpu", cfg=PORT_TINY,
                        checkpoint=str(hub / "model.safetensors"))
    assert hasattr(on, "fov")
    with np.load(bootstrap.npz_cache_path()) as data:
        names = sorted(data.files)
    jax_off = dataclasses.replace(TINY, use_fov_head=False)
    shapes = jax.eval_shape(JDepthPro(jax_off).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, TINY.img_size, TINY.img_size, 3)))
    assert names == sorted(_flatten(meta.unbox(shapes["params"])))
    off = DepthPro(dataclasses.replace(PORT_TINY, use_fov_head=False))
    load_jax_npz(bootstrap.npz_cache_path(), off)
    for k, v in off.state_dict().items():
        assert torch.equal(v, on.state_dict()[k]), k


# --------------------------------------------------------------------------
# configs

def test_config_defaults_and_tiny_are_jax():
    for field in ("use_fov_head", "use_fov_encoder", "img_size", "tile_size",
                  "hook_block_ids", "decoder_features", "dims_encoder"):
        assert getattr(DepthProConfig(), field) == getattr(JCfg(), field)
    assert DepthProConfig().use_fov_head and DepthProConfig().use_fov_encoder
    assert port_cfg(JCfg.tiny()) == DepthProConfig.tiny()


def test_preprocess_frames_equals_jax():
    from vsc_tpu.models import preprocess_frames as jax_pre
    from vsc_tpu_torch.models.depthpro import preprocess_frames
    rgb = np.random.default_rng(4).integers(0, 256, (2, 5, 7, 3), np.uint8)
    got = preprocess_frames(torch.from_numpy(rgb))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_pre(jnp.asarray(rgb))))


def test_pipeline_builds_depthpro_without_the_head(monkeypatch):
    """build_depth_fn at the production size and the dry run's config
    build DepthPro with the head off, as the JAX pipeline does (the
    model's construction is stopped: a full-width model is not built on
    the CPU here)."""
    import vsc_tpu_torch.models as models
    from vsc_tpu_torch.parallel.dryrun import small_config
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depth_fn
    seen = []

    class Stop(Exception):
        pass

    def record(cfg):
        seen.append(cfg)
        raise Stop
    monkeypatch.setattr(models, "DepthPro", record)
    with pytest.raises(Stop):
        build_depth_fn("depthpro", 1536, 1080, 1920, False, device="cpu")
    assert seen[0].img_size == 1536 and not seen[0].use_fov_head
    assert not small_config().use_fov_head
