"""The depth model's opt-in routes of the port on the CPU, against the JAX
package: the deconv kernel's plain version against ``deconv2x2_pallas`` and
torch's transposed convolution, the split-q/k/v attention's plain version
against ``short_seq_attention`` (both Pallas kernels in interpret mode), the
attention dispatch, a DepthPro whose encoder has head dim 16 (the widths of
JAX's ``DepthProConfig.tiny()``, which sends it to ``short_seq_attention``)
and the depth dtype the environment selects."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from vsc_tpu_torch.ops.attention_cuda import (attention_route,
                                              short_seq_attention,
                                              short_seq_attention_plain)
from vsc_tpu_torch.ops.deconv_cuda import (deconv2x2, deconv2x2_plain,
                                           deconv2x2_supported, pack_weight)


# tests/test_deconv_pallas.py's shapes (NHWC there, NCHW here)
@pytest.mark.parametrize("shape,features,bias", [
    ((2, 8, 16, 128), 128, False),
    ((1, 16, 8, 256), 128, True),
    ((1, 24, 24, 128), 256, False),
])
def test_deconv_matches_jax_kernel_and_conv_transpose(shape, features, bias):
    from vsc_tpu.ops.deconv_pallas import deconv2x2_pallas
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, shape).astype(np.float32)
    k = rng.normal(0, 0.1, (2, 2, shape[-1], features)).astype(np.float32)
    b = rng.normal(0, 0.1, (features,)).astype(np.float32) if bias else None
    want = np.asarray(deconv2x2_pallas(
        jnp.asarray(x), jnp.asarray(k),
        None if b is None else jnp.asarray(b)))            # [N, 2H, 2W, O]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    wt = torch.from_numpy(k).permute(2, 3, 0, 1).contiguous()  # [C, O, 2, 2]
    bt = None if b is None else torch.from_numpy(b)
    assert deconv2x2_supported(xt, features)
    got = deconv2x2(xt, wt, bt)
    assert got.shape == (shape[0], features, 2 * shape[1], 2 * shape[2])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        got, torch.nn.functional.conv_transpose2d(xt, wt, bt, stride=2),
        rtol=1e-5, atol=1e-5)


def test_deconv_plain_casts_once_and_guard_matches_jax():
    from vsc_tpu.ops.deconv_pallas import deconv2x2_supported as jguard
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (1, 128, 8, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.1, (128, 128, 2, 2)).astype(
        np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, (128,)).astype(np.float32))
    got = deconv2x2_plain(x.bfloat16(), w.bfloat16(), b.bfloat16())
    want = deconv2x2_plain(x.bfloat16().float(), w.bfloat16().float(),
                           b.bfloat16().float()).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    for (n, c, h, wd), o in [((1, 96, 8, 8), 128), ((1, 128, 8, 8), 96),
                             ((1, 128, 12, 8), 128), ((1, 128, 8, 8), 128),
                             ((2, 1024, 24, 24), 1024)]:
        assert deconv2x2_supported(torch.zeros(n, c, h, wd), o) == bool(
            jguard(jnp.zeros((n, h, wd, c)), o))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,o,bias", [(2, 128, 8, 16, 128, True),
                                            (1, 256, 16, 8, 128, False)])
def test_deconv_channels_last_gives_conv_transposes_format(dtype, n, c, h, w,
                                                           o, bias):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (n, h, w, c)).astype(
        np.float32)).to(dtype).permute(0, 3, 1, 2)      # NHWC memory
    wt = torch.from_numpy(rng.normal(0, 0.1, (c, o, 2, 2)).astype(
        np.float32)).to(dtype)
    b = torch.from_numpy(rng.normal(0, 0.1, (o,)).astype(np.float32)).to(
        dtype) if bias else None
    assert x.is_contiguous(memory_format=torch.channels_last)
    got = deconv2x2(x, wt, b)
    ref = torch.nn.functional.conv_transpose2d(x, wt, b, stride=2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert ref.is_contiguous(memory_format=torch.channels_last)
    assert not got.is_contiguous() and not ref.is_contiguous()
    assert torch.equal(got, deconv2x2_plain(x.contiguous(), wt, b))
    nchw = deconv2x2(x.contiguous(), wt, b)
    assert nchw.is_contiguous() and torch.equal(nchw, got)


def test_deconv_plain_on_a_token_slice_gives_conv_transposes_format():
    """The image encoder's tokens less their cls token, as a map: images
    in channels-last memory spaced one token apart. The plain version
    returns conv_transpose2d's values and memory format (channels-last)."""
    rng = np.random.default_rng(7)
    n, g, c, o = 2, 4, 128, 64
    tokens = torch.from_numpy(rng.normal(0, 1, (n, 1 + g * g, c)).astype(
        np.float32))
    x = tokens[:, 1:].reshape(n, g, g, c).permute(0, 3, 1, 2)
    assert not x.is_contiguous(memory_format=torch.channels_last)
    wt = torch.from_numpy(rng.normal(0, 0.1, (c, o, 2, 2)).astype(
        np.float32))
    got = deconv2x2(x, wt)
    ref = torch.nn.functional.conv_transpose2d(x, wt, stride=2)
    assert ref.is_contiguous(memory_format=torch.channels_last)
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,o", [(128, 128), (256, 64), (32, 128)])
def test_pack_weight_matches_plain(c, o):
    """The kernel's product on the packed weight: Y[p, q] = sum_c X[p, c]
    Wt[q, c] over NHWC pixels, row q = a*2O + b*O + o a contiguous span of
    output row 2i+a, equals the plain version."""
    rng = np.random.default_rng(5)
    n, h, w = 2, 3, 5
    x = torch.from_numpy(rng.normal(0, 1, (n, c, h, w)).astype(np.float32))
    wt = torch.from_numpy(rng.normal(0, 0.1, (c, o, 2, 2)).astype(
        np.float32))
    packed = pack_weight(wt)
    assert packed.shape == (4 * o, c) and packed.is_contiguous()
    y = x.permute(0, 2, 3, 1).reshape(-1, c) @ packed.T    # [NHW, 4O]
    # [n, i, j, a, b, o] -> [n, o, (i, a), (j, b)]
    y = y.reshape(n, h, w, 2, 2, o).permute(0, 5, 1, 3, 2, 4)
    torch.testing.assert_close(y.reshape(n, o, 2 * h, 2 * w),
                               deconv2x2_plain(x, wt), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [3, 4])
def test_deconv_bf16_biased_site_against_jax_kernel(seed):
    """bf16 at a biased site (C = O = 128, as the head's deconv). JAX
    rounds twice: the f32 product z to bf16, then z + bias to bf16
    (deconv_pallas.py:66-68); the port rounds z + bias once, as cuDNN's
    conv_transpose2d does. So ~30 % of outputs differ, each by at most one
    step of bf16's grid at the larger of |z| and the outputs (the first
    rounding moves z by half a step of z's own grid, and z + bias can be
    far smaller than z)."""
    from vsc_tpu.ops.deconv_pallas import deconv2x2_pallas
    rng = np.random.default_rng(seed)
    n, h, w, c, o = 1, 8, 16, 128, 128
    x = torch.from_numpy(rng.normal(0, 1, (n, h, w, c)).astype(
        np.float32)).bfloat16()
    k = torch.from_numpy(rng.normal(0, (4 * c) ** -0.5, (2, 2, c, o)).astype(
        np.float32)).bfloat16()
    b = torch.from_numpy(rng.normal(0, 0.1, (o,)).astype(
        np.float32)).bfloat16()
    want = np.asarray(deconv2x2_pallas(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (x, k, b))).astype(jnp.float32))       # [N, 2H, 2W, O]
    xt, wt = x.permute(0, 3, 1, 2), k.permute(2, 3, 0, 1).contiguous()
    got = deconv2x2(xt, wt, b).float().permute(0, 2, 3, 1).numpy()
    z = deconv2x2_plain(xt.float(), wt.float()).permute(0, 2, 3, 1).numpy()
    mag = np.maximum(np.abs(z), np.maximum(np.abs(got), np.abs(want)))
    step = 2.0 ** (np.floor(np.log2(mag)) - 7)        # bf16: 8 bits
    diff = np.abs(got - want)
    assert np.all(diff <= step)
    assert 0.0 < float(np.mean(diff > 0)) < 0.5


def test_convt2x2_packs_its_weight_once_per_version():
    from vsc_tpu_torch.models.depthpro import ConvT2x2
    m = ConvT2x2(128, 64)
    first = m.packed_weight()
    assert m.packed_weight() is first                  # cached
    assert torch.equal(first, pack_weight(m.weight.detach()))
    with torch.no_grad():
        m.weight.mul_(2.0)                             # a new version
    again = m.packed_weight()
    assert again is not first and torch.equal(again, 2.0 * first)
    m.load_state_dict({"weight": torch.ones(128, 64, 2, 2)})
    assert torch.equal(m.packed_weight(), torch.ones(256, 128))
    m.bfloat16()                                       # a new dtype
    assert m.packed_weight().dtype == torch.bfloat16


def test_depthpro_deconv_sites_read_channels_last(monkeypatch):
    """Every ConvT2x2 of the port's DepthPro gets a channels-last input
    (the NHWC images and tokens permuted, cuDNN's convolutions keeping the
    format; at batch 2 the image encoder's tokens less their cls token are
    images spaced one token apart), so the kernel route reads it with no
    copy; on either route each site returns what conv_transpose2d returns,
    format included."""
    from vsc_tpu_torch.models import DepthPro, DepthProConfig, ViTConfig
    from vsc_tpu_torch.models.depthpro import DECONV_ENV, ConvT2x2
    torch.manual_seed(0)
    cfg = DepthProConfig(img_size=128, tile_size=32,
                         encoder=ViTConfig(img_size=32, patch_size=4,
                                           embed_dim=128, depth=2,
                                           num_heads=2),
                         hook_block_ids=(0, 1), decoder_features=128,
                         dims_encoder=(128, 128, 128, 128),
                         use_fov_head=False)
    model = DepthPro(cfg).eval()
    seen = []
    cl = torch.channels_last

    def hook(mod, args, out):
        x, = args
        ref = torch.nn.functional.conv_transpose2d(x, mod.weight, mod.bias,
                                                   stride=2)
        seen.append((x[0].permute(1, 2, 0).is_contiguous()
                     and not x.is_contiguous(),
                     out.is_contiguous(memory_format=cl) and
                     ref.is_contiguous(memory_format=cl),
                     deconv2x2_supported(x, mod.weight.shape[1]),
                     float((out - ref).abs().max()),
                     x.is_contiguous(memory_format=cl)))
    sites = [m for m in model.modules() if isinstance(m, ConvT2x2)]
    for m in sites:
        m.register_forward_hook(hook)
    img = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (2, 128, 128, 3)).astype(np.float32))
    with torch.no_grad():
        for env in ("0", "1"):
            monkeypatch.setenv(DECONV_ENV, env)
            model(img)
    assert len(sites) == 14 and len(seen) == 2 * len(sites)
    assert all(cl_in and cl_out for cl_in, cl_out, *_ in seen)
    assert any(guard for _, _, guard, *_ in seen)    # the kernel route ran
    assert max(err for *_, err, _ in seen) <= 1e-4
    assert not all(dense for *_, dense in seen)      # the cls-token slice


def test_convt2x2_route_follows_the_env(monkeypatch):
    from vsc_tpu_torch.models.depthpro import ConvT2x2
    m = ConvT2x2(128, 128, bias=True)
    with torch.no_grad():
        m.bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
    x = torch.randn((2, 128, 8, 16), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        monkeypatch.delenv("VSC_TPU_PALLAS_DECONV", raising=False)
        conv = m(x)
        monkeypatch.setenv("VSC_TPU_PALLAS_DECONV", "1")
        kern = m(x)
    assert [k for k, _ in m.named_parameters()] == ["weight", "bias"]
    assert tuple(m.weight.shape) == (128, 128, 2, 2)
    torch.testing.assert_close(kern, conv, rtol=1e-5, atol=1e-5)


def _qkv_views(B, T, H, Dh, seed):
    """q, k, v as strided [B, T, H, Dh] views of one fused projection, as
    models/vit.Attention hands them to the kernel."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(0, 1, (B, T, 3 * H * Dh)).astype(
        np.float32))
    return qkv.view(B, T, 3, H, Dh).unbind(2)


# tests/test_attention_pallas.py's shapes, plus head dim 80
@pytest.mark.parametrize("B,T,H,Dh", [(2, 37, 4, 16), (4, 64, 8, 32),
                                      (2, 37, 2, 80)])
def test_split_attention_matches_jax_kernel(B, T, H, Dh):
    from vsc_tpu.ops.attention_pallas import short_seq_attention as jssa
    q, k, v = _qkv_views(B, T, H, Dh, seed=Dh)
    assert q.stride()[-1] == 1 and not q.is_contiguous()
    scale = 1.0 / np.sqrt(Dh)
    want = np.asarray(jssa(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                           scale))
    got = short_seq_attention(q, k, v, scale)
    assert got.shape == (B, T, H, Dh) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert torch.equal(got, short_seq_attention_plain(
        q.contiguous(), k.contiguous(), v.contiguous(), scale))


@pytest.mark.parametrize("dtype,dh,route", [
    (torch.bfloat16, 64, "qkv"), (torch.float32, 64, "split"),
    (torch.bfloat16, 16, "split"), (torch.float32, 80, "split"),
    (torch.bfloat16, 128, "split"), (torch.float32, 16, "split"),
    (torch.float16, 64, None), (torch.float32, 8, None),
    (torch.bfloat16, 72, None), (torch.float32, 256, None)])
def test_attention_route(dtype, dh, route):
    if route is None:
        with pytest.raises(ValueError, match="no kernel takes"):
            attention_route(dtype, dh)
    else:
        assert attention_route(dtype, dh) == route


@pytest.mark.parametrize("dtype,dh,tokens,route", [
    (torch.bfloat16, 64, 577, "qkv"), (torch.bfloat16, 64, 640, "qkv"),
    (torch.bfloat16, 64, 641, "flash"),
    (torch.bfloat16, 64, 1025, "flash"),
    (torch.float32, 64, 640, "split"),
    (torch.float32, 64, 1025, "split_two_pass"),
    (torch.bfloat16, 16, 4097, "split_two_pass"),
    (torch.float16, 64, 1025, None)])
def test_attention_route_by_tokens(dtype, dh, tokens, route):
    # past 640 tokens (input 2048 and up, Depth Anything V2's 2,443) bf16 at
    # head dim 64 goes to the flash kernel, every other case to the split
    # kernel's two-pass route; no token count is refused
    if route is None:
        with pytest.raises(ValueError, match="no kernel takes"):
            attention_route(dtype, dh, tokens)
    else:
        assert attention_route(dtype, dh, tokens) == route


def test_depthpro_head_dim_16_matches_jax():
    """JAX's tiny() encoder widths (embed 32, 2 heads: head dim 16), which
    its ViT sends to short_seq_attention; float32, weights carried across."""
    from vsc_tpu.models import DepthPro as JDepthPro
    from vsc_tpu.models import DepthProConfig as JCfg
    from vsc_tpu.models import ViTConfig as JViTCfg
    from vsc_tpu.models.convert import _flatten
    from vsc_tpu_torch.models import DepthPro, DepthProConfig, ViTConfig
    from vsc_tpu_torch.models.convert import state_dict_from_jax
    enc = dict(img_size=16, patch_size=2, embed_dim=32, depth=4, num_heads=2)
    small = dict(img_size=64, tile_size=16, hook_block_ids=(0, 2),
                 decoder_features=16, dims_encoder=(16, 24, 32, 32))
    jcfg = JCfg(encoder=JViTCfg(flash_attention=True, **enc),
                use_fov_head=False, **small)
    model = JDepthPro(jcfg)
    params = meta.unbox(model.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 64, 64, 3)))["params"])
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    rng = np.random.default_rng(0)
    for k in flat:      # LayerScale 1e-5 would hide the attention path
        if k.endswith("/gamma"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [jnp.asarray(flat[k]) for k in _flatten(params)])
    tmodel = DepthPro(DepthProConfig(encoder=ViTConfig(**enc),
                                     use_fov_head=False, **small))
    tmodel.load_state_dict(state_dict_from_jax(flat, tmodel.eval()),
                           strict=True)
    assert attention_route(torch.float32, 16) == "split"
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(model.apply({"params": jparams}, jnp.asarray(x))[
        "canonical_inverse_depth"])
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))["canonical_inverse_depth"].numpy()
    assert got.shape == want.shape == (2, 512, 512)
    assert np.std(want) > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("env,device,want", [
    (None, "cuda", torch.bfloat16), (None, "cpu", torch.float32),
    ("float32", "cuda", torch.float32), ("bfloat16", "cpu", torch.bfloat16),
    ("float16", "cuda", torch.float32)])
def test_depth_dtype_reads_the_env_as_jax_does(monkeypatch, env, device,
                                               want):
    from vsc_tpu_torch.pipeline.depth_map_generator import (DTYPE_ENV,
                                                            depth_dtype)
    if env is None:
        monkeypatch.delenv(DTYPE_ENV, raising=False)
    else:
        monkeypatch.setenv(DTYPE_ENV, env)
    assert depth_dtype(device) == want


def test_build_depthpro_honours_the_dtype_env(monkeypatch):
    from vsc_tpu_torch.models import DepthProConfig, ViTConfig
    from vsc_tpu_torch.pipeline.depth_map_generator import build_depthpro
    cfg = DepthProConfig(img_size=64, tile_size=16,
                         encoder=ViTConfig(img_size=16, patch_size=2,
                                           embed_dim=32, depth=1,
                                           num_heads=2),
                         hook_block_ids=(0, 0), decoder_features=16,
                         dims_encoder=(16, 24, 32, 32), use_fov_head=False)
    monkeypatch.setenv("VSC_TPU_DEPTH_DTYPE", "bfloat16")
    m = build_depthpro(64, "cpu", cfg=cfg)
    assert m.head[0].weight.dtype == torch.bfloat16
    with torch.no_grad():
        d = m(torch.zeros((1, 64, 64, 3)))["canonical_inverse_depth"]
    assert d.dtype == torch.float32 and d.shape == (1, 512, 512)
    monkeypatch.delenv("VSC_TPU_DEPTH_DTYPE")
    assert build_depthpro(64, "cpu", cfg=cfg).head[0].weight.dtype == (
        torch.float32)
