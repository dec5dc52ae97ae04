"""The fused residual + LayerScale + LayerNorm step of the port's ViT
(ops/residual_norm_cuda.py) on the CPU: the plain version against the
separate ops it replaces, and the ViT's chain of fused steps against the
chain of ``Block.forward`` calls and the final norm, hooks included, on the
tiny DepthPro and Depth Anything V2 configs. The kernel itself is held to
the plain version on the card (tests/test_torch_cuda.py)."""

import dataclasses

import pytest
import torch
from torch import nn

from vsc_tpu_torch.models import vit as vit_mod
from vsc_tpu_torch.models.depth_anything import (DepthAnythingV2,
                                                 DepthAnythingV2Config)
from vsc_tpu_torch.models.depthpro import DepthPro, DepthProConfig
from vsc_tpu_torch.models.vit import ViT, init_flax_like
from vsc_tpu_torch.ops.residual_norm_cuda import (MAX_D, residual_norm,
                                                  residual_norm_plain,
                                                  residual_norm_supported)


def _operands(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    D = shape[-1]
    x = 3.0 * torch.randn(shape, generator=g) + 0.5
    y = torch.randn(shape, generator=g)
    gamma = torch.rand(D, generator=g) + 0.25
    weight = 1.0 + 0.2 * torch.randn(D, generator=g)
    bias = 0.1 * torch.randn(D, generator=g)
    return [t.to(dtype) for t in (x, y, gamma, weight, bias)]


def _bf16_ulp(t):
    """One step of bf16's grid at |t| (float32 result)."""
    m = t.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


@pytest.mark.parametrize("shape", [(2, 5, 32), (3, 7, 1024), (1, 1, 8),
                                   (4, 3, 24)])
def test_plain_f32_is_layerscale_then_layernorm_bit_for_bit(shape):
    x, y, gamma, weight, bias = _operands(shape, torch.float32, 1)
    D = shape[-1]
    ls = vit_mod.LayerScale(D, 1.0)
    norm = nn.LayerNorm(D, eps=1e-6)
    with torch.no_grad():
        ls.gamma.copy_(gamma)
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
        want_x = x + ls(y)
        want_h = norm(want_x)
    got_x, got_h = residual_norm_plain(x, y, gamma, weight, bias, 1e-6)
    assert torch.equal(got_x, want_x) and torch.equal(got_h, want_h)


@pytest.mark.parametrize("shape", [(2, 5, 32), (3, 7, 1024)])
def test_plain_bf16_rounds_the_stream_once(shape):
    # x + gamma * y in float32, one rounding (the separate bf16 ops round
    # the product and the sum each: within a step of bf16's grid at each),
    # and the LayerNorm on that stored stream, one rounding
    x, y, gamma, weight, bias = _operands(shape, torch.bfloat16, 2)
    got_x, got_h = residual_norm_plain(x, y, gamma, weight, bias, 1e-6)
    assert got_x.dtype == got_h.dtype == torch.bfloat16
    prod = y.float() * gamma.float()
    exact = x.float() + prod
    assert torch.equal(got_x, exact.to(torch.bfloat16))
    twice = x + y * gamma
    assert not torch.equal(got_x, twice)
    assert bool(((got_x.float() - twice.float()).abs()
                 <= _bf16_ulp(exact) + _bf16_ulp(prod)).all())
    want_h = nn.functional.layer_norm(got_x.float(), (shape[-1],),
                                      weight.float(), bias.float(), 1e-6)
    assert torch.equal(got_h, want_h.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_norm_on_the_cpu_is_the_plain_version(dtype):
    ops = _operands((2, 9, 64), dtype, 3)
    x = ops[0].clone()
    got = residual_norm(*ops, 1e-6)
    want = residual_norm_plain(*ops, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(ops[0], x)           # x is not written


@pytest.mark.parametrize("which", ["y", "gamma", "weight", "bias"])
def test_residual_norm_refuses_shapes_that_do_not_fit(which):
    ops = dict(zip(("x", "y", "gamma", "weight", "bias"),
                   _operands((2, 3, 16), torch.float32, 4)))
    ops[which] = ops[which][..., :8]
    with pytest.raises(ValueError, match="residual_norm"):
        residual_norm(*ops.values(), 1e-6)


@pytest.mark.parametrize("dtype,D,ok", [
    (torch.bfloat16, 1024, True), (torch.float32, 1024, True),
    (torch.bfloat16, 32, True), (torch.float32, 8, True),
    (torch.bfloat16, MAX_D, True), (torch.float32, MAX_D + 8, False),
    (torch.bfloat16, 12, False), (torch.float32, 4, False),
    (torch.float16, 1024, False), (torch.float64, 1024, False)])
def test_residual_norm_supported(dtype, D, ok):
    assert residual_norm_supported(torch.zeros((2, 3, D), dtype=dtype)) is ok


def _separate_ops(vit, images, hook_batch=None):
    """The ViT as a chain of Block.forward calls and the final norm."""
    B, p = images.shape[0], vit.cfg.patch_size
    x = vit.patch_embed(images)
    x = torch.cat([vit.cls_token.expand(B, -1, -1), x], dim=1)
    x = x + vit.pos_for(images.shape[-2] // p, images.shape[-1] // p)
    hooks = {}
    for i, blk in enumerate(vit.blocks):
        x = blk(x)
        if i in vit.hook_block_ids:
            hooks[i] = x if hook_batch is None else x[:hook_batch]
    return vit.norm(x), hooks


# (encoder config, hooked blocks, images [B, 3, h, w], hook_batch): the
# tiny DepthPro's patch encoder on its table's grid with hook_batch, the
# tiny Depth Anything V2's on a grid the table is interpolated to, with its
# four hooks
VITS = {
    "depthpro": (DepthProConfig.tiny().encoder,
                 DepthProConfig.tiny().hook_block_ids, (5, 3, 16, 16), 3),
    "dav2": (DepthAnythingV2Config.tiny().encoder,
             DepthAnythingV2Config.tiny().hook_block_ids, (2, 3, 12, 18),
             None),
}


def _vit(name, dtype):
    cfg, hooks, shape, hook_batch = VITS[name]
    g = torch.Generator().manual_seed(5)
    vit = ViT(cfg, hooks).eval()
    init_flax_like(vit, g)
    with torch.no_grad():
        for n, p in vit.named_parameters():
            if n.endswith("gamma"):      # LayerScale 1e-5 hides the sublayers
                p.uniform_(0.5, 1.5, generator=g)
            elif n.endswith(("norm1.weight", "norm2.weight", "norm.weight")):
                p.uniform_(0.8, 1.2, generator=g)
            elif n.endswith(("norm1.bias", "norm2.bias", "norm.bias")):
                p.uniform_(-0.1, 0.1, generator=g)
    images = torch.randn(shape, generator=g)
    return vit.to(dtype), images.to(dtype), hook_batch


@pytest.mark.parametrize("name", sorted(VITS))
def test_vit_chain_of_fused_steps_equals_separate_ops_f32(name):
    vit, images, hook_batch = _vit(name, torch.float32)
    with torch.no_grad():
        got, got_hooks = vit(images, hook_batch=hook_batch)
        want, want_hooks = _separate_ops(vit, images, hook_batch)
    assert torch.equal(got, want)
    assert sorted(got_hooks) == sorted(want_hooks) == list(vit.hook_block_ids)
    for i in want_hooks:
        assert torch.equal(got_hooks[i], want_hooks[i]), i
    if hook_batch is not None:
        assert got_hooks[vit.hook_block_ids[0]].shape[0] == hook_batch


@pytest.mark.parametrize("name", sorted(VITS))
def test_vit_chain_of_fused_steps_bf16_one_rounding_of_the_stream(name):
    # one block: the fused step's stream is x + gamma * y rounded once,
    # within a bf16 step at the sum and at the product of the separate
    # ops' (which round each);
    # the whole ViT: as close to the float32 model as the separate ops are,
    # give or take one bf16 step of the largest value
    vit, images, hook_batch = _vit(name, torch.bfloat16)
    blk = vit.blocks[0]
    with torch.no_grad():
        x = torch.randn((2, 11, vit.cfg.embed_dim)).to(torch.bfloat16)
        h = blk.norm1(x)
        y = blk.attn(h)
        x1, _ = vit_mod._residual_norm(x, y, blk.ls1, blk.norm2)
        prod = y.float() * blk.ls1.gamma.float()
        exact = x.float() + prod
        assert torch.equal(x1, exact.to(torch.bfloat16))
        assert bool(((x1.float() - (x + blk.ls1(y)).float()).abs()
                     <= _bf16_ulp(exact) + _bf16_ulp(prod)).all())
        got, got_hooks = vit(images, hook_batch=hook_batch)
        sep, sep_hooks = _separate_ops(vit, images, hook_batch)
        f32 = vit.float()
        ref, ref_hooks = f32(images.float(), hook_batch=hook_batch)
    pairs = [(got, sep, ref)] + [(got_hooks[i], sep_hooks[i], ref_hooks[i])
                                 for i in ref_hooks]
    for a, b, r in pairs:
        top = float(r.abs().max())
        ulp = float(_bf16_ulp(torch.tensor(top)))
        fused = float((a.float() - r).abs().max())
        separate = float((b.float() - r).abs().max())
        assert fused <= separate + ulp, (fused, separate, ulp)


def _depthpro(g):
    cfg = dataclasses.replace(DepthProConfig.tiny(), use_fov_head=False,
                              use_fov_encoder=False)
    return DepthPro(cfg).eval(), torch.rand((2, 64, 64, 3), generator=g) * 2 - 1


def _dav2(g):
    model = DepthAnythingV2(DepthAnythingV2Config.tiny()).eval()
    return model, torch.randn((2, 12, 16, 3), generator=g)


@pytest.mark.parametrize("build", [_depthpro, _dav2], ids=["depthpro", "dav2"])
def test_models_equal_with_the_separate_ops_f32(build, monkeypatch):
    # the whole model in float32: the same bits through the fused steps as
    # through the separate ops (the ViT's guard refusing the fused step)
    g = torch.Generator().manual_seed(6)
    model, x = build(g)
    init_flax_like(model, g)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("gamma"):
                p.uniform_(0.5, 1.5, generator=g)
        got = model(x)
        monkeypatch.setattr(vit_mod, "residual_norm_supported",
                            lambda x: False)
        want = model(x)
    got = got if isinstance(got, dict) else {"out": got}
    want = want if isinstance(want, dict) else {"out": want}
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
