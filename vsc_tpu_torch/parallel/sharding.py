"""
Parameter sharding rules
========================

Port of ``vsc_tpu/parallel/sharding.py``. Maps the ViT's *logical* axis
names onto mesh axes:

  "heads" -> "model"   (attention qkv / out projections split over heads)
  "mlp"   -> "model"   (MLP hidden dim split)
  "embed" -> replicated

the Megatron layout for a ViT: column-parallel (qkv, fc1) then
row-parallel (proj, fc2), one sum across the model axis each
(``models/vit.Block.forward_sharded``). Where the JAX package annotates its
flax parameters, the port keeps a table from parameter names to logical
axes, in ``nn.Linear``'s [out, in] order.

The fused qkv keeps PyTorch's [q | k | v] row order (``models/vit.py``),
not the JAX package's per-head interleaved columns, so a rank's share of
it is three row ranges, q[r D/mp : (r+1) D/mp] and the same range of k and
of v, joined into a local [q_r | k_r | v_r]: H/mp whole heads, which the
attention kernels read as they read the unsharded projection. The proj and
fc2 biases stay whole and are added once, after the sum.

Without XLA to place a parameter tree, ``shard_params`` returns one model
replica per data row of the mesh, each rank's share of its blocks built as
its own module on its own device.
"""

from __future__ import annotations

import copy

import torch

from vsc_tpu_torch.parallel.mesh import Mesh, NamedSharding, replicated

__all__ = ["LOGICAL_RULES", "PARAM_AXES", "shard_params", "param_shardings",
           "shard_tensor"]

LOGICAL_RULES = (
    ("heads", "model"),
    ("mlp", "model"),
    ("embed", None),
)

# logical axes of the ViT block parameters, by the end of their name;
# every other parameter is replicated
PARAM_AXES = {
    "attn.qkv.weight": ("heads", "embed"),
    "attn.qkv.bias": ("heads",),
    "attn.proj.weight": ("embed", "heads"),
    "mlp.fc1.weight": ("mlp", "embed"),
    "mlp.fc1.bias": ("mlp",),
    "mlp.fc2.weight": ("embed", "mlp"),
}
_FUSED_QKV = ("attn.qkv.weight", "attn.qkv.bias")


def _logical_axes(name: str):
    for suffix, axes in PARAM_AXES.items():
        if name == suffix or name.endswith("." + suffix):
            return axes
    return None


def param_shardings(model, mesh: Mesh) -> dict:
    """{parameter name: NamedSharding} for every parameter of ``model``
    (replicated where the table has no entry)."""
    rules = dict(LOGICAL_RULES)
    out = {}
    for name, _ in model.named_parameters():
        axes = _logical_axes(name)
        out[name] = (replicated(mesh) if axes is None else NamedSharding(
            mesh, tuple(rules.get(a) for a in axes)))
    return out


def shard_tensor(name: str, t, sharding: NamedSharding, rank: int):
    """Model-axis rank ``rank``'s share of parameter ``name`` (a view)."""
    dim = sharding.axis_of("model")
    if dim is None:
        return t
    n = sharding.mesh.shape["model"]
    if name.endswith(_FUSED_QKV):        # [q | k | v]: a range of each
        parts = t.chunk(3, dim)
        return torch.cat([p.chunk(n, dim)[rank] for p in parts], dim)
    return t.chunk(n, dim)[rank]


def _own(t, device):
    """A copy of ``t`` with its own contiguous storage on ``device``."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def _shard_block(block, prefix: str, specs: dict, row: tuple) -> list:
    """The rank blocks of ``block`` (parameters under ``prefix``), one on
    each device of ``row``."""
    from vsc_tpu_torch.models.vit import Block
    ranks = []
    for r, dev in enumerate(row):
        state = {k: _own(shard_tensor(k, v, specs[prefix + k], r), dev)
                 for k, v in block.named_parameters()}
        with torch.device("meta"):
            rank = Block(block.cfg, shards=len(row))
        rank.load_state_dict(state, strict=True, assign=True)
        ranks.append(rank.eval())
    return ranks


def _device_of(model):
    return next(model.parameters()).device


@torch.no_grad()
def shard_params(model, mesh: Mesh) -> list:
    """One replica of ``model`` for each data row of ``mesh`` (rows that
    name the same devices share one), on the row's first device. With a
    model axis of 1 a row on the model's own device gets ``model`` itself,
    any other a copy. With a model axis of mp > 1 every replica is a copy
    whose ViT blocks each carry their mp rank blocks (``Block.ranks``),
    rank r's on the row's device r, sliced by ``param_shardings``; the
    replica's blocks then hold no attention or MLP of their own, so the
    projections' weights are split over the row, not held whole beside
    the shards."""
    from vsc_tpu_torch.models.vit import Block
    specs = param_shardings(model, mesh)
    mp = mesh.shape["model"]
    made = {}
    out = []
    for i in range(mesh.shape["data"]):
        row = mesh.row(i)
        if row not in made:
            if mp == 1 and row[0] == _device_of(model):
                rep = model
            else:
                rep = copy.deepcopy(model).to(row[0])
            if mp > 1:
                for name, m in model.named_modules():
                    if isinstance(m, Block):
                        blk = rep.get_submodule(name)
                        blk.ranks = _shard_block(m, name + ".", specs, row)
                        # the ranks hold the projections: no whole copy
                        blk.attn = blk.mlp = None
            made[row] = rep
        out.append(made[row])
    return out
