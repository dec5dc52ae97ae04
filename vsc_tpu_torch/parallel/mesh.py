"""
Device meshes, shardings and sharded batches
============================================

Port of ``vsc_tpu/parallel/mesh.py``. The parallelism axes:

  "data"   frame-axis data parallelism: a batch of video frames is split
           over the rows of the mesh, each row converting its own frames;
           the primary scale-out axis.
  "model"  tensor parallelism inside the depth ViT (attention heads, MLP
           hidden), and sequence parallelism between its blocks
           (``parallel/sharding.py``, ``models/vit.py``).

The JAX package runs one controller over a ``jax.sharding.Mesh``: sharded
arrays flow through jit and XLA inserts the collectives. The port keeps
that model with explicit torch: a ``Mesh`` is a [data, model] grid of
``torch.device``s, a batch placed on it is a ``Sharded`` value (one tensor
a data row, on the row's first device), and the few collectives the ViT
needs are plain functions over per-device tensors
(``parallel/collectives.py``). One process drives every device of its
host; ``parallel/distributed.py`` joins hosts.

A device may appear more than once in the grid: ``make_mesh(8, devices=
[torch.device("cpu")] * 8)`` is the counterpart of the JAX package's
``--xla_force_host_platform_device_count=8``, and a mesh that names one
card twice runs every sharded path on that card.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

__all__ = ["Mesh", "NamedSharding", "Sharded", "make_mesh", "data_sharding",
           "replicated", "default_devices", "on_device"]


class Mesh:
    """A [data, model] grid of devices. ``devices`` is the grid as a numpy
    object array, ``shape`` maps each axis name to its size (as the JAX
    mesh's does)."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty [data, model] grid, got "
                             f"shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def row(self, i: int) -> tuple:
        """The model-axis devices of data row ``i``."""
        return tuple(self.devices[i])

    @property
    def data_devices(self) -> tuple:
        """The first device of each data row: where a batch's shards live."""
        return tuple(self.devices[:, 0])

    def distinct_devices(self) -> list:
        """Every device of the grid once, in grid order."""
        return list(dict.fromkeys(self.devices.flat))

    def _key(self):
        return tuple(tuple(str(d) for d in r) for r in self.devices)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        d, m = self.devices.shape
        return f"Mesh({d} data x {m} model: {self._key()})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lies on a mesh: ``spec[i]`` names the mesh axis that
    splits dimension i, or None (replicated along it); dimensions past the
    spec's length are replicated, as in a JAX ``PartitionSpec``."""
    mesh: Mesh
    spec: tuple = ()

    def axis_of(self, name: str) -> int | None:
        """The tensor dimension split over mesh axis ``name``, or None."""
        return self.spec.index(name) if name in self.spec else None


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A batch placed on a mesh: ``parts[i]`` holds data row i's rows of
    axis 0 (an equal share, in order) on ``mesh.data_devices[i]``."""
    parts: tuple
    mesh: Mesh

    def __post_init__(self):
        if len(self.parts) != self.mesh.shape["data"]:
            raise ValueError(f"{len(self.parts)} parts for a data axis of "
                             f"{self.mesh.shape['data']}")

    @property
    def shape(self) -> tuple:
        lead = sum(p.shape[0] for p in self.parts)
        return (lead, *self.parts[0].shape[1:])

    @property
    def dtype(self):
        return self.parts[0].dtype


def default_devices() -> list:
    """Every visible CUDA device, else the one CPU device."""
    n = torch.cuda.device_count()
    if n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")]


def _indexed(device) -> torch.device:
    """``device`` as a torch.device, "cuda" with the current card's index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(data: int | None = None, model: int = 1,
              devices=None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: ``default_devices()``,
    all on the data axis)."""
    devices = [_indexed(d) for d in (
        devices if devices is not None else default_devices())]
    n = len(devices)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} devices, "
                         f"have {n}")
    grid = np.empty((data, model), dtype=object)
    for i, dev in enumerate(devices[: data * model]):
        grid[i // model, i % model] = dev
    return Mesh(grid)


def data_sharding(mesh: Mesh, ndim: int, batch_axis: int = 0) -> NamedSharding:
    """Split axis ``batch_axis`` over "data", replicate the rest: the
    layout of frame batches."""
    spec = [None] * ndim
    spec[batch_axis] = "data"
    return NamedSharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def on_device(device):
    """The CUDA device context of ``device`` (the hand-written kernels
    launch on the current device), or nothing for a CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
