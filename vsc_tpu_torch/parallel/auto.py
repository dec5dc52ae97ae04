"""
Automatic data-parallel batch placement
=======================================

Port of ``vsc_tpu/parallel/auto.py``. The step CLIs call shard_batch() on
every host batch and pad their dispatch shape to a multiple of
device_count(). With one device a batch is a plain tensor on it; with a
multi-device data mesh (every card of the host, ``_data_mesh``) the frame
axis is split over the mesh as a ``Sharded`` batch, and the depth model
(``pipeline/depth_map_generator.build_depth_fn``) and ``ops/stereo.
generate_sbs`` run each shard on its own card: the counterpart of the JAX
package's SPMD dispatch over its data mesh, and of the reference's several
SBS processes on one GPU. ``gather`` brings a result back to the host in
shard order.

While tracing is on (``utils/profiling``) the copies are spans:
"transfer.copy_in" (``shard_batch``), "transfer.drain" (``gather``'s wait
for the work queued before its copy) and "transfer.copy_out" (the copy
itself, with the rows copied as its frames).
"""

from __future__ import annotations

import functools

from vsc_tpu_torch.parallel.mesh import Mesh, Sharded, data_sharding
from vsc_tpu_torch.utils.profiling import span, tracing

__all__ = ["data_mesh", "device_count", "gather", "pad_to_multiple",
           "shard_batch"]

_drain_events: dict = {}    # CUDA device index -> the event gather waits on


@functools.lru_cache(maxsize=1)
def _data_mesh() -> Mesh | None:
    """Every visible card on the "data" axis; None at one card or none, as
    the JAX package's at one device."""
    import torch
    if torch.cuda.device_count() <= 1:
        return None
    from vsc_tpu_torch.parallel.mesh import make_mesh
    return make_mesh()


def data_mesh(device) -> Mesh | None:
    """The data mesh a step running on ``device`` shards its batches over:
    the default mesh when its devices are of ``device``'s kind (a step
    asked onto the CPU uses none on a host with several cards)."""
    import torch
    mesh = _data_mesh()
    if mesh is None or mesh.devices[0, 0].type != torch.device(device).type:
        return None
    return mesh


def device_count(device=None) -> int:
    """Data-axis devices a step dispatches one batch to: those of the
    default mesh (``torch.cuda.device_count()`` on a host with cards, 1
    without), or with ``device``, of ``data_mesh(device)``."""
    mesh = _data_mesh() if device is None else data_mesh(device)
    return 1 if mesh is None else mesh.shape["data"]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_batch(array, device, mesh: Mesh | None = None):
    """A host numpy batch on the device(s). To a card it goes from pinned
    memory with ``non_blocking=True``, so the copy is queued on the stream
    like a kernel and the caller does not wait for it. With a data mesh
    (``mesh``, else ``data_mesh(device)``) of more than one row, axis 0 is
    split evenly over the rows (callers pad their batch to a multiple of
    the row count) and the result is ``Sharded``; otherwise a tensor on
    ``device`` (or the mesh's one row)."""
    import torch
    with span("transfer.copy_in"):
        t = torch.from_numpy(array)
        mesh = data_mesh(device) if mesh is None else mesh
        if mesh is not None and mesh.shape["data"] > 1:
            n = mesh.shape["data"]
            axis = data_sharding(mesh, t.ndim).axis_of("data")
            if t.shape[axis] % n:
                raise ValueError(f"shard_batch: a batch of {t.shape[axis]} "
                                 f"does not split over {n} data-axis devices")
            devices = mesh.data_devices
            if any(d.type == "cuda" for d in devices):
                t = t.pin_memory()
            return Sharded(tuple(p.to(d, non_blocking=True) for p, d in
                                 zip(t.chunk(n, axis), devices)), mesh)
        if mesh is not None:
            device = mesh.devices[0, 0]
        if torch.device(device).type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t


def gather(result):
    """A device result as one CPU tensor: a ``Sharded`` one joined in shard
    order. Waits for the device (while tracing, in a span of its own
    before the copy)."""
    import torch
    parts = result.parts if isinstance(result, Sharded) else (result,)
    if tracing():
        with span("transfer.drain"):
            for p in parts:
                if p.is_cuda:
                    ev = _drain_events.get(p.device.index)
                    if ev is None:
                        ev = _drain_events[p.device.index] = \
                            torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(p.device))
                    ev.synchronize()
    with span("transfer.copy_out", frames=result.shape[0]):
        if isinstance(result, Sharded):
            return torch.cat([p.cpu() for p in parts])
        return result.cpu()
