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
shard order, into page-locked host memory from PyTorch's caching pinned
allocator where it lives on a card: a copy at the host link's speed, not
staged through a CUDA bounce buffer into fresh pageable pages.

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

_events: dict = {}    # CUDA device index -> the event gather waits on


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


def _wait(devices) -> None:
    """Wait for the work queued so far on each card's current stream."""
    import torch
    events = []
    for d in devices:
        ev = _events.get(d.index)
        if ev is None:
            ev = _events[d.index] = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        events.append(ev)
    for ev in events:
        ev.synchronize()


def gather(result):
    """A device result as one CPU tensor that the caller owns: a
    ``Sharded`` one joined in shard order. Waits for the device (while
    tracing, in a span of its own before the copy).

    A result on a card is copied into a tensor of PyTorch's caching pinned
    allocator (each part straight into its rows), queued on each card's
    current stream and waited for. The allocator hands a block out again
    only once its tensor, and every numpy view of it, is gone, so the
    page-locked memory stays bounded by the results callers still hold;
    its blocks are rounded up to a power of two (128 MiB a 1080p SBS
    batch of 8, 256 MiB a 4K batch of 4). A result on the CPU comes back
    as ``.cpu()`` gives it."""
    import torch
    parts = result.parts if isinstance(result, Sharded) else (result,)
    cards = list(dict.fromkeys(p.device for p in parts if p.is_cuda))
    if tracing():
        with span("transfer.drain"):
            _wait(cards)
    with span("transfer.copy_out", frames=result.shape[0]):
        if not cards:
            if isinstance(result, Sharded):
                return torch.cat([p.cpu() for p in parts])
            return result.cpu()
        out = torch.empty(tuple(result.shape), dtype=result.dtype,
                          pin_memory=True)
        row = 0
        for p in parts:
            out[row:row + p.shape[0]].copy_(p, non_blocking=True)
            row += p.shape[0]
        _wait(cards)
        return out
