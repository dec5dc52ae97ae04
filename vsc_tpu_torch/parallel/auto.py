"""
Batch placement for the step CLIs
=================================

The one-device half of ``vsc_tpu/parallel/auto.py``: the step CLIs call
shard_batch() on every host batch and pad their dispatch shape to a
multiple of device_count(). The port dispatches each step to one device;
the JAX package shards the frame axis over a data mesh of every device,
which the port does not do yet.
"""

from __future__ import annotations

__all__ = ["device_count", "pad_to_multiple", "shard_batch"]


def device_count() -> int:
    """Devices a step dispatches one batch to: one."""
    return 1


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_batch(array, device):
    """A host numpy batch as a tensor on ``device``. To the card it goes
    from pinned memory with ``non_blocking=True``, so the copy is queued
    on the stream like a kernel and the caller does not wait for it."""
    import torch
    t = torch.from_numpy(array)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
