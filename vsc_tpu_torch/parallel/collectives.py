"""
Collectives over the model axis
===============================

The few collectives the tensor- and sequence-parallel ViT needs
(``models/vit.py``), as plain functions over per-rank tensors: ``parts[r]``
lies on ``devices[r]``, one entry per rank of a mesh row's model axis.
Where XLA inserts these under the JAX package's SPMD partitioner, the port
calls them itself.

They are written with ``.to(device)`` and ``+`` (no process groups, no
``torch.cuda.comm``), so the same code runs on the CPU, on one card named
several times, and across the cards of one host. Sums run in float32 in a
fixed rank order, so every rank that receives a sum receives the same bits.
A device named by several ranks computes a result once and hands all of
them the same tensor: no caller writes into what a collective returns.
"""

from __future__ import annotations

import torch

__all__ = ["broadcast", "psum", "all_reduce", "split_tokens",
           "gather_tokens", "all_gather", "reduce_scatter"]


def _per_device(devices, fn) -> list:
    """[fn(d) for d in devices], computed once for each distinct device."""
    done = {}
    out = []
    for d in devices:
        if d not in done:
            done[d] = fn(d)
        out.append(done[d])
    return out


def broadcast(x, devices) -> list:
    """``x`` on every rank's device."""
    return _per_device(devices, lambda d: x.to(d))


def psum(parts, device):
    """The float32 sum of ``parts`` on ``device``, in rank order."""
    total = parts[0].to(device, torch.float32)
    for p in parts[1:]:
        total = total + p.to(device, torch.float32)
    return total


def all_reduce(parts, devices) -> list:
    """``psum`` on the first rank's device, handed to every rank."""
    return broadcast(psum(parts, devices[0]), devices)


def _chunk(n: int, ranks: int) -> int:
    return -(-n // ranks)


def split_tokens(x, devices, axis: int = 1) -> list:
    """Rank r's share of ``x``'s token axis, on its device: equal chunks of
    ceil(T / ranks) tokens, the last padded with zeros."""
    T = x.shape[axis]
    c = _chunk(T, len(devices))
    if c * len(devices) != T:
        pad = list(x.shape)
        pad[axis] = c * len(devices) - T
        x = torch.cat([x, x.new_zeros(pad)], dim=axis)
    return [x.narrow(axis, r * c, c).to(d) for r, d in enumerate(devices)]


def gather_tokens(parts, device, length: int, axis: int = 1):
    """The token chunks of ``split_tokens`` joined on ``device``, the pad
    dropped (``length`` real tokens)."""
    return torch.cat([p.to(device) for p in parts], dim=axis).narrow(
        axis, 0, length)


def all_gather(parts, devices, length: int, axis: int = 1) -> list:
    """``gather_tokens`` on every rank's device."""
    return _per_device(devices,
                       lambda d: gather_tokens(parts, d, length, axis))


def reduce_scatter(parts, devices, axis: int = 1) -> list:
    """Rank r's token chunk (as ``split_tokens`` cuts it) of the float32
    sum of the full-length ``parts``, summed in rank order on its device."""
    T = parts[0].shape[axis]
    c = _chunk(T, len(devices))
    out = []
    for r, d in enumerate(devices):
        lo, n = min(r * c, T), max(0, min(c, T - r * c))
        piece = psum([p.narrow(axis, lo, n) for p in parts], d)
        if n < c:
            pad = list(piece.shape)
            pad[axis] = c - n
            piece = torch.cat([piece, piece.new_zeros(pad)], dim=axis)
        out.append(piece)
    return out
