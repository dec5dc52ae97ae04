"""``parallel/auto.gather`` on the CPU, and the host counters of
``utils/profiling``: a CPU result comes back as ``.cpu()`` gives it (a
sharded one joined in shard order), and the "transfer.*" counters of the
copy out to page-locked memory are neither recorded without a profiler
nor for a CPU result while tracing. The page-locked copy itself needs a
card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vsc_tpu_torch.ops import _cuda
from vsc_tpu_torch.parallel import make_mesh
from vsc_tpu_torch.parallel.auto import gather, shard_batch
from vsc_tpu_torch.parallel.mesh import Sharded
from vsc_tpu_torch.utils import profiling

CPU8 = [torch.device("cpu")] * 8
DTYPES = [torch.uint8, torch.int16, torch.float32, torch.bfloat16]


@pytest.fixture
def registry():
    _cuda.reset_launches()
    profiling.reset()
    yield profiling
    _cuda.reset_launches()
    profiling.reset()


def _batch(dtype, shape=(8, 5, 7, 3)):
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32)
    return (x % 251).reshape(shape).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_of_a_cpu_tensor_is_the_tensor(dtype):
    x = _batch(dtype)
    got = gather(x)
    assert got is x
    assert got.dtype == dtype and got.shape == x.shape
    assert not got.is_pinned()


@pytest.mark.parametrize("rows", [2, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_of_a_cpu_sharded_batch_joins_in_shard_order(dtype, rows):
    x = _batch(dtype)
    sharded = shard_batch(x.numpy() if dtype != torch.bfloat16
                          else x.view(torch.int16).numpy(), "cpu",
                          make_mesh(rows, 1, devices=CPU8))
    if dtype == torch.bfloat16:
        sharded = Sharded(tuple(p.view(torch.bfloat16)
                                for p in sharded.parts), sharded.mesh)
    assert isinstance(sharded, Sharded) and len(sharded.parts) == rows
    got = gather(sharded)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, x)
    assert torch.equal(got, torch.cat([p.cpu() for p in sharded.parts]))


def test_no_transfer_counter_without_a_profiler(registry):
    x = shard_batch(np.arange(96, dtype=np.uint8).reshape(8, 12), "cpu",
                    make_mesh(2, 1, devices=CPU8))
    gather(x)
    gather(x.parts[0])
    registry.count("transfer.pinned_out")
    assert registry.counters() == {}
    assert registry.spans() == []


@pytest.mark.parametrize("sharded", [False, True])
def test_no_transfer_counter_for_a_cpu_result_while_tracing(registry,
                                                            sharded):
    x = shard_batch(np.arange(96, dtype=np.uint8).reshape(8, 12), "cpu",
                    make_mesh(2 if sharded else 1, 1, devices=CPU8))
    with profile(activities=[ProfilerActivity.CPU]):
        got = gather(x)
    assert got.numpy().tolist() == np.arange(96).reshape(8, 12).tolist()
    assert not [k for k in registry.counters() if k.startswith("transfer.")]
    names = [s["name"] for s in registry.spans()]
    assert names == ["transfer.drain", "transfer.copy_out"]


def test_host_counters_count_while_tracing_and_reset_with_launches(
        registry, monkeypatch):
    registry.count("transfer.pinned_out")
    with profile(activities=[ProfilerActivity.CPU]):
        for n in (3, 5):
            registry.count("transfer.pinned_out")
            registry.count("transfer.pinned_out_bytes", n)
        registry.count("transfer.host_alloc", 0)
    registry.count("transfer.pinned_out_bytes", 7)
    assert registry.counters() == {"transfer.pinned_out": 2,
                                   "transfer.pinned_out_bytes": 8,
                                   "transfer.host_alloc": 0}
    # beside the device counters (a CPU tensor stands in for the card's)
    t = torch.zeros((_cuda.COUNTER_SLOTS, _cuda.COUNTER_STRIDE),
                    dtype=torch.int64)
    t[1, :2] = torch.tensor([4, 1])
    monkeypatch.setitem(_cuda._COUNTER_TENSORS, ("postprocess", 0), t)
    assert registry.counters() == {"transfer.pinned_out": 2,
                                   "transfer.pinned_out_bytes": 8,
                                   "transfer.host_alloc": 0,
                                   "postprocess.fast_tiles": 4,
                                   "postprocess.hole_tiles": 1}
    registry.reset()                        # spans only
    assert registry.counters()["transfer.pinned_out"] == 2
    _cuda.reset_launches()
    assert registry.counters() == {}
