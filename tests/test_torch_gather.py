"""``parallel/auto.gather`` on the CPU, and what the registry of
``utils/profiling`` keeps of it: a CPU result comes back as ``.cpu()``
gives it (a sharded one joined in shard order); no span is recorded
without a profiler, and while tracing a CPU result's gather leaves its
two transfer spans. The device counters read and reset with the launch
counts. The page-locked copy itself needs a card
(tests/test_torch_cuda.py)."""

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
    """Untraced, gather records no span and no counter."""
    x = shard_batch(np.arange(96, dtype=np.uint8).reshape(8, 12), "cpu",
                    make_mesh(2, 1, devices=CPU8))
    gather(x)
    gather(x.parts[0])
    assert registry.counters() == {}
    assert registry.spans() == []


@pytest.mark.parametrize("sharded", [False, True])
def test_no_transfer_counter_for_a_cpu_result_while_tracing(registry,
                                                            sharded):
    """Traced, a CPU result's gather leaves exactly its drain and copy-out
    spans, the copy-out with the result's rows as its frames, and no
    counter."""
    x = shard_batch(np.arange(96, dtype=np.uint8).reshape(8, 12), "cpu",
                    make_mesh(2 if sharded else 1, 1, devices=CPU8))
    with profile(activities=[ProfilerActivity.CPU]):
        got = gather(x)
    assert got.numpy().tolist() == np.arange(96).reshape(8, 12).tolist()
    assert registry.counters() == {}
    recorded = registry.spans()
    assert [s["name"] for s in recorded] == ["transfer.drain",
                                             "transfer.copy_out"]
    assert [s["frames"] for s in recorded] == [None, 8]


def test_host_counters_count_while_tracing_and_reset_with_launches(
        registry, monkeypatch):
    """The registry's counters are the device counters alone, their slots
    and cards summed; ``reset`` keeps them and ``reset_launches`` drops
    them (CPU tensors stand in for the cards')."""
    assert registry.counters() == {}
    for dev, (slot, fast, holes) in enumerate([(1, 4, 1), (7, 2, 3)]):
        t = torch.zeros((_cuda.COUNTER_SLOTS, _cuda.COUNTER_STRIDE),
                        dtype=torch.int64)
        t[slot, :2] = torch.tensor([fast, holes])
        t[0, :2] = torch.tensor([10, 0])
        monkeypatch.setitem(_cuda._COUNTER_TENSORS, ("postprocess", dev), t)
    want = {"postprocess.fast_tiles": 26, "postprocess.hole_tiles": 4}
    assert registry.counters() == want
    registry.reset()                        # spans only
    assert registry.counters() == want
    _cuda.reset_launches()
    assert registry.counters() == {}
