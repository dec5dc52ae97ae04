"""The port's data mesh (vsc_tpu_torch/parallel/{mesh,auto,distributed,
dryrun}.py and the SPMD form of ops/stereo.generate_sbs) against the JAX
package's on its 8 virtual CPU devices (tests/conftest.py): mesh shapes
and errors, batch placement, the data-parallel SBS at the two parameter
sets of tests/test_parallel.py (compat, planar-u8) on meshes (8, 1) and
(4, 2), and multi-host start-up (tests/test_torch_parallel_steps.py holds
the dry run and the step CLIs on a mesh). The port's meshes name the CPU
several times (``devices=[cpu] * n``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import oracle
from vsc_tpu.parallel import data_sharding as jax_data_sharding
from vsc_tpu.parallel import make_mesh as jax_mesh
from vsc_tpu.parallel.auto import pad_to_multiple as jax_pad
from vsc_tpu_torch.parallel import auto, data_sharding, make_mesh
from vsc_tpu_torch.parallel.mesh import Sharded

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- mesh and placement (tests/test_parallel.py:12-38) ---------------------

@pytest.mark.parametrize("data, model", [(None, 1), (2, 4), (8, 1), (4, 2),
                                         (None, 2), (3, 2)])
def test_make_mesh_shapes_equal_jax(data, model):
    want = jax_mesh(data=data, model=model)
    got = make_mesh(data=data, model=model, devices=CPU8)
    assert got.axis_names == want.axis_names == ("data", "model")
    assert got.devices.shape == want.devices.shape
    assert got.devices.size == want.devices.size
    assert got.shape == dict(want.shape)


@pytest.mark.parametrize("data, model", [(5, 3), (None, 3), (9, 1)])
def test_make_mesh_errors_equal_jax(data, model):
    with pytest.raises(ValueError) as want:
        jax_mesh(data=data, model=model)
    with pytest.raises(ValueError) as got:
        make_mesh(data=data, model=model, devices=CPU8)
    assert str(got.value) == str(want.value)


def test_default_mesh_is_one_cpu_device_here():
    mesh = make_mesh()
    assert mesh.devices.size == 1 and mesh.devices[0, 0].type == "cpu"
    assert auto._data_mesh() is None
    assert auto.device_count() == auto.device_count("cpu") == 1


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_shard_batch_shards_equal_jax(shape):
    x = np.arange(16 * 4 * 4, dtype=np.float32).reshape(16, 4, 4)
    want = jax.device_put(x, jax_data_sharding(jax_mesh(*shape), x.ndim))
    mesh = make_mesh(*shape, devices=CPU8)
    assert data_sharding(mesh, 3).spec == tuple(P("data", None, None))
    got = auto.shard_batch(x, "cpu", mesh)
    assert isinstance(got, Sharded) and got.mesh == mesh
    assert len(got.parts) == shape[0]
    for s in want.addressable_shards:
        part = got.parts[s.index[0].start // (16 // shape[0])]
        np.testing.assert_array_equal(part.numpy(), np.asarray(s.data))
    np.testing.assert_array_equal(auto.gather(got).numpy(), x)


def test_shard_batch_one_device_is_a_plain_tensor():
    x = np.zeros((8, 3), np.float32)
    t = auto.shard_batch(x, "cpu")
    assert type(t) is torch.Tensor and t.shape == (8, 3)
    assert t.data_ptr() == x.ctypes.data          # no copy on the CPU
    # a mesh with one data row: a tensor on its device
    t = auto.shard_batch(x, "cpu", make_mesh(1, 2, devices=CPU8))
    assert type(t) is torch.Tensor
    with pytest.raises(ValueError, match="does not split"):
        auto.shard_batch(np.zeros((6, 3)), "cpu", make_mesh(4, 1,
                                                             devices=CPU8))


@pytest.mark.parametrize("n, m", [(10, 8), (16, 8), (1, 1), (0, 4), (5, 2)])
def test_pad_to_multiple(n, m):
    assert auto.pad_to_multiple(n, m) == jax_pad(n, m)


# --- data-parallel SBS (tests/test_parallel.py:43 and :126) ----------------

def _sets():
    from vsc_tpu.config import StereoParams
    return {
        # tests/test_parallel.py:43: super_sampling 1, the compat branch
        "compat": ((8, 16, 32), 0, StereoParams(
            max_disparity=3.0, convergence=0.0, super_sampling=1.0,
            edge_softness=1.0, artifact_smoothing=0.0, depth_gamma=1.0,
            sharpen=0.0)),
        # tests/test_parallel.py:126: super_sampling 3, planar-u8
        "planar-u8": ((8, 16, 64), 3, StereoParams(
            max_disparity=3.0, convergence=2.0, super_sampling=3.0,
            edge_softness=1.0, artifact_smoothing=1.0, depth_gamma=0.8,
            sharpen=1.0)),
    }


def _jax_sharded_sbs(monkeypatch, rgb, depth, params, shape):
    """JAX's generate_sbs on its Pallas kernels in interpret mode (the TPU
    structure the port takes on every device, as
    tests/test_torch_planar_sbs.py sets it), sharded over a JAX mesh:
    its shard_map form."""
    from vsc_tpu.ops import stereo
    for knob in ("VSC_TPU_BLUR", "VSC_TPU_WARP", "VSC_TPU_POSTPROCESS"):
        monkeypatch.setenv(knob, "pallas")
    monkeypatch.setenv("VSC_TPU_SBS", "planar")
    mesh = jax_mesh(*shape)
    rgb_s = jax.device_put(jnp.asarray(rgb),
                           NamedSharding(mesh, P("data", None, None, None)))
    depth_s = jax.device_put(jnp.asarray(depth),
                             NamedSharding(mesh, P("data", None, None)))
    assert stereo._data_mesh_of(rgb_s, depth_s) is mesh
    stereo._generate_sbs_sharded.clear_cache()
    try:
        return np.asarray(stereo.generate_sbs(rgb_s, depth_s, params))
    finally:
        stereo._generate_sbs_sharded.clear_cache()


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("which", ["compat", "planar-u8"])
def test_sharded_sbs_equals_unsharded_and_jax(monkeypatch, which, shape):
    """The port's sharded SBS equals its unsharded SBS bit for bit, and
    JAX's sharded SBS under tests/test_torch_planar_sbs.py's thresholds
    (mean diff < 0.05, > 1 code on < 0.5 %, max <= 16, per-eye SSIM >=
    0.99)."""
    from vsc_tpu_torch.config import StereoParams as TParams
    from vsc_tpu_torch.ops import stereo as tst
    (B, H, W), seed, params = _sets()[which]
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (B, H, W, 3), np.uint8)
    depth = rng.integers(0, 256, (B, H, W), np.uint8)
    tparams = TParams(**{k: getattr(params, k) for k in (
        "max_disparity", "convergence", "super_sampling", "edge_softness",
        "artifact_smoothing", "depth_gamma", "sharpen")})
    mesh = make_mesh(*shape, devices=CPU8)
    rgb_s = auto.shard_batch(rgb, "cpu", mesh)
    depth_s = auto.shard_batch(depth, "cpu", mesh)
    assert tst._data_mesh_of(rgb_s, depth_s) == mesh
    sharded = tst.generate_sbs(rgb_s, depth_s, tparams)
    assert isinstance(sharded, Sharded) and len(sharded.parts) == shape[0]
    got = auto.gather(sharded).numpy()
    single = tst.generate_sbs(torch.from_numpy(rgb), torch.from_numpy(depth),
                              tparams).numpy()
    np.testing.assert_array_equal(got, single)

    want = _jax_sharded_sbs(monkeypatch, rgb, depth, params, shape)
    assert got.shape == want.shape == (B, H, 2 * W, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert float(diff.mean()) < 0.05, diff.mean()
    assert float((diff > 1).mean()) < 0.005, (diff > 1).mean()
    assert int(diff.max()) <= 16, diff.max()
    for i in range(B):
        for eye in (slice(0, W), slice(W, 2 * W)):
            s = oracle.ssim(got[i, :, eye], want[i, :, eye])
            assert s >= 0.99, (i, eye, s)


def test_sbs_mesh_rule():
    """_data_mesh_of takes JAX's rule; a sharded input that breaks it
    raises instead of running unsharded."""
    from vsc_tpu_torch.ops import stereo as tst
    rgb = np.zeros((4, 8, 16, 3), np.uint8)
    depth = np.zeros((4, 8, 16), np.uint8)
    m4, m2 = (make_mesh(n, 1, devices=CPU8) for n in (4, 2))
    assert tst._data_mesh_of(auto.shard_batch(rgb, "cpu", m4),
                             auto.shard_batch(depth, "cpu", m4)) == m4
    assert tst._data_mesh_of(auto.shard_batch(rgb, "cpu", m4),
                             torch.from_numpy(depth)) is None
    mixed = (auto.shard_batch(rgb, "cpu", m4),
             auto.shard_batch(depth, "cpu", m2))
    assert tst._data_mesh_of(*mixed) is None
    with pytest.raises(ValueError, match="one data mesh"):
        tst.generate_sbs(*mixed)


# --- multi-host start-up (tests/test_parallel.py:101) ----------------------

def test_distributed_initialize(monkeypatch):
    """No-op without a coordinator or torchrun's environment; explicit
    arguments reach init_process_group (stubbed); idempotent; the
    environment form reads MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK."""
    import torch.distributed as tdist
    import vsc_tpu_torch.parallel.distributed as dist

    monkeypatch.setattr(dist, "_initialized", False)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert dist.initialize() is False
    assert dist.is_multi_host() is False

    calls = []
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda **kw: calls.append(kw))
    with pytest.raises(ValueError, match="num_processes"):
        dist.initialize(coordinator="host0:1234")
    assert dist.initialize(coordinator="host0:1234", num_processes=4,
                           process_id=2) is True
    assert calls == [{"backend": "gloo", "init_method": "tcp://host0:1234",
                      "world_size": 4, "rank": 2}]
    assert dist.initialize() is True          # idempotent
    assert len(calls) == 1

    monkeypatch.setattr(dist, "_initialized", False)
    monkeypatch.setenv("MASTER_ADDR", "node0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert dist.initialize() is False         # one process: no group
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert dist.initialize() is True
    assert calls[-1] == {"backend": "gloo", "init_method": "tcp://node0:29511",
                         "world_size": 2, "rank": 1}
