"""The port's bench (vsc_tpu_torch/bench.py) against the JAX package's root
bench.py, on the CPU at small sizes: the content bit-equal, the port's
oracle copy bit-equal to tests/oracle.py, the stub workload's depth and SBS
against JAX's, the line's keys and the quality gate's rule as the JAX
bench's, the extras' media rule, chip_smoke's check of the line, and the
entry point's zero line and exit 1 without a card."""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import oracle as test_oracle
from vsc_tpu.config import StereoParams as JParams
from vsc_tpu_torch import bench
from vsc_tpu_torch.config import StereoParams
from vsc_tpu_torch.utils import oracle

REPO = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's SBS on these small frames is thousands of small ops: with
    torch's intra-op threads competing with the other test workers for the
    cores, each op waits on its slowest thread (40 s a call seen under
    load, 0.1 s alone); one thread keeps it at a second."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jbench():
    """The JAX package's bench.py (it imports vsc_tpu inside functions)."""
    return _load("jax_root_bench", REPO / "bench.py")


@pytest.fixture()
def stub_env(monkeypatch, tmp_path):
    monkeypatch.setenv("BENCH_DEPTH", "stub")
    monkeypatch.setenv("BENCH_BATCH", "2")
    monkeypatch.setenv("VSC_TPU_ORACLE_CACHE", str(tmp_path / "oracle"))


@pytest.mark.parametrize("h,w", [(1080, 1920), (72, 128)])
def test_bench_content_equals_jax(jbench, h, w):
    pairs = zip(bench.bench_content(h, w), jbench.bench_content(h, w))
    for got, want in pairs:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["defaults", "convergence10_ss1",
                                  "noise_depth"])
def test_port_oracle_equals_test_oracle(case):
    frame, depth = bench.bench_content(48, 80)
    kw = {}
    if case == "convergence10_ss1":
        kw = dict(convergence=10.0, super_sampling=1.0)
    if case == "noise_depth":
        depth = np.random.default_rng(7).integers(0, 256, depth.shape,
                                                  np.uint8)
    got = oracle.process_frame(frame, depth, StereoParams(**kw))
    want = test_oracle.process_frame(frame, depth, JParams(**kw))
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    assert oracle.ssim(got, want) == test_oracle.ssim(got, want) == 1.0


def test_stub_workload_matches_jax(stub_env):
    from vsc_tpu.models.stub import luminance_depth
    from vsc_tpu.ops.stereo import generate_sbs
    H, W = 72, 128
    w = bench.build_workload(height=H, width=W, device="cpu")
    assert w.batch == 2 and w.frames.shape == (2, H, W, 3)
    frames = w.frames.numpy()
    depth = w.run_depth(w.frames).numpy()
    sbs = w.run_sbs(w.frames, w.depth_sbs).numpy()

    want_depth = np.asarray(jnp.round(luminance_depth(
        jnp.asarray(frames, jnp.float32) / 127.5 - 1.0) * 255.0
    ).astype(jnp.uint8))
    assert np.std(want_depth.astype(np.float32)) > 0
    assert np.abs(depth.astype(int) - want_depth.astype(int)).max() <= 1
    want = np.asarray(generate_sbs(frames, w.depth_sbs.numpy(), JParams()))
    assert sbs.shape == want.shape == (2, H, 2 * W, 3)
    for i in range(2):
        for eye in (slice(0, W), slice(W, 2 * W)):
            s = test_oracle.ssim(sbs[i, :, eye], want[i, :, eye])
            assert s >= 0.99, (i, eye, s)


def _jax_line(jbench, monkeypatch, capsys, ssim_error=False):
    """The JAX bench's main() on the CPU with a tiny stand-in workload,
    SSIM on and extras off; its printed line."""
    monkeypatch.setenv("BENCH_DEPTH", "stub")
    monkeypatch.setenv("BENCH_ITERS", "2")
    monkeypatch.setenv("BENCH_EXTRAS", "0")
    monkeypatch.setenv("BENCH_SSIM", "1")
    frames = jnp.zeros((2, 8, 8, 3), jnp.uint8)
    run_depth = jax.jit(lambda f: f[..., 0])
    run_sbs = jax.jit(lambda f, d: jnp.concatenate([f, f], axis=2))
    monkeypatch.setattr(jbench, "_wait_for_device", lambda *a: {})
    monkeypatch.setattr(jbench, "build_workload", lambda: (
        frames, frames[..., 0], run_depth, run_sbs, 2))

    def ssim(*a):
        if ssim_error:
            raise RuntimeError("oracle broke")
        return 0.995
    monkeypatch.setattr(jbench, "measure_ssim", ssim)
    monkeypatch.setattr(jbench, "measure_ssim_extra", lambda f: {
        "ssim_noise_depth": 0.995, "ssim_alt_params": 0.995})
    capsys.readouterr()
    jbench.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jax_extras_keys():
    """The keys bench.py's measure_extras and measure_ssim_extra write,
    read from its source (they need 1080p clips to run)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    keys = set()
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in (
                "measure_extras", "measure_ssim_extra"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if (isinstance(t, ast.Subscript)
                                and isinstance(t.value, ast.Name)
                                and t.value.id in ("extras", "out")
                                and isinstance(t.slice, ast.Constant)):
                            keys.add(t.slice.value)
    return keys - {"extras_error"}


def test_line_keys_equal_jax(jbench, monkeypatch, capsys, stub_env):
    import inspect

    from vsc_tpu_torch.config import load_config
    from vsc_tpu_torch.pipeline import stream_convert
    jline = _jax_line(jbench, monkeypatch, capsys)
    assert jline["detail"]["quality_gate"] == "PASS"

    # the streaming CLI's run (48 SBS frames, minutes on a loaded CPU) is
    # tests/test_torch_slice.py's; here its call is checked and answered
    calls = []

    def fake_run(*args, **kwargs):
        bound = inspect.signature(real_run).bind(*args, **kwargs)
        calls.append(bound.arguments)
        wf, cfg = bound.arguments["workflow_path"], bound.arguments["config"]
        assert load_config(wf)["encoding"]["preset"] == "ultrafast"
        assert cfg["encoding"]["preset"] == "ultrafast"
        return True
    real_run = stream_convert.run
    monkeypatch.setattr(stream_convert, "run", fake_run)
    w = bench.build_workload(height=48, width=64, device="cpu")
    line = bench.measure(w, 2, depth_model="stub")
    from vsc_tpu_torch.native import vscmedia_path
    if vscmedia_path() is not None:
        assert [(c["model_name"], c["concat"], c["batch_size"], c["device"])
                for c in calls] == [("stub", False, 2, w.frames.device)] * 2
        assert line["detail"]["decoded_video"]["fps"] > 0
    assert set(line) == set(jline)
    extras = _jax_extras_keys()
    assert extras >= {"sbs_roofline_ms", "sbs_roofline_attained_pct",
                      *bench.MEDIA_KEYS}
    assert set(line["detail"]) == set(jline["detail"]) | extras
    d = line["detail"]
    assert "ssim_error" not in d and "extras_error" not in d
    assert d["device"] == "cpu" and d["depth_mfu_pct"] is None
    assert line["value"] > 0 and isinstance(d["ssim_alt_params"], float)
    # SSIM and extras off: exactly the JAX line's fixed keys
    bare = bench.measure(w, 2, ssim=False, extras=False, depth_model="stub")
    assert set(bare["detail"]) == set(jline["detail"]) - {
        "ssim_vs_oracle", "ssim_noise_depth", "ssim_alt_params"}
    assert bare["detail"]["quality_gate"] == "SKIPPED"
    assert bare["vs_baseline"] == 0.0


def test_gate_fails_on_ssim_error(jbench, monkeypatch, capsys):
    jline = _jax_line(jbench, monkeypatch, capsys, ssim_error=True)
    assert jline["detail"]["quality_gate"] == "FAIL"
    assert jline["vs_baseline"] == 0.0
    ok = {"ssim_vs_oracle": 0.999, "ssim_noise_depth": 0.995}
    assert bench.quality_gate(ok, True) == "PASS"
    assert bench.quality_gate({**ok, "ssim_error": "oracle broke"},
                              True) == "FAIL"
    assert bench.quality_gate({**ok, "ssim_alt_params": 0.98}, True) == "FAIL"
    assert bench.quality_gate({}, True) == "FAIL"
    assert bench.quality_gate(ok, False) == "SKIPPED"


def test_extras_without_media_engine(monkeypatch, stub_env):
    import vsc_tpu_torch.native as native
    monkeypatch.setattr(native, "vscmedia_path", lambda *a, **k: None)
    w = bench.build_workload(height=48, width=64, device="cpu")
    out = bench.measure_extras(w.frames, w.run_depth, w.run_sbs, w.batch, 2,
                               lambda: None, 0.001, 0.05)
    assert {k: out[k] for k in bench.MEDIA_KEYS} == {
        k: bench.NO_MEDIA for k in bench.MEDIA_KEYS}
    assert "extras_error" not in out
    assert out["sbs_worstcase_noise_depth_ms_per_frame"] > 0
    from vsc_tpu_torch.utils.flops import sbs_least_time
    sol = sbs_least_time(48, 64)["ms"]
    assert out["sbs_roofline_ms"] == round(sol, 3)
    assert out["sbs_roofline_attained_pct"] == round(100.0 * sol / 50.0, 1)


def test_full_depth_is_the_depth_steps_function(monkeypatch, stub_env):
    """BENCH_DEPTH=full times the depth step's own build_depth_fn on the
    head-off production DepthPro (seed 0); an unknown model (the JAX
    bench's flagship among them) is refused."""
    from vsc_tpu_torch.models import DepthProConfig
    from vsc_tpu_torch.pipeline import depth_map_generator
    calls = []

    def fake(*args, **kwargs):
        calls.append((args, kwargs))
        return "depth_fn"
    monkeypatch.setattr(depth_map_generator, "build_depth_fn", fake)
    monkeypatch.setenv("BENCH_DEPTH", "full")
    w = bench.build_workload(height=48, width=64, device="cpu")
    assert w.run_depth == "depth_fn"
    cfg = DepthProConfig(use_fov_head=False)
    assert calls == [(("depthpro", 1536, 48, 64, False),
                      {"device": w.frames.device, "model_cfg": cfg,
                       "seed": 0})]
    for kind in ("flagship", "depthpro"):
        monkeypatch.setenv("BENCH_DEPTH", kind)
        with pytest.raises(ValueError, match="full or stub"):
            bench.build_workload(height=48, width=64, device="cpu")


def test_ssim_refuses_a_batch_whose_frames_differ(monkeypatch, stub_env):
    """The timed batch holds copies of one frame: its SBS frames must all
    equal the first, whose SSIM stands for them, or the gate fails."""
    import torch
    w = bench.build_workload(height=48, width=64, device="cpu")
    sbs = w.run_sbs(w.frames, w.depth_sbs)
    assert torch.equal(sbs[1], sbs[0])
    assert bench.measure_ssim(w.frames, w.depth_sbs, sbs) >= 0.99
    bad = sbs.clone()
    bad[1, 5, 7, 2] ^= 1
    with pytest.raises(RuntimeError, match=r"frames \[1\]"):
        bench.measure_ssim(w.frames, w.depth_sbs, bad)
    line = bench.measure(w._replace(run_sbs=lambda f, d: bad), 1,
                         extras=False, depth_model="stub")
    assert "frames [1]" in line["detail"]["ssim_error"]
    assert line["detail"]["quality_gate"] == "FAIL"
    assert line["vs_baseline"] == 0.0


def test_chip_smoke_checks_the_bench_line():
    smoke = _load("chip_smoke_for_bench", REPO / "chip_smoke.py")
    ssims = {"ssim_vs_oracle": 0.998, "ssim_noise_depth": 0.996,
             "ssim_alt_params": 0.997}
    good = {"value": 9.5, "detail": {
        "quality_gate": "PASS", "depth_mfu_pct": 36.1,
        "sbs_roofline_ms": 0.669, "sbs_roofline_attained_pct": 19.1,
        "sbs_worstcase_noise_depth_ms_per_frame": 9.0, **ssims,
        **{k: bench.NO_MEDIA for k in bench.MEDIA_KEYS}}}
    smoke.check_bench_line(good, media=False)
    with pytest.raises(RuntimeError, match="media"):
        smoke.check_bench_line(good, media=True)

    def bad(**detail):
        return {**good, "detail": {**good["detail"], **detail}}
    for line in (bad(quality_gate="FAIL"), bad(ssim_alt_params=0.98),
                 bad(ssim_error="x"), bad(extras_error="x"),
                 bad(depth_mfu_pct=120.0), bad(depth_mfu_pct=None),
                 bad(sbs_roofline_attained_pct=0.0),
                 {**good, "value": 0.0}):
        with pytest.raises(RuntimeError, match="check failed"):
            smoke.check_bench_line(line, media=False)
    stub = {**good, "detail": {k: v for k, v in good["detail"].items()
                               if k.startswith("ssim_")
                               or k == "quality_gate"}}
    stub["detail"]["depth_mfu_pct"] = None
    smoke.check_bench_line(stub, media=False, extras=False, full=False)

    from vsc_tpu_torch.ops import _cuda
    launches = {k: 0 for k in _cuda.LAUNCHES}
    launches.update({k: 8 for k in smoke.SBS_STEP_KERNELS}, upsample=16)
    smoke.check_bench_launches(launches, 8, full=False)
    depth = {"attention": 384, "residual_norm": 768}
    smoke.check_bench_launches({**launches, **depth}, 8, full=True)
    for bad_counts, full in (({**launches, "attention": 384}, False),
                             ({**launches, "residual_norm": 768}, False),
                             ({**launches, "attention": 384}, True),
                             (launches, True),
                             ({**launches, "pyramid": 0}, False),
                             ({**launches, "finish": 12}, False),
                             ({**launches, "bilateral": 8}, False)):
        with pytest.raises(RuntimeError, match="check failed"):
            smoke.check_bench_launches(bad_counts, 8, full=full)


def test_bench_without_a_card_exits_1_with_the_zero_line():
    # the card hidden, as on a machine without one
    proc = subprocess.run([sys.executable, "-m", "vsc_tpu_torch.bench"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line == bench.zero_line(line["detail"]["error"])
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert "no CUDA device" in line["detail"]["error"]
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
