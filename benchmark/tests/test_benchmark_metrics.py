"""The metric arithmetic on hand-made records, and the trace helpers."""

import math

import pytest

from frozen import flops
from lib import trace
from lib.spec import load_benchmark, load_reader, resolve
from reference.depthpro import DepthProCfg

CFG = resolve(load_benchmark(), "dp1080-convert").config
PARAMS = {k: float(v) for k, v in CFG["stereo"].items()}


def _rec(**kw):
    enc = CFG["model"]["encoder"]
    dev = kw.pop("device", [])
    rec = {"config": CFG, "H": 1080, "W": 1920, "batch": 8,
           "params": PARAMS, "units_free": 80, "host_s_free": 5.0,
           "depth_ms_free": 4000.0, "sbs_ms_free": 400.0,
           "sbs_calls_free": 10, "units_traced": 24,
           "trace": {"device": dev, "host": [], "window": (0.0, 1e6),
                     "steps": 3},
           "flops": flops, "trace_lib": trace,
           "flops_per_frame": flops.depthpro_flops(DepthProCfg(), 1)}
    rec.update(kw)
    assert enc["depth"] == 24
    return rec


def test_depth_and_sbs_ms_per_frame():
    r = _rec()
    assert load_reader("depth_ms_per_frame")(r) == pytest.approx(50.0)
    assert load_reader("sbs_ms_per_frame")(r) == pytest.approx(5.0)
    assert load_reader("sbs_ms.preview")(r) == pytest.approx(40.0)


def test_mfu_shares():
    r = _rec()
    f = r["flops_per_frame"]
    assert f == pytest.approx(18.86e12, rel=2e-3)
    want = 100 * f * 80 / (4.0 * 989e12)
    assert load_reader("depth_mfu_pct")(r) == pytest.approx(want)
    assert load_reader("convert_mfu_pct")(r) == pytest.approx(
        100 * f * 80 / (5.0 * 989e12))


def test_sbs_roofline_from_the_frozen_bound():
    r = _rec()
    bound = flops.sbs_least_time(1080, 1920, PARAMS)["ms"]
    assert load_reader("sbs_roofline_pct")(r) == pytest.approx(
        100 * bound * 80 / 400.0)


def test_attention_roofline_counts_the_models_launches():
    ker = "void (anonymous namespace)::qkv_attention_kernel<64>(...)"
    dev = [(i * 10.0, i * 10.0 + 2000.0, ker) for i in range(48 * 3)]
    r = _rec(device=dev)
    b = 24 * (flops.qkv_attention_bound(35 * 8, 577, 1024, 16)["bound_ms"]
              + flops.qkv_attention_bound(8, 577, 1024, 16)["bound_ms"])
    got = load_reader("attention_roofline_pct")(r)
    assert got == pytest.approx(100 * b * 3 / (48 * 3 * 2.0))
    assert load_reader("attention_roofline_pct")(_rec(device=dev[:-1])) \
        is None
    assert load_reader("attention_roofline_pct")(_rec()) is None


def test_kernels_copies_and_idle():
    dev = [(0.0, 100.0, "void warp_kernel<U8>(...)"),
           (50.0, 300.0, "Memcpy HtoD (Pinned -> Device)"),
           (400.0, 500.0, "Memcpy DtoH (Device -> Pageable)"),
           (600.0, 700.0, "void sharpen_downscale_kernel(...)")]
    r = _rec(device=dev, units_traced=2,
             trace={"device": dev, "host": [], "window": (0.0, 1000.0),
                    "steps": 1})
    assert load_reader("copy_ms_per_frame")(r) == pytest.approx(
        (250 + 100) / 1e3 / 2)
    assert load_reader("device_idle_pct")(r) == pytest.approx(50.0)
    assert load_reader("device_idle_pct.preview")(r) == pytest.approx(50.0)
    st = flops.sbs_least_time(1080, 1920, PARAMS)["stages"]
    per = sum(v["ms"] for k, v in st.items() if k in flops.SBS_KERNEL_STAGES)
    assert load_reader("sbs_kernels_roofline_pct")(r) == pytest.approx(
        100 * per * 2 / 0.2)


@pytest.mark.parametrize("name", [m["name"] for m in
                                  load_benchmark()["per_layer"]])
def test_readers_give_nothing_on_an_empty_record(name):
    r = _rec(units_free=0, host_s_free=0.0, depth_ms_free=0.0,
             sbs_ms_free=0.0, sbs_calls_free=0, units_traced=0)
    r["trace"] = {"device": [], "host": [], "window": None, "steps": 0}
    r.pop("flops_per_frame")
    assert load_reader(name)(r) is None


def test_busy_groups_and_gaps():
    dev = [(0.0, 10.0, "a gemm"), (5.0, 20.0, "elementwise_kernel"),
           (40.0, 50.0, "Memcpy DtoH")]
    assert trace.busy_us(dev) == 30.0
    g = trace.by_group(dev)
    assert g["GEMMs (cuBLAS)"] == 10.0 and g["copy device to host"] == 10.0
    host = [(0.0, 100.0, "outer"), (21.0, 39.0, "cudaStreamSynchronize")]
    gaps = dict(trace.idle_gaps(dev, host, (0.0, 60.0)))
    assert gaps == {"cudaStreamSynchronize": 20.0, "outer": 10.0}
    assert math.isclose(sum(gaps.values()), 60.0 - 30.0)


def test_frozen_counts_equal_the_programs():
    from vsc_tpu_torch.config.stereo_params import StereoParams
    from vsc_tpu_torch.models import DepthProConfig, ViTConfig
    from vsc_tpu_torch.utils import flops as program
    for S in (1536, 2048):
        pc = DepthProConfig(img_size=S, tile_size=S // 4,
                            encoder=ViTConfig(img_size=S // 4),
                            use_fov_head=False)
        rc = DepthProCfg(img_size=S, tile_size=S // 4)
        rc = type(rc)(img_size=S, tile_size=S // 4,
                      encoder=type(rc.encoder)(img_size=S // 4))
        assert flops.depthpro_flops(rc, 3) == program.depthpro_flops(pc, 3)
    for H, W in ((1080, 1920), (2160, 3840), (720, 1280)):
        for p in (StereoParams(), StereoParams(max_disparity=80,
                                               convergence=23,
                                               edge_softness=0)):
            q = {k: float(v) for k, v in p.to_dict().items()}
            got = flops.sbs_least_time(H, W, q)
            want = program.sbs_least_time(H, W, p)
            assert got["ms"] == pytest.approx(want["ms"], rel=1e-12)
            assert got["stages"].keys() == want["stages"].keys()
    assert flops.PEAK_OPS_S == program.PEAK_OPS_S
    assert flops.HBM_BYTES_S == program.HBM_BYTES_S
