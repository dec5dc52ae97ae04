"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests marked ``card`` need an NVIDIA card and skip without one (the
``card`` fixture decides, at run time)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


TINY_MODEL = {"img_size": 64, "tile_size": 16,
              "encoder": {"img_size": 16, "patch_size": 2, "embed_dim": 32,
                          "depth": 4, "num_heads": 2, "mlp_ratio": 4.0,
                          "layerscale_init": 1e-5},
              "hook_block_ids": [0, 2], "decoder_features": 16,
              "dims_encoder": [16, 24, 32, 32], "use_fov_head": False}


# cells whose entry and mix the benchmark keeps, but BENCHMARK.json does
# not run yet (PERF.md, Open questions): the tests drive them all the same
KEPT_OUT = [{"name": "dp1080-preview", "config": "depthpro-1080p",
             "traffic": "preview", "chips": 1,
             "why": "one tester user, closed loop, batch 1"}]


@pytest.fixture
def tiny_cell(tmp_path, monkeypatch):
    """A cell of BENCHMARK.json (or of KEPT_OUT) at DepthProConfig.tiny()'s
    widths, 32 x 64 frames, batch 2, its weight file under tmp_path."""
    import copy

    import torch
    from lib import weights
    from lib.spec import load_benchmark, resolve
    torch.set_num_threads(2)
    monkeypatch.setattr(weights, "CACHE", tmp_path / "cache")

    def make(name):
        bench = load_benchmark()
        have = {w["name"] for w in bench["workloads"]}
        bench["workloads"] += [w for w in KEPT_OUT if w["name"] not in have]
        cell = resolve(bench, name)
        cell.config = copy.deepcopy(cell.config)
        cell.config.update(model=TINY_MODEL, batch=2,
                           frame={"height": 32, "width": 64})
        if cell.mix["entry"] == "render_params":
            cell.mix = dict(cell.mix, schedule=40, check={"sample": 3})
        return cell
    return make
