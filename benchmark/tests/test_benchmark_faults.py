"""A whole run on the CPU at a test's size (the look for a card skipped),
sound and then with the timed path broken underneath: ``correct`` holds
for the sound run and comes out false for each fault the cell can have,
and for the control (the reference one precision lower) put in the
program's place. One card runs each cell, so no exchange between chips
can be left out."""

import time

import pytest
import torch

from lib.harness import run_cell

CELLS = ["dp1080-convert", "dp1080-rerender", "dp1080-preview"]


def _run(cell):
    logs = []
    r = run_cell(cell, 2**31 + 17, 0.5, False, ["cpu"], time.perf_counter(),
                 log=logs.append)
    assert logs[-1].startswith("check "), logs
    return r


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_cell, name):
    r = _run(tiny_cell(name))
    assert r["correct"] is True and r["attempted"] > 0
    assert list(r)[-1] == "check"
    names = {"depth_gap", "sbs_off_share"} if "convert" in name else \
        {"sbs_off_share"}
    assert set(r["check"]) == names


def _broken_sbs(monkeypatch, how):
    from vsc_tpu_torch.ops import stereo
    real = stereo.generate_sbs

    def broken(rgb, depth, params=None):
        out = real(rgb, depth, params)
        if how == "altered":            # an answer altered where produced
            out = out.clone()
            out[:, :, : out.shape[2] // 3] ^= 0x40
        elif how == "unchanged":        # the input returned, no stereo
            out = torch.cat([rgb, rgb], dim=2).to(torch.uint8)
        elif how == "half":             # half of the batch left out
            out = out.clone()
            out[out.shape[0] // 2:] = 0
        return out
    monkeypatch.setattr(stereo, "generate_sbs", broken)


# the tester renders one frame a request: no half of a batch to leave out
SBS_FAULTS = [(c, h) for c in CELLS for h in ("altered", "unchanged", "half")
              if (c, h) != ("dp1080-preview", "half")]


@pytest.mark.parametrize("name,how", SBS_FAULTS)
def test_broken_sbs_is_not_correct(tiny_cell, monkeypatch, name, how):
    _broken_sbs(monkeypatch, how)
    assert _run(tiny_cell(name))["correct"] is False


@pytest.mark.parametrize("how", ["altered", "half"])
def test_broken_depth_is_not_correct(tiny_cell, monkeypatch, how):
    from vsc_tpu_torch.pipeline import depth_map_generator as dmg
    real = dmg.build_depth_fn

    def build(*a, **k):
        fn = real(*a, **k)

        def broken(x):
            if how == "half":           # half of the batch left out
                n = x.shape[0] // 2
                d = fn(x[:n])
                return torch.cat([d, torch.zeros_like(d)])
            d = fn(x).clone()           # an answer altered where produced
            d[:, : d.shape[1] // 2] //= 2
            return d
        return broken
    monkeypatch.setattr(dmg, "build_depth_fn", build)
    r = _run(tiny_cell("dp1080-convert"))
    assert r["correct"] is False
    assert r["check"]["depth_gap"]["value"] > r["check"]["depth_gap"]["limit"]


def test_stale_preview_is_not_correct(tiny_cell, monkeypatch):
    """A tester that answers every request with its first frame."""
    from vsc_tpu_torch.pipeline import sbs_tester
    real, first = sbs_tester.render_params, []

    def stale(rgb, depth, params, device):
        out = real(rgb, depth, params, device)
        first.append(out)
        return first[0]
    monkeypatch.setattr(sbs_tester, "render_params", stale)
    assert _run(tiny_cell("dp1080-preview"))["correct"] is False


# the control in the program's place, one part at a time: the float8
# DepthPro (depth_gap) and the bfloat16 SBS (sbs_off_share)
CONTROLS = [("dp1080-convert", ("depth",), "depth_gap"),
            ("dp1080-convert", ("sbs",), "sbs_off_share"),
            ("dp1080-rerender", ("sbs",), "sbs_off_share"),
            ("dp1080-preview", ("sbs",), "sbs_off_share")]


@pytest.mark.parametrize("name,parts,number", CONTROLS)
def test_control_in_the_programs_place_is_not_correct(tiny_cell, name, parts,
                                                      number):
    from lib.control import plant
    remove = plant(tiny_cell(name), parts)
    try:
        r = _run(tiny_cell(name))
    finally:
        remove()
    assert r["correct"] is False
    assert r["check"][number]["value"] > r["check"][number]["limit"]
