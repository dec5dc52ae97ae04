"""The port's filesystem metrics (vsc_tpu_torch/runtime/workflow_metrics.py)
against the JAX package's on the same directory trees: the cases of
tests/test_workflow_metrics.py (counts and maxima, the chunk-info .tmp
cleanup, the next-chunk policy table, the is_all_chunks_complete fallback
chain, the progress string), the policy table also at the CHUNK_SIZE
boundaries, and the progress string of a workflow whose input video probes
and of a finished one. Every value must be equal."""

import pytest

import vsc_tpu.config as jconfig
import vsc_tpu.runtime.workflow_metrics as jm
import vsc_tpu_torch.config as tconfig
import vsc_tpu_torch.runtime.workflow_metrics as tm


@pytest.fixture()
def wf(tmp_path):
    for sub in ("frames", "depth_maps", "sbs", "chunks"):
        (tmp_path / sub).mkdir()
    tconfig.save_config(tmp_path, tconfig.create_default_config(
        tmp_path / "in.mkv"))
    _fresh()
    return tmp_path


def _fresh():
    jm.invalidate_cache()
    tm.invalidate_cache()


def both(fn_name, *args):
    """fn_name of both packages on the same arguments (caches cleared
    first); the values must be equal. Returns the port's."""
    _fresh()
    want = getattr(jm, fn_name)(*args)
    _fresh()
    got = getattr(tm, fn_name)(*args)
    assert got == want, (fn_name, got, want)
    return got


def _touch(wf_path, sub, fmt, upto, start=1):
    for i in range(start, upto + 1):
        (wf_path / sub / fmt.format(i)).touch()


def test_constants_match_jax():
    for name in ("CHUNK_SIZE", "MIN_DEPTH_FOR_SBS", "DISK_SPACE_THRESHOLD_GB"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert (tm.CHUNK_SIZE, tm.MIN_DEPTH_FOR_SBS,
            tm.DISK_SPACE_THRESHOLD_GB) == (1500, 1000, 10)


def test_counts_and_maxes(wf):
    names = ("get_frame_count", "get_depth_count", "get_max_depth_number",
             "get_max_sbs_number", "get_last_chunk_end_frame")
    assert [both(n, wf) for n in names] == [0, 0, 0, 0, 0]
    _touch(wf, "frames", "frame_{:06d}.png", 7)
    (wf / "depth_maps" / "depth_frame_000003.png").touch()
    (wf / "depth_maps" / "depth_frame_000009.tif").touch()
    (wf / "depth_maps" / "notes.txt").touch()
    _touch(wf, "sbs", "sbs_{:06d}.png", 5)
    (wf / "chunks" / "sbs_000001_000004.mkv").touch()
    (wf / "chunks" / "sbs_000004_000005.mkv").touch()
    (wf / "chunks" / "sbs_x.mkv").touch()
    assert [both(n, wf) for n in names] == [7, 2, 9, 5, 5]
    # a workflow without a readable config reads as empty
    (wf / "config.json").write_text("{not json")
    assert [both(n, wf) for n in names] == [0, 0, 0, 0, 0]


def test_chunk_info_cleans_tmp(wf):
    results = []
    for m in (jm, tm):
        (wf / "chunks" / "sbs_000001_001500.mkv").touch()
        (wf / "chunks" / "sbs_001500_002000.mkv.tmp").touch()
        _fresh()
        results.append(m.get_last_chunk_end_frame(wf))
        assert not (wf / "chunks" / "sbs_001500_002000.mkv.tmp").exists()
    assert results == [1500, 1500]


# the JAX test's table, then the CHUNK_SIZE boundaries
POLICY = [
    (1000, 0, False, None), (3100, 0, False, 1500), (2900, 0, False, 2900),
    (1600, 0, False, 1600), (4700, 1500, False, 3000), (700, 0, True, 700),
    (1502, 1500, True, 1502), (1501, 1500, True, None),
    (5000, 0, True, 1500),
    (1499, 0, False, None), (1499, 0, True, 1499),
    (1500, 0, False, None), (1500, 0, True, 1500),
    (1501, 0, False, 1501), (1501, 0, True, 1501),
    (3000, 0, False, 3000), (3000, 0, True, 3000),
    (3001, 0, False, 1500), (3001, 0, True, 1500),
    (3000, 1500, False, None), (3000, 1500, True, 3000),
    (3001, 1500, False, 3001), (3001, 1500, True, 3001),
]


@pytest.mark.parametrize("max_sbs,last_end,sbs_complete,expected", POLICY)
def test_next_chunk_policy(wf, max_sbs, last_end, sbs_complete, expected):
    _touch(wf, "sbs", "sbs_{:06d}.png", max_sbs)
    assert both("get_next_chunk_end_frame", wf, last_end,
                sbs_complete) == expected


def test_all_chunks_complete_fallback_chain(wf):
    assert not both("is_all_chunks_complete", wf)
    (wf / "chunks" / "sbs_000001_000036.mkv").touch()
    # no sbs / depth / total frame information: not complete
    assert not both("is_all_chunks_complete", wf)
    _touch(wf, "sbs", "sbs_{:06d}.png", 40)
    assert not both("is_all_chunks_complete", wf)      # 36 < 40
    for f in (wf / "sbs").glob("sbs_00003[7-9].png"):
        f.unlink()
    (wf / "sbs" / "sbs_000040.png").unlink()
    assert both("is_all_chunks_complete", wf)
    # SBS deleted (free-space mode): falls back to depth maps
    for f in (wf / "sbs").glob("*.png"):
        f.unlink()
    (wf / "depth_maps" / "depth_frame_000036.png").touch()
    assert both("is_all_chunks_complete", wf)
    (wf / "depth_maps" / "depth_frame_000037.tif").touch()
    assert not both("is_all_chunks_complete", wf)


def test_all_chunks_complete_falls_back_to_total_frames(tmp_path,
                                                        test_video):
    # no SBS and no depth maps left: the input video's frame count decides
    for sub in ("frames", "depth_maps", "sbs", "chunks"):
        (tmp_path / sub).mkdir()
    tconfig.save_config(tmp_path, tconfig.create_default_config(test_video))
    total = both("get_total_frame_count", tmp_path)
    assert total == 36
    (tmp_path / "chunks" / "sbs_000001_000035.mkv").touch()
    assert not both("is_all_chunks_complete", tmp_path)
    (tmp_path / "chunks" / "sbs_000035_000036.mkv").touch()
    assert both("is_all_chunks_complete", tmp_path)


def test_video_progress_string(wf, tmp_path_factory, test_video):
    assert both("get_video_progress", wf) == "-"
    (wf / "chunks" / "sbs_000001_000020.mkv").touch()
    # no probe-able input video: falls back to the raw chunk end
    assert both("get_video_progress", wf) == "20"
    # a probe-able input: X/Y
    wf2 = tmp_path_factory.mktemp("wf2")
    (wf2 / "chunks").mkdir()
    config = jconfig.create_default_config(test_video)
    jconfig.save_config(wf2, config)
    (wf2 / "chunks" / "sbs_000001_000020.mkv").touch()
    assert both("get_video_progress", wf2) == "20/36"
    (wf2 / "chunks" / "sbs_000020_000040.mkv").touch()
    assert both("get_video_progress", wf2) == "36/36"
    out = jconfig.get_path(wf2, config, "output_video")
    out.write_bytes(b"x")
    try:
        assert both("get_video_progress", wf2) == "DONE"
    finally:
        out.unlink()
