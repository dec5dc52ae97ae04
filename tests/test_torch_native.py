"""The port's media engine loader (vsc_tpu_torch/native): only a vscmedia
binary that starts is returned. A file at the binary's path that cannot
start (the dynamic loader's exit 127, or no executable at all) is rebuilt
once; when the rebuild fails too, ``vscmedia_path()`` returns None and the
media layer takes its cv2 paths. The module's paths are patched to a
temporary directory: the real binary is never touched."""

import stat

import pytest

from vsc_tpu_torch import native


@pytest.fixture()
def fake_binary(tmp_path, monkeypatch):
    """The loader pointed at tmp_path, which has no Makefile: a rebuild
    fails at once."""
    binary = tmp_path / "vscmedia"
    monkeypatch.setattr(native, "_NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "_BINARY", binary)
    monkeypatch.setattr(native, "_VERDICT", {})
    return binary


def _script(path, body):
    path.write_text(f"#!/bin/sh\n{body}\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)


@pytest.mark.parametrize("body", [
    "echo 'error while loading shared libraries: libavformat.so' >&2; "
    "exit 127",
    None,                                   # a file that is no executable
])
def test_a_binary_that_cannot_start_is_not_returned(fake_binary, body):
    if body is None:
        fake_binary.write_bytes(b"\x7fELF not really")
    else:
        _script(fake_binary, body)
    assert native.vscmedia_path() is None
    # no rebuild was left behind, and the verdict holds for the process
    assert sorted(p.name for p in fake_binary.parent.iterdir()) == [
        "vscmedia"]
    _script(fake_binary, "exit 1")
    assert native.vscmedia_path() is None


def test_a_binary_that_starts_is_returned_once_decided(fake_binary):
    _script(fake_binary, "echo 'usage: vscmedia ...' >&2; exit 1")
    assert native.vscmedia_path() == fake_binary
    _script(fake_binary, "exit 127")
    assert native.vscmedia_path() == fake_binary    # decided once


def test_no_build_leaves_the_question_open(fake_binary):
    assert native.vscmedia_path(build=False) is None
    _script(fake_binary, "exit 1")
    assert native.vscmedia_path(build=False) == fake_binary


def test_media_layer_takes_cv2_without_the_engine(fake_binary, tmp_path):
    """make_test_video, probe, extract and the chunk encoder (lossless FFV1
    in matroska) on their cv2 paths: what the steps run where vscmedia
    does not start."""
    import cv2
    import numpy as np
    from vsc_tpu_torch.io.image import read_rgb
    from vsc_tpu_torch.io.media import (encode_chunk, extract_frames,
                                        make_test_video)
    from vsc_tpu_torch.io.probe import get_video_framerate, probe_video
    _script(fake_binary, "exit 127")
    video = tmp_path / "clip.mp4"
    make_test_video(video, width=64, height=48, frames=5)   # cv2's mp4v
    info = probe_video(video)
    assert (info["width"], info["height"]) == (64, 48)
    assert get_video_framerate(video) == "24/1"
    frames = tmp_path / "frames"
    assert extract_frames(video, frames) == 5
    assert len(list(frames.glob("frame_*.png"))) == 5
    chunk = tmp_path / "chunks" / "sbs_000002_000005.mkv"
    chunk.parent.mkdir()
    encode_chunk(frames, 2, 4, "24/1", 19, "slow", chunk,
                 pattern="frame_%06d.png")
    assert sorted(p.name for p in chunk.parent.iterdir()) == [chunk.name]
    cap = cv2.VideoCapture(str(chunk))
    decoded = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        decoded.append(bgr[..., ::-1])
    cap.release()
    want = [read_rgb(frames / f"frame_{i:06d}.png") for i in range(2, 6)]
    assert len(decoded) == 4
    for got, w in zip(decoded, want):      # FFV1 is lossless
        np.testing.assert_array_equal(got, w)
