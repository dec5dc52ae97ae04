"""The port's image I/O (vsc_tpu_torch/io/image) against the JAX package's
(vsc_tpu/io/image), the cases of tests/test_image_io.py on both: each file
one package writes decodes to the same pixels as the other's, and each
package reads the other's files back unchanged."""

import numpy as np
import pytest

from vsc_tpu.io import image as jax_image
from vsc_tpu_torch.io import image as torch_image

PAIRS = pytest.mark.parametrize(
    "writer, reader", [(jax_image, torch_image), (torch_image, jax_image),
                       (torch_image, torch_image)],
    ids=["jax-to-torch", "torch-to-jax", "torch-to-torch"])


@PAIRS
def test_rgb_roundtrip(tmp_path, writer, reader):
    rgb = np.random.default_rng(0).integers(0, 256, (20, 30, 3), np.uint8)
    path = tmp_path / "x.png"
    assert writer.write_rgb(path, rgb)
    np.testing.assert_array_equal(reader.read_rgb(path), rgb)


@pytest.mark.parametrize("ext, dtype, top", [(".png", np.uint8, 255),
                                             (".tif", np.uint16, 65535)])
def test_depth_write_verify_equals_jax(tmp_path, ext, dtype, top):
    depth = np.random.default_rng(1).random((16, 24)).astype(np.float32)
    got, want = (tmp_path / f"t{ext}", tmp_path / f"j{ext}")
    # resized up + normalized, as tests/test_image_io.py writes it
    assert torch_image.write_depth_verified(depth, (48, 32), got)
    assert jax_image.write_depth_verified(depth, (48, 32), want)
    d = torch_image.read_depth(got)
    assert d.shape == (32, 48) and d.dtype == dtype
    assert d.min() == 0 and d.max() == top
    np.testing.assert_array_equal(d, jax_image.read_depth(want))
    np.testing.assert_array_equal(jax_image.read_depth(got), d)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_quantized_depth_equals_jax(tmp_path, dtype):
    top = np.iinfo(dtype).max
    q = np.random.default_rng(2).integers(0, top + 1, (18, 26), dtype)
    ext = ".tif" if dtype == np.uint16 else ".png"
    got, want = tmp_path / f"t{ext}", tmp_path / f"j{ext}"
    assert torch_image.write_quantized_depth(q, got)
    assert jax_image.write_quantized_depth(q, want)
    for path in (got, want):
        for mod in (torch_image, jax_image):
            d = mod.read_depth(path)
            assert d.dtype == dtype
            np.testing.assert_array_equal(d, q)


@pytest.mark.parametrize("mod", [jax_image, torch_image],
                         ids=["jax", "torch"])
def test_depth_flat_input_rejected(tmp_path, mod):
    flat = np.full((8, 8), 3.0, np.float32)
    out = tmp_path / "depth_frame_000002.png"
    assert not mod.write_depth_verified(flat, (8, 8), out)
    assert not out.exists()


@pytest.mark.parametrize("mod", [jax_image, torch_image],
                         ids=["jax", "torch"])
@pytest.mark.parametrize("ext", [".png", ".tif"])
def test_corrupt_write_is_deleted(tmp_path, monkeypatch, mod, ext):
    """A file the read-back check cannot decode is removed and the write
    reports failure (the saver then retries it)."""
    import cv2
    real = cv2.imwrite

    def truncating(path, img, *args):
        ok = real(path, img, *args)
        with open(path, "r+b") as f:
            f.truncate(12)
        return ok
    monkeypatch.setattr(cv2, "imwrite", truncating)
    dtype = np.uint16 if ext == ".tif" else np.uint8
    q = np.arange(64, dtype=dtype).reshape(8, 8)
    out = tmp_path / f"depth_frame_000003{ext}"
    assert not mod.write_quantized_depth(q, out)
    assert not out.exists()
    depth = np.random.default_rng(3).random((8, 8)).astype(np.float32)
    assert not mod.write_depth_verified(depth, (8, 8), out)
    assert not out.exists()


@pytest.mark.parametrize("depth_dtype", [np.uint8, np.uint16])
def test_load_image_pair_resize_equals_jax(tmp_path, depth_dtype):
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (32, 40, 3), np.uint8)
    top = np.iinfo(depth_dtype).max
    depth = rng.integers(0, top + 1, (16, 20), depth_dtype)
    ext = ".tif" if depth_dtype == np.uint16 else ".png"
    assert torch_image.write_rgb(tmp_path / "f.png", rgb)
    assert torch_image.write_quantized_depth(depth, tmp_path / f"d{ext}")
    r, d = torch_image.load_image_pair(tmp_path / "f.png", tmp_path / f"d{ext}")
    jr, jd = jax_image.load_image_pair(tmp_path / "f.png", tmp_path / f"d{ext}")
    assert r.shape == (32, 40, 3)
    assert d.shape == (32, 40) and d.dtype == depth_dtype   # Lanczos-4
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(d, jd)
