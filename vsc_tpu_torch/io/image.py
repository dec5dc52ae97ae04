"""
Image I/O
=========

PNG/TIFF read and write for pipeline intermediates, with the reference's
write-then-read-back verification for depth maps
(reference depth_map_generator.py:155-250) and RGB<->BGR handling
(cv2 stores BGR on disk; the pipeline computes in RGB).

The port's own copy of ``vsc_tpu/io/image.py`` (framework-free, cv2 on
every machine the port runs on, the card's included).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from vsc_tpu_torch.utils.console import suppress_cv2_logging

__all__ = [
    "read_rgb",
    "read_depth",
    "write_rgb",
    "write_depth_verified",
    "write_quantized_depth",
    "load_image_pair",
]


def read_rgb(path: Path | str) -> np.ndarray:
    """Load an RGB uint8 HWC image (BGR->RGB conversion as in
    reference helper/stereo_core.py:53-67)."""
    import cv2
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f"Could not load RGB: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def read_depth(path: Path | str) -> np.ndarray:
    """Load a depth map unchanged (uint8 PNG or uint16 TIFF), collapsing any
    color channels to gray (reference helper/stereo_core.py:54-62)."""
    import cv2
    depth = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if depth is None:
        raise ValueError(f"Could not load depth: {path}")
    if depth.ndim == 3:
        depth = cv2.cvtColor(depth, cv2.COLOR_BGR2GRAY)
    return depth


def load_image_pair(rgb_path: Path | str, depth_path: Path | str) -> tuple[np.ndarray, np.ndarray]:
    """(rgb u8 HWC, depth HW) pair; depth Lanczos-resized to the rgb size on
    mismatch (reference helper/stereo_core.py:32-68)."""
    import cv2
    rgb = read_rgb(rgb_path)
    depth = read_depth(depth_path)
    if rgb.shape[:2] != depth.shape[:2]:
        depth = cv2.resize(depth, (rgb.shape[1], rgb.shape[0]),
                           interpolation=cv2.INTER_LANCZOS4)
    return rgb, depth


def write_rgb(path: Path | str, rgb: np.ndarray) -> bool:
    """Write an RGB uint8 HWC image as PNG (stored BGR)."""
    import cv2
    with suppress_cv2_logging():
        return bool(cv2.imwrite(str(path), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)))


def _verify_written(path: str, expected_wh: tuple[int, int], is_16bit: bool) -> bool:
    """Read-back integrity check (reference depth_map_generator.py:155-191)."""
    import cv2
    try:
        with suppress_cv2_logging():
            img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            return False
        if img.shape[1] != expected_wh[0] or img.shape[0] != expected_wh[1]:
            return False
        want = np.uint16 if is_16bit else np.uint8
        return img.dtype == want
    except Exception:
        return False


def write_quantized_depth(data: np.ndarray, output_path: Path | str) -> bool:
    """Write an already-quantized depth map (uint8 -> PNG, uint16 -> deflate
    TIFF by dtype) and verify by reading back; delete on corruption
    (the write/verify half of reference depth_map_generator.py:194-250,
    for pipelines that resize+normalize+quantize on the device)."""
    import cv2
    import os

    output_path = str(output_path)
    is_16bit = data.dtype == np.uint16
    h, w = data.shape[:2]
    with suppress_cv2_logging():
        if is_16bit:
            ok = cv2.imwrite(output_path, data,
                             [cv2.IMWRITE_TIFF_COMPRESSION, 32946])  # deflate
        else:
            ok = cv2.imwrite(output_path, data)
    if not ok:
        return False
    if not _verify_written(output_path, (w, h), is_16bit):
        try:
            os.remove(output_path)
        except OSError:
            pass
        return False
    return True


def write_depth_verified(depth_map: np.ndarray, original_size: tuple[int, int],
                         output_path: Path | str) -> bool:
    """Resize (bilinear) to the original frame size, min-max normalize, write
    8-bit PNG or 16-bit deflate TIFF by extension, then verify by reading the
    file back; delete on corruption
    (reference depth_map_generator.py:194-250)."""
    import cv2
    import os

    output_path = str(output_path)
    resized = cv2.resize(depth_map.astype(np.float32), original_size,
                         interpolation=cv2.INTER_LINEAR)
    d_min, d_max = float(resized.min()), float(resized.max())
    d_range = d_max - d_min
    if d_range <= 0:
        return False
    resized = (resized - d_min) / d_range

    is_16bit = Path(output_path).suffix.lower() == ".tif"
    with suppress_cv2_logging():
        if is_16bit:
            data = np.round(resized * 65535).astype(np.uint16)
            ok = cv2.imwrite(output_path, data,
                             [cv2.IMWRITE_TIFF_COMPRESSION, 32946])  # deflate
        else:
            data = np.round(resized * 255).astype(np.uint8)
            ok = cv2.imwrite(output_path, data)
    if not ok:
        return False
    if not _verify_written(output_path, original_size, is_16bit):
        try:
            os.remove(output_path)
        except OSError:
            pass
        return False
    return True
