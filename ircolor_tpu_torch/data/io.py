"""Image I/O (``ircolor_tpu/data/io.py``, what ``run_test`` needs).

cv2 is imported inside the functions that read or write files, so the
package imports without it; PIL only as the fallback writer.
"""

from __future__ import annotations

import os

import numpy as np


def _resize(img: np.ndarray, size_hw: tuple[int, int] | int | None) -> np.ndarray:
    import cv2

    if size_hw is None:
        return img
    if isinstance(size_hw, int):
        size_hw = (size_hw, size_hw)
    h, w = size_hw
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)


def load_ir_image(path: str, size_hw=None, *, return_depth: bool = False):
    """Grayscale IR → H×W float32 in [0, 1]; with ``return_depth`` also the
    source bit depth (8 or 16)."""
    import cv2

    img_u = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img_u is None:
        raise RuntimeError(f"Could not read image: {path}")
    orig_dtype = img_u.dtype
    img = _resize(img_u, size_hw).astype(np.float32)
    if img.max() > 1.0:
        img /= 255.0 if orig_dtype == np.uint8 else 65535.0
    img = np.clip(img, 0.0, 1.0)
    if return_depth:
        return img, (8 if orig_dtype == np.uint8 else 16)
    return img


def load_rgb_image(path: str, size_hw=None) -> np.ndarray:
    """Color image → H×W×3 float32 RGB in [0, 1]."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise RuntimeError(f"Could not read RGB image: {path}")
    img = _resize(cv2.cvtColor(img, cv2.COLOR_BGR2RGB), size_hw)
    return np.clip(img.astype(np.float32) / 255.0, 0.0, 1.0)


def float01_to_uint8_rgb(img01: np.ndarray) -> np.ndarray:
    """float [0, 1] gray or RGB → uint8 H×W×3, gray replicated."""
    x = np.clip(img01, 0.0, 1.0)
    if x.ndim == 2:
        x = np.stack([x, x, x], axis=2)
    return (x * 255.0).astype(np.uint8)


def save_rgb(path: str, img_rgb_u8: np.ndarray) -> None:
    """Write with parent-dir creation; fast PNG compression (level 1)."""
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    bgr = cv2.cvtColor(np.ascontiguousarray(img_rgb_u8), cv2.COLOR_RGB2BGR)
    try:
        ok = cv2.imwrite(path, bgr, [cv2.IMWRITE_PNG_COMPRESSION, 1])
    except cv2.error:
        ok = False  # cv2 raises on unknown extensions
    if not ok:
        from PIL import Image

        Image.fromarray(img_rgb_u8).save(path)
