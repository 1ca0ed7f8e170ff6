"""Fixed filters (``ircolor_tpu/ops/filters.py``): binomial low-pass
filters (Pascal-triangle rows of size 1..7, normalized 2-D outer products)
and the SSIM loss's Gaussian window."""

from __future__ import annotations

import numpy as np

_PASCAL_ROWS = {
    1: [1.0],
    2: [1.0, 1.0],
    3: [1.0, 2.0, 1.0],
    4: [1.0, 3.0, 3.0, 1.0],
    5: [1.0, 4.0, 6.0, 4.0, 1.0],
    6: [1.0, 5.0, 10.0, 10.0, 5.0, 1.0],
    7: [1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0],
}


def binomial_filter_1d(filt_size: int = 3) -> np.ndarray:
    if filt_size not in _PASCAL_ROWS:
        raise ValueError("filt_size must be 1-7")
    return np.asarray(_PASCAL_ROWS[filt_size], dtype=np.float32)


def binomial_filter_2d(filt_size: int = 3) -> np.ndarray:
    """Size 3 → [1,2,1]⊗[1,2,1]/16."""
    a = binomial_filter_1d(filt_size)
    filt = a[:, None] * a[None, :]
    return (filt / filt.sum()).astype(np.float32)


def gaussian_window_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """1-D Gaussian window normalized to sum 1."""
    coords = np.arange(window_size, dtype=np.float64) - (window_size - 1) / 2.0
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)
