"""Bilinear resize with ``align_corners=True`` (``ircolor_tpu/ops/resize.py``).

Sample grid ``src = dst · (in − 1)/(out − 1)``, with the per-axis indices and
weights computed once in float64 numpy, then a gather + lerp per axis in
float32 — the same math as the JAX package's gather path.
"""

from __future__ import annotations

import numpy as np
import torch


def _align_corners_grid(in_size: int, out_size: int):
    if out_size == 1 or in_size == 1:
        lo = np.zeros((out_size,), dtype=np.int64)
        return lo, lo, np.zeros((out_size,), dtype=np.float32)
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 2)
    return lo, lo + 1, (src - lo).astype(np.float32)


def _interp_axis(x: torch.Tensor, axis: int, in_size: int, out_size: int) -> torch.Tensor:
    if in_size == out_size:
        return x
    lo, hi, w = _align_corners_grid(in_size, out_size)
    xlo = x.index_select(axis, torch.from_numpy(lo).to(x.device))
    xhi = x.index_select(axis, torch.from_numpy(hi).to(x.device))
    shape = [1] * x.ndim
    shape[axis] = out_size
    wj = torch.from_numpy(w).to(x.device).reshape(shape)
    return xlo * (1.0 - wj) + xhi * wj


def bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize NHWC ``x`` to ``out_hw`` (align_corners=True), in float32."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    y = _interp_axis(x.float(), 1, h, oh)
    y = _interp_axis(y, 2, w, ow)
    return y.to(x.dtype).contiguous()
