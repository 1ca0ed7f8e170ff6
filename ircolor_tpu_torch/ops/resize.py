"""Bilinear resize with ``align_corners=True`` (``ircolor_tpu/ops/resize.py``).

Sample grid ``src = dst · (in − 1)/(out − 1)``, with the per-axis indices and
weights computed once in float64 numpy, then a gather + lerp per axis in
float32 — the same math as the JAX package's gather path.

The grid is not shift-invariant, so an H-shard's rows take their sources
and weights from their global positions (``interp_rows``,
``bilinear_align_corners_spatial``).
"""

from __future__ import annotations

import numpy as np
import torch

from ircolor_tpu_torch.parallel.spatial import gather_rows


def _align_corners_grid(in_size: int, out_size: int):
    if out_size == 1 or in_size == 1:
        lo = np.zeros((out_size,), dtype=np.int64)
        return lo, lo, np.zeros((out_size,), dtype=np.float32)
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 2)
    return lo, lo + 1, (src - lo).astype(np.float32)


def _lerp(x: torch.Tensor, axis: int, lo, hi, w) -> torch.Tensor:
    """x's slices ``lo`` and ``hi`` along ``axis`` mixed by weights ``w``."""
    xlo = x.index_select(axis, torch.from_numpy(lo).to(x.device))
    xhi = x.index_select(axis, torch.from_numpy(hi).to(x.device))
    shape = [1] * x.ndim
    shape[axis] = len(w)
    wj = torch.from_numpy(w).to(x.device).reshape(shape)
    return xlo * (1.0 - wj) + xhi * wj


def _interp_axis(x: torch.Tensor, axis: int, in_size: int, out_size: int) -> torch.Tensor:
    if in_size == out_size:
        return x
    return _lerp(x, axis, *_align_corners_grid(in_size, out_size))


def interp_rows(x: torch.Tensor, rows, in_size: int, out_size: int, first: int) -> torch.Tensor:
    """Rows ``rows`` (global output indices) of the align-corners resize
    along H from ``in_size`` to ``out_size`` rows, of float ``x`` whose row
    0 is global input row ``first``: the rows and weights of the whole
    image's grid, the gather + lerp of ``_interp_axis``. Raises where a row
    reads outside ``x``."""
    lo, hi, w = (a[np.asarray(rows)] for a in _align_corners_grid(in_size, out_size))
    lo, hi = lo - first, hi - first
    if lo.min() < 0 or hi.max() >= x.shape[1]:
        raise ValueError(f"rows {rows[0]}..{rows[-1]} read outside the slab's rows")
    return _lerp(x, 1, lo, hi, w)


def bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize NHWC ``x`` to ``out_hw`` (align_corners=True), in float32."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    y = _interp_axis(x.float(), 1, h, oh)
    y = _interp_axis(y, 2, w, ow)
    return y.to(x.dtype).contiguous()


def bilinear_align_corners_spatial(xs, out_heights, out_w: int) -> list[torch.Tensor]:
    """``bilinear_align_corners`` of the image whose H-shards are ``xs`` to
    ``sum(out_heights)`` × ``out_w``, as shards of ``out_heights`` rows,
    shard i on ``xs[i]``'s device: each output row from its global sources
    and weights, gathered from the shards that hold them; where the rows
    already match shard for shard, each shard's columns alone."""
    heights = [x.shape[1] for x in xs]
    if list(out_heights) == heights:
        return [bilinear_align_corners(x, (x.shape[1], out_w)) for x in xs]
    gh, oh, w = sum(heights), sum(out_heights), xs[0].shape[2]
    lo, hi, _ = _align_corners_grid(gh, oh)
    out, start = [], 0
    for x, n in zip(xs, out_heights):
        rows = np.arange(start, start + n)
        first, last = int(lo[rows].min()), int(hi[rows].max())
        slab = gather_rows(xs, range(first, last + 1), x.device)
        y = _interp_axis(interp_rows(slab.float(), rows, gh, oh, first), 2, w, out_w)
        out.append(y.to(x.dtype).contiguous())
        start += n
    return out
