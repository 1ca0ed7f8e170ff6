"""Bilinear resize with ``align_corners=True`` (``ircolor_tpu/ops/resize.py``).

Sample grid ``src = dst · (in − 1)/(out − 1)``, with the per-axis indices and
weights computed once in float64 numpy, then a gather + lerp per axis in
float32 — the same math as the JAX package's gather path.

The grid is not shift-invariant, so an H-shard's rows, and a W-tile's
columns, take their sources and weights from their global positions
(``interp_rows``, ``resize_shard`` along either axis).
"""

from __future__ import annotations

import numpy as np
import torch

from ircolor_tpu_torch.parallel.spatial import (
    as_grid,
    columns,
    from_grid,
    gather_rows,
    tile_sizes,
    tiles,
)


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


def interp_rows(x: torch.Tensor, rows, in_size: int, out_size: int, first: int,
                axis: int = 1) -> torch.Tensor:
    """Rows ``rows`` (global output indices) of the align-corners resize
    along H from ``in_size`` to ``out_size`` rows, of float ``x`` whose row
    0 is global input row ``first``: the rows and weights of the whole
    image's grid, the gather + lerp of ``_interp_axis``. Raises where a row
    reads outside ``x``. ``axis`` 2: columns, along W."""
    lo, hi, w = (a[np.asarray(rows)] for a in _align_corners_grid(in_size, out_size))
    lo, hi = lo - first, hi - first
    if lo.min() < 0 or hi.max() >= x.shape[axis]:
        raise ValueError(f"rows {rows[0]}..{rows[-1]} read outside the slab's rows")
    return _lerp(x, axis, lo, hi, w)


def resize_shard(xs, axis: int, out_sizes, i: int, halo: int = 0) -> torch.Tensor:
    """Along ``axis`` (1: over the H-shards ``xs``; 2: over the W-tiles of
    one tile row), output shard ``i`` of the align-corners resize of the
    image to ``sum(out_sizes)`` cut as ``out_sizes``, with ``halo`` more on
    both sides (the output indices past the image's edges reflected: the
    padding of a filter that follows), in float32 on ``xs[i]``'s device,
    from its global sources and weights gathered from the shards that hold
    them. One shard a call, so that a caller holds one shard's float32
    rows at a time."""
    gin, gout = sum(x.shape[axis] for x in xs), sum(out_sizes)
    lo, hi, _ = _align_corners_grid(gin, gout)
    start = sum(out_sizes[:i])
    idx = np.abs(np.arange(start - halo, start + out_sizes[i] + halo))
    idx = np.where(idx >= gout, 2 * gout - 2 - idx, idx)
    first, last = int(lo[idx].min()), int(hi[idx].max())
    slab = gather_rows(xs, range(first, last + 1), xs[i].device, axis)
    return interp_rows(slab.float(), idx, gin, gout, first, axis)


def bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize NHWC ``x`` to ``out_hw`` (align_corners=True), in float32."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    y = _interp_axis(x.float(), 1, h, oh)
    y = _interp_axis(y, 2, w, ow)
    return y.to(x.dtype).contiguous()


def bilinear_align_corners_spatial(xs, out_heights, out_w: int | None = None, *,
                                   out_widths=None) -> list:
    """``bilinear_align_corners`` of the image whose H-shards are ``xs`` to
    ``sum(out_heights)`` × ``out_w``, as shards of ``out_heights`` rows,
    shard i on ``xs[i]``'s device; of a grid of tiles, to the tiles of
    ``out_heights`` × ``out_widths``. Along H over each tile column, then
    along W over each tile row (``resize_shard``), a tile row at a time:
    each output row (column) from its global sources and weights, gathered
    from the shards (tiles) that hold them; an axis whose cut already
    matches is left as it is."""
    grid, dtype = as_grid(xs), tiles(xs)[0].dtype
    out_heights = list(out_heights)
    out_widths = [out_w] if out_widths is None else list(out_widths)
    rows_match, cols_match = tile_sizes(xs, 1) == out_heights, tile_sizes(xs, 2) == out_widths
    out = []
    for i in range(len(out_heights)):
        row = grid[i] if rows_match else [resize_shard(col, 1, out_heights, i)
                                          for col in columns(grid)]
        out.append([(t if cols_match else resize_shard(row, 2, out_widths, j)).to(dtype)
                    .contiguous() for j, t in enumerate(row)])
    return from_grid(out, xs)
