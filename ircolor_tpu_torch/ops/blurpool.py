"""Anti-aliased blur-pool down/upsampling of NHWC tensors
(``ircolor_tpu/ops/blurpool.py``).

* ``blur_downsample``: pad by floor/ceil((filt−1)/2 + pad_off), then a
  depthwise binomial blur at ``stride``.
* ``blur_upsample_aa``: bilinear ×stride (align_corners=True), pad, then the
  depthwise blur at stride 1.

Plain ``F.pad`` + grouped ``F.conv2d``: the JAX package's matmul and
shift-add forms are TPU layout devices for the same math.

The ``_spatial`` forms take an image as a list of H-shards of any heights,
or as a grid of tiles (``parallel/spatial.py``), and return its output in
the same form: a shard's output rows, and a tile's columns, are those of
the whole image's output at their global positions (the stride-2 phase
and the upsample's grid stay global). One body serves both forms, a list
of H-shards being the grid of one tile column.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.ops.filters import binomial_filter_2d
from ircolor_tpu_torch.ops.layout import to_nchw, to_nhwc
from ircolor_tpu_torch.ops.padding import pad2d, pad2d_spatial
from ircolor_tpu_torch.ops.resize import bilinear_align_corners, resize_shard
from ircolor_tpu_torch.parallel.spatial import (
    as_grid,
    columns,
    from_grid,
    stride2_heights,
    tile_sizes,
    tile_starts,
    tiles,
)


def _blur_pad_sizes(filt_size: int, pad_off: int = 0) -> tuple[int, int, int, int]:
    pad = (filt_size - 1) / 2.0
    lo = int(pad + pad_off)
    hi = int(math.ceil(pad + pad_off))
    return (lo, hi, lo, hi)


def _depthwise_blur(y: torch.Tensor, filt_size: int, stride: int) -> torch.Tensor:
    c = y.shape[-1]
    filt = torch.from_numpy(binomial_filter_2d(filt_size)).to(y.device, y.dtype)
    weight = filt[None, None].expand(c, 1, filt_size, filt_size)
    return to_nhwc(F.conv2d(to_nchw(y), weight, stride=stride, groups=c))


def blur_downsample(
    x: torch.Tensor,
    *,
    filt_size: int = 3,
    stride: int = 2,
    pad_type: str = "reflect",
    pad_off: int = 0,
) -> torch.Tensor:
    y = pad2d(x, _blur_pad_sizes(filt_size, pad_off), pad_type)
    return _depthwise_blur(y, filt_size, stride)


def blur_upsample_aa(
    x: torch.Tensor,
    *,
    filt_size: int = 3,
    stride: int = 2,
    pad_type: str = "reflect",
) -> torch.Tensor:
    _, h, w, _ = x.shape
    y = bilinear_align_corners(x, (h * stride, w * stride))
    y = pad2d(y, _blur_pad_sizes(filt_size), pad_type)
    return _depthwise_blur(y, filt_size, 1)


def _check_spatial(filt_size: int, pad_type: str) -> int:
    """The blur's padding (odd filters: the same on both sides), checked."""
    lo, hi, _, _ = _blur_pad_sizes(filt_size)
    if lo != hi or pad_type != "reflect":
        raise NotImplementedError("the spatial blur-pool takes odd filters and reflect padding")
    return lo


def blur_downsample_spatial(xs, *, filt_size: int = 3, stride: int = 2,
                            pad_type: str = "reflect") -> list:
    """``blur_downsample`` (stride 2) of the image whose H-shards (or
    tiles) are ``xs``: shard i gives the output rows r with 2r among its
    rows (``stride2_heights``; a tile, the columns c with 2c among its
    columns too), each from its rows and a halo of the filter's padding;
    raises where a shard would give none."""
    p = _check_spatial(filt_size, pad_type)
    if stride != 2:
        raise NotImplementedError("the spatial blur_downsample takes stride 2")
    heights, widths = (stride2_heights(tile_sizes(xs, a)) for a in (1, 2))
    if min(heights) < 1 or min(widths) < 1:
        raise ValueError(f"the spatial blur_downsample leaves a shard no row or column (shard "
                         f"rows {tile_sizes(xs, 1)} -> {heights}, columns {tile_sizes(xs, 2)} -> "
                         f"{widths})")
    # Slab row 0 is global row start - p; output row r reads rows 2r - p ..
    # 2r + p, so the shard's first, r = ceil(start / 2), from slab row
    # 2r - start (and the same in columns).
    firsts = [[2 * -(-start // 2) - start for start in tile_starts(xs, axis)] for axis in (1, 2)]
    out = [[_depthwise_blur(slab[:, r0:, c0:], filt_size, stride)[:, :n, :m]
            for slab, c0, m in zip(row, firsts[1], widths)]
           for row, r0, n in zip(as_grid(pad2d_spatial(xs, p, pad_type)), firsts[0], heights)]
    return from_grid(out, xs)


def blur_upsample_aa_spatial(xs, *, filt_size: int = 3, stride: int = 2,
                             pad_type: str = "reflect", out_heights=None,
                             out_widths=None) -> list:
    """``blur_upsample_aa`` of the image whose H-shards (or tiles) are
    ``xs``, as shards of ``out_heights`` rows (by default ``stride`` × each
    shard's; they must sum to ``stride`` × the image's rows) and tiles of
    ``out_widths`` columns (likewise), each on its input's device. Each
    tile's upsampled rows, and the filter's padding rows beyond them
    (reflected at the image's edges), take their sources and weights from
    their global positions, gathered from the shards that hold them
    (``resize_shard`` along H over its tile column); then those rows'
    upsampled columns with the padding columns, along W over its tile row
    (a list of H-shards: its one tile, the image's width); then the blur,
    VALID. A tile row at a time, so that one row's float32 planes are held
    at once."""
    p = _check_spatial(filt_size, pad_type)
    cuts = []
    for axis, cut in ((1, out_heights), (2, out_widths)):
        have = tile_sizes(xs, axis)
        cut = [n * stride for n in have] if cut is None else list(cut)
        if len(cut) != len(have) or sum(cut) != stride * sum(have) or min(cut) < 1:
            raise ValueError(f"the upsample's cut {cut} along axis {axis} must give each of the "
                             f"{len(have)} shards some of the {stride * sum(have)} upsampled ones")
        cuts.append(cut)
    cols, dtype = columns(as_grid(xs)), tiles(xs)[0].dtype
    out = []
    for i in range(len(cuts[0])):  # a tile row at a time: one row's float32 planes at once
        row = [resize_shard(col, 1, cuts[0], i, p) for col in cols]
        out.append([_depthwise_blur(resize_shard(row, 2, cuts[1], j, p).to(dtype), filt_size, 1)
                    for j in range(len(row))])
    return from_grid(out, xs)
