"""Anti-aliased blur-pool down/upsampling of NHWC tensors
(``ircolor_tpu/ops/blurpool.py``).

* ``blur_downsample``: pad by floor/ceil((filt−1)/2 + pad_off), then a
  depthwise binomial blur at ``stride``.
* ``blur_upsample_aa``: bilinear ×stride (align_corners=True), pad, then the
  depthwise blur at stride 1.

Plain ``F.pad`` + grouped ``F.conv2d``: the JAX package's matmul and
shift-add forms are TPU layout devices for the same math.

The ``_spatial`` forms take an image as a list of H-shards of any heights
(``parallel/spatial.py``) and return its output's shards: a shard's output
rows are those of the whole image's output, at their global positions
(the stride-2 phase and the upsample's grid stay global).
"""

from __future__ import annotations

import math

import numpy as np

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.ops.filters import binomial_filter_2d
from ircolor_tpu_torch.ops.layout import to_nchw, to_nhwc
from ircolor_tpu_torch.ops.padding import _pad_w, pad2d, pad2d_spatial
from ircolor_tpu_torch.ops.resize import (
    _align_corners_grid,
    _interp_axis,
    bilinear_align_corners,
    interp_rows,
)
from ircolor_tpu_torch.parallel.spatial import gather_rows, row_starts, stride2_heights


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
                            pad_type: str = "reflect") -> list[torch.Tensor]:
    """``blur_downsample`` (stride 2) of the image whose H-shards are
    ``xs``: shard i gives the output rows r with 2r among its rows
    (``stride2_heights``), each from its rows and a halo of the filter's
    padding; raises where a shard would give none."""
    p = _check_spatial(filt_size, pad_type)
    if stride != 2:
        raise NotImplementedError("the spatial blur_downsample takes stride 2")
    heights = stride2_heights([x.shape[1] for x in xs])
    if min(heights) < 1:
        raise ValueError(f"the spatial blur_downsample leaves a shard no row (shard rows "
                         f"{[x.shape[1] for x in xs]} -> {heights})")
    out = []
    for slab, start, n in zip(pad2d_spatial(xs, p, pad_type), row_starts(xs), heights):
        # Slab row 0 is global row start - p; output row r reads rows 2r - p ..
        # 2r + p, so the shard's first, r = ceil(start / 2), from slab row 2r - start.
        first = 2 * -(-start // 2) - start
        out.append(_depthwise_blur(slab[:, first:], filt_size, stride)[:, :n])
    return out


def blur_upsample_aa_spatial(xs, *, filt_size: int = 3, stride: int = 2,
                             pad_type: str = "reflect", out_heights=None) -> list[torch.Tensor]:
    """``blur_upsample_aa`` of the image whose H-shards are ``xs``, as
    shards of ``out_heights`` rows (by default ``stride`` × each shard's;
    they must sum to ``stride`` × the image's rows), shard i on ``xs[i]``'s
    device. A shard's upsampled rows, and the filter's padding rows beyond
    them (reflected at the image's edges), take their sources and weights
    from their global positions, gathered from the shards that hold them."""
    p = _check_spatial(filt_size, pad_type)
    w = xs[0].shape[2]
    gh = sum(x.shape[1] for x in xs)
    oh = gh * stride
    out_heights = [x.shape[1] * stride for x in xs] if out_heights is None else list(out_heights)
    if len(out_heights) != len(xs) or sum(out_heights) != oh or min(out_heights) < 1:
        raise ValueError(f"out_heights {out_heights} must give each of the {len(xs)} shards rows "
                         f"of the {oh} upsampled ones")
    lo, hi, _ = _align_corners_grid(gh, oh)
    out, start = [], 0
    for x, n in zip(xs, out_heights):
        rows = np.abs(np.arange(start - p, start + n + p))
        rows = np.where(rows >= oh, 2 * oh - 2 - rows, rows)
        first, last = int(lo[rows].min()), int(hi[rows].max())
        slab = gather_rows(xs, range(first, last + 1), x.device)
        y = interp_rows(slab.float(), rows, gh, oh, first)
        y = _interp_axis(y, 2, w, w * stride).to(slab.dtype)
        out.append(_depthwise_blur(_pad_w(y, p, pad_type), filt_size, 1))
        start += n
    return out
