"""Anti-aliased blur-pool down/upsampling of NHWC tensors
(``ircolor_tpu/ops/blurpool.py``).

* ``blur_downsample``: pad by floor/ceil((filt−1)/2 + pad_off), then a
  depthwise binomial blur at ``stride``.
* ``blur_upsample_aa``: bilinear ×stride (align_corners=True), pad, then the
  depthwise blur at stride 1.

Plain ``F.pad`` + grouped ``F.conv2d``: the JAX package's matmul and
shift-add forms are TPU layout devices for the same math.

The ``_spatial`` forms take an image as a list of H-shards
(``parallel/spatial.py``, equal shards of an even number of rows, so that
every shard starts on an even global row and keeps the stride-2 phase of
the whole image) and return its output's shards.
"""

from __future__ import annotations

import math

import numpy as np

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.ops.filters import binomial_filter_2d
from ircolor_tpu_torch.ops.layout import to_nchw, to_nhwc
from ircolor_tpu_torch.ops.padding import _pad_w, pad2d, pad2d_spatial
from ircolor_tpu_torch.ops.resize import _interp_axis, bilinear_align_corners, interp_rows
from ircolor_tpu_torch.parallel.spatial import halo_slabs


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


def _check_spatial(xs, filt_size: int, pad_type: str) -> int:
    """The blur's padding (odd filters: the same on both sides), checked."""
    lo, hi, _, _ = _blur_pad_sizes(filt_size)
    if lo != hi or pad_type != "reflect":
        raise NotImplementedError("the spatial blur-pool takes odd filters and reflect padding")
    if any(x.shape[1] != xs[0].shape[1] for x in xs) or xs[0].shape[1] % 2:
        raise ValueError("the spatial blur-pool needs equal shards of an even number of rows")
    return lo


def blur_downsample_spatial(xs, *, filt_size: int = 3, stride: int = 2,
                            pad_type: str = "reflect") -> list[torch.Tensor]:
    """``blur_downsample`` (stride 2) of the image whose H-shards are
    ``xs``: each shard's output rows from its rows and a halo of the
    filter's padding."""
    p = _check_spatial(xs, filt_size, pad_type)
    if stride != 2:
        raise NotImplementedError("the spatial blur_downsample takes stride 2")
    return [_depthwise_blur(s, filt_size, stride) for s in pad2d_spatial(xs, p, pad_type)]


def blur_upsample_aa_spatial(xs, *, filt_size: int = 3, stride: int = 2,
                             pad_type: str = "reflect") -> list[torch.Tensor]:
    """``blur_upsample_aa`` of the image whose H-shards are ``xs``. A
    shard's upsampled rows, and the filter's padding rows beyond them
    (reflected at the image's edges), take their sources and weights from
    their global positions; those sources lie within the shard's rows ±1,
    so a 1-row halo is enough."""
    p = _check_spatial(xs, filt_size, pad_type)
    h, w = xs[0].shape[1], xs[0].shape[2]
    gh, oh = h * len(xs), h * len(xs) * stride
    out = []
    for i, slab in enumerate(halo_slabs(xs, 1, "replicate")):
        rows = np.arange(stride * h * i - p, stride * h * (i + 1) + p)
        rows = np.abs(rows)
        rows = np.where(rows >= oh, 2 * oh - 2 - rows, rows)
        y = interp_rows(slab.float(), rows, gh, oh, h * i - 1)
        y = _interp_axis(y, 2, w, w * stride).to(slab.dtype)
        out.append(_depthwise_blur(_pad_w(y, p, pad_type), filt_size, 1))
    return out
