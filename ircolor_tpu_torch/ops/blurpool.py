"""Anti-aliased blur-pool down/upsampling of NHWC tensors
(``ircolor_tpu/ops/blurpool.py``).

* ``blur_downsample``: pad by floor/ceil((filt−1)/2 + pad_off), then a
  depthwise binomial blur at ``stride``.
* ``blur_upsample_aa``: bilinear ×stride (align_corners=True), pad, then the
  depthwise blur at stride 1.

Plain ``F.pad`` + grouped ``F.conv2d``: the JAX package's matmul and
shift-add forms are TPU layout devices for the same math.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.ops.filters import binomial_filter_2d
from ircolor_tpu_torch.ops.layout import to_nchw, to_nhwc
from ircolor_tpu_torch.ops.padding import pad2d
from ircolor_tpu_torch.ops.resize import bilinear_align_corners


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
