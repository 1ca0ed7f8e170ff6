"""Shared model plumbing (``ircolor_tpu/models/common.py`` subset).

* ``use_bias_for_norm``: conv bias iff instance norm.
* ``norm_nhwc``: instance norm in the JAX package's dtype rule — one-pass
  statistics on the bf16 path, two-pass on the f32 parity path.
* ``conv_nhwc``: a ``nn.Conv2d``'s parameters applied to an NHWC tensor in
  the compute dtype (the JAX ``Conv(dtype=...)`` casts the same way).
* ``concat_conv3x3``: a 3×3 zero-SAME conv over ``concat(a, b)`` computed as
  ``conv(a, K[:, :Ca]) + conv(b, K[:, Ca:])`` without materializing the
  concat, exactly as ``ConcatConv3x3`` adds its two terms.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ircolor_tpu_torch.ops.layout import to_nchw, to_nhwc
from ircolor_tpu_torch.ops.norm import instance_norm, instance_norm_onepass

NORM_TYPES = ("instance", "batch", "none")


def use_bias_for_norm(norm: str) -> bool:
    if norm not in NORM_TYPES:
        raise NotImplementedError(f"Normalization type [{norm}] not supported")
    return norm == "instance"


def norm_nhwc(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        return instance_norm_onepass(x)
    return instance_norm(x)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bias = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(
        to_nchw(x.to(dtype)), conv.weight.to(dtype), bias,
        stride=conv.stride, padding=conv.padding,
    )
    return to_nhwc(y)


def concat_conv3x3(
    conv: nn.Conv2d, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    ca = a.shape[-1]
    w = conv.weight.to(dtype)
    y = F.conv2d(to_nchw(a.to(dtype)), w[:, :ca], padding=1) + F.conv2d(
        to_nchw(b.to(dtype)), w[:, ca:], padding=1
    )
    if conv.bias is not None:
        y = y + conv.bias.to(dtype)[None, :, None, None]
    return to_nhwc(y)


def init_conv_(conv: nn.Conv2d, init_type: str, gain: float, gen: torch.Generator) -> None:
    """The reference ``init_weights`` options: kernels per ``init_type``,
    biases zero (``normal`` is N(0, gain), the reference default)."""
    w = conv.weight
    if init_type == "normal":
        nn.init.normal_(w, 0.0, gain, generator=gen)
    elif init_type == "xavier":
        nn.init.xavier_normal_(w, gain=gain, generator=gen)
    elif init_type == "kaiming":
        nn.init.kaiming_normal_(w, a=0, mode="fan_in", generator=gen)
    elif init_type == "orthogonal":
        nn.init.orthogonal_(w, gain=gain, generator=gen)
    else:
        raise NotImplementedError(f"initialization method [{init_type}] is not implemented")
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)
