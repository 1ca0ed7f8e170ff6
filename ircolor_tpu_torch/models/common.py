"""Shared model plumbing (``ircolor_tpu/models/common.py`` subset).

* ``use_bias_for_norm``: conv bias iff instance norm.
* ``norm_nhwc``: instance norm in the JAX package's dtype rule — one-pass
  statistics on the bf16 path, two-pass on the f32 parity path.
* ``conv_nhwc``: a ``nn.Conv2d``'s parameters applied to an NHWC tensor in
  the compute dtype (the JAX ``Conv(dtype=...)`` casts the same way).
* ``quant_conv_nhwc``: the same on the int8 route (``QuantConv``).
* ``concat_conv3x3``: a 3×3 zero-SAME conv over ``concat(a, b)`` computed as
  ``conv(a, K[:, :Ca]) + conv(b, K[:, Ca:])`` without materializing the
  concat, exactly as ``ConcatConv3x3`` adds its two terms; float, or int8
  with dynamic or fixed activation scales.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ircolor_tpu_torch.ops.layout import to_nchw, to_nhwc
from ircolor_tpu_torch.ops.norm import instance_norm, instance_norm_onepass
from ircolor_tpu_torch.ops.quant import conv2d_int8, conv2d_int8_fixed

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


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)


def quant_conv_nhwc(
    conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype, *, pad: str = "zero"
) -> torch.Tensor:
    """The JAX ``QuantConv``: a 3×3 stride-1 ``nn.Conv2d``'s float32
    parameters applied on the int8 route (``ops.quant.conv2d_int8``) with
    one pixel of ``pad`` (``"zero"``, or ``"reflect"`` for the resnet
    blocks, which reflect-pad and then convolve VALID in the JAX package:
    the same sums)."""
    return conv2d_int8(x, _hwio(conv), pad=pad, bias=conv.bias, out_dtype=dtype)


def concat_conv3x3(
    conv: nn.Conv2d, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype,
    quant: str | None = None,
) -> torch.Tensor:
    """``quant``: None (float), ``"dynamic"`` (``conv2d_int8``) or
    ``"fixed"`` (``conv2d_int8_fixed``). On the int8 routes each leg
    quantizes its own input and its own half of the weight; the legs are
    float32 terms summed, then the bias is added, then the cast."""
    ca = a.shape[-1]
    if quant is not None:
        fn = {"dynamic": conv2d_int8, "fixed": conv2d_int8_fixed}[quant]
        k = _hwio(conv)
        ya = fn(a, k[:, :, :ca], out_dtype=torch.float32)
        return fn(b, k[:, :, ca:], addend=ya, bias=conv.bias, out_dtype=dtype)
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
