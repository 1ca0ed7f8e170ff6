"""NHWC ↔ NCHW views.

The port keeps activations NHWC (the JAX package's layout and the kernels'
layout). torch's convolution, padding and pooling operators are NCHW, so
they receive ``to_nchw(x)``: a zero-copy ``channels_last`` view when ``x`` is
contiguous NHWC. ``to_nhwc`` turns an operator's result back, copying only if
the operator returned another memory format.
"""

from __future__ import annotations

import torch


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()
