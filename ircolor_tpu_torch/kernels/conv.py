"""Implicit-GEMM VALID 3×3 conv of a pre-padded NHWC input (the bf16 conv
of ``csrc/conv_fwd.cu`` in its VALID halo mode, with no stats).

Counterpart of ``ircolor_tpu/ops/pallas_conv.py``: ``conv3x3_valid_pallas``
and ``conv3x3_valid_pallas_v2``. Their ``tile_h``, ``double_buffer`` and
``mode`` pick TPU schedules of one function (f32 accumulation, one rounding
to the input's dtype); both entry points launch the same kernel, counted
as ``conv3x3_valid``, and keep the JAX asserts as ``ValueError``s. The JAX
v1 pads W + 2 to a multiple of 8 with columns no tap reads; the kernel
needs no such pad.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.kernels.resblock import _launch_bf16

MODES = ("preshift", "dxcat")


def conv_valid_f32(z: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """NHWC ``z`` ⊛ HWIO ``kernel`` (rounded to z's dtype first), VALID, in
    float32."""
    k = kernel.to(z.dtype).float().permute(3, 2, 0, 1)
    return F.conv2d(z.float().permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def conv3x3_valid_plain(x_padded, kernel):
    """Plain version: the f32 VALID conv, rounded once to x's dtype."""
    return conv_valid_f32(x_padded, kernel).to(x_padded.dtype)


def _check(x_padded, kernel, tile_h: int) -> None:
    c = x_padded.shape[-1]
    if tuple(kernel.shape[:3]) != (3, 3, c):
        raise ValueError(f"kernel {tuple(kernel.shape)}: expected (3, 3, {c}, Cout)")
    h = x_padded.shape[1] - 2
    if h % tile_h:
        raise ValueError(f"H={h} must divide tile_h={tile_h}")


def _run(x_padded, kernel):
    if x_padded.device.type == "cpu":
        return conv3x3_valid_plain(x_padded, kernel)
    return _launch_bf16("conv3x3_valid", "valid", (x_padded,), (kernel,), stats=False)


def conv3x3_valid_pallas(x_padded, kernel, *, tile_h=16, double_buffer=True):
    """VALID 3×3 conv of a pre-padded (B, H+2, W+2, C) tensor → (B, H, W,
    Cout). Requires H % tile_h == 0, as the JAX function does."""
    del double_buffer  # a TPU DMA schedule: the same function either way
    _check(x_padded, kernel, tile_h)
    return _run(x_padded, kernel)


def conv3x3_valid_pallas_v2(x_padded, kernel, *, tile_h=16, mode="dxcat"):
    """The same conv under the JAX v2 contract: also W % 8 == 0 and
    ``mode`` in ``MODES``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _check(x_padded, kernel, tile_h)
    w = x_padded.shape[2] - 2
    if w % 8:
        raise ValueError(f"W={w} must be 8-aligned for the shifted-copy layout")
    return _run(x_padded, kernel)
