"""int8 quantized convolution for the int8 serving mode (``ircolor_tpu/ops/quant.py``).

Weights are quantized symmetrically per output channel,
``w ≈ wq · scale[co]`` with ``scale = amax/127``; activations per sample
(``quantize_dynamic``: ``x / (amax/127)``) or by the fixed 127/6σ grid
(``conv2d_int8_fixed`` and the fused block's conv2, whose inputs are
instance-normalized and ReLU'd). Every quantized site feeds an instance
norm, which absorbs the scales exactly; the only error is rounding noise.

``conv2d_int8`` / ``conv2d_int8_fixed`` are the JAX package's XLA int8
route (``QuantConv``, the int8 ``ConcatConv3x3``), here on the hand-written
int8 implicit-GEMM conv ``kernels.conv_int8.conv3x3_int8``: 3×3, stride 1
or 2, one pixel of zero or reflect padding or none (``"valid"``, an input
the caller padded, as the JAX package pads and then convolves VALID). The
arithmetic is the JAX
package's, step for step, because the rounding flips are the whole error
budget: ``torch.round`` rounds half to even as ``jnp.rint``/``jnp.round``
do; the dequantization is ``f32(acc) · (sx · sw)`` with the product of the
scales formed first, then ``+ bias`` in float32, then the cast.
"""

from __future__ import annotations

import torch

from ircolor_tpu_torch.kernels.conv_int8 import conv3x3_int8

# Smallest amax: keeps an all-zero tensor from producing an inf scale.
_AMAX_FLOOR = 1e-12
# Fixed clip of the post-IN+ReLU activations quantized on the fixed grid.
_QCLIP = 6.0


def quantize_weight_per_channel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(kh, kw, ci, co) float kernel → (int8 kernel, float32 scale[co])."""
    wf = w.float()
    amax = wf.abs().amax(dim=(0, 1, 2))
    scale = torch.clamp(amax, min=_AMAX_FLOOR) / 127.0
    wq = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return wq, scale


def quantize_dynamic(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """NHWC float tensor → (int8 tensor, float32 per-sample scale (B, 1, 1, 1)):
    symmetric, from each sample's own amax, so an image's result does not
    depend on what it is batched with."""
    xf = x.float()
    amax = xf.abs().amax(dim=(1, 2, 3), keepdim=True)
    scale = torch.clamp(amax, min=_AMAX_FLOOR) / 127.0
    xq = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return xq, scale


def _float_or_none(t):
    return None if t is None else t.float().contiguous()


def conv2d_int8(x, kernel, *, pad: str = "zero", stride: int = 1, bias=None, addend=None,
                out_dtype=None):
    """3×3 NHWC conv at ``stride`` (1 or 2) on int8 operands with one pixel
    of ``pad`` (``"zero"`` or ``"reflect"``) padding, or none
    (``"valid"``): per-sample dynamic activations, per-channel weights,
    int32 sums, dequantized in float32, then ``+ addend`` (a float32 term
    summed before the bias, as the second leg of a concat conv adds the
    first) and ``+ bias``, cast to ``out_dtype`` (default x's dtype)."""
    xq, sx = quantize_dynamic(x)
    wq, sw = quantize_weight_per_channel(kernel)
    sc = (sx.reshape(-1, 1) * sw[None, :]).contiguous()
    return conv3x3_int8(xq, wq, sc, pad=pad, stride=stride, bias=_float_or_none(bias),
                        addend=addend, out_dtype=out_dtype or x.dtype)


def quantize_fixed(x: torch.Tensor, clip: float = _QCLIP) -> torch.Tensor:
    """``clip(round(x · 127/clip), ±127)`` as int8: the fixed grid for
    IN + ReLU-derived inputs (values above ``clip`` saturate)."""
    return torch.clamp(torch.round(x.float() * (127.0 / clip)), -127, 127).to(torch.int8)


def conv2d_int8_fixed(x, kernel, *, clip: float = _QCLIP, pad: str = "zero", stride: int = 1,
                      bias=None, addend=None, out_dtype=None):
    """``conv2d_int8`` with the fixed input scale 127/``clip`` instead of
    the per-sample amax (no reduction over the input): for ≈6σ-bounded
    chains of IN + ReLU outputs, the decoder's up2 site."""
    wq, sw = quantize_weight_per_channel(kernel)
    sc = (sw * (clip / 127.0))[None, :].expand(x.shape[0], -1).contiguous()
    return conv3x3_int8(quantize_fixed(x, clip), wq, sc, pad=pad, stride=stride,
                        bias=_float_or_none(bias), addend=addend, out_dtype=out_dtype or x.dtype)
