"""int8 quantization for the fused int8 resnet block (``ircolor_tpu/ops/quant.py``).

Weights are quantized symmetrically per output channel,
``w ≈ wq · scale[co]`` with ``scale = amax/127``; activations per sample
(conv1: dynamic 127/amax) or by the fixed 127/6σ grid (conv2, whose input
is instance-normalized and ReLU'd). Every quantized site feeds an instance
norm, which absorbs the scales exactly; the only error is rounding noise.

``torch.round`` rounds half to even, as ``jnp.rint``/``jnp.round`` do.

The XLA int8 route of the JAX package (``QuantConv``, ``conv2d_int8``,
``conv2d_int8_fixed``) is not ported yet: ``ROADMAP.md`` Queue 1.
"""

from __future__ import annotations

import torch

# Smallest amax: keeps an all-zero tensor from producing an inf scale.
_AMAX_FLOOR = 1e-12
# Fixed clip of the post-IN+ReLU activations that conv2 quantizes.
_QCLIP = 6.0


def quantize_weight_per_channel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(kh, kw, ci, co) float kernel → (int8 kernel, float32 scale[co])."""
    wf = w.float()
    amax = wf.abs().amax(dim=(0, 1, 2))
    scale = torch.clamp(amax, min=_AMAX_FLOOR) / 127.0
    wq = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return wq, scale


def xla_int8_route(*_args, **_kwargs):
    raise NotImplementedError(
        "the XLA int8 conv route (QuantConv / conv2d_int8) is not ported yet "
        "— ROADMAP.md Queue 1, item 'XLA QuantConv int8 route'. It runs only "
        "where int8 is on and neither the fused down-tail nor the fused head "
        "engages (e.g. batch 1 at 512×640); pass --no-quant-int8 there."
    )
