"""Spatial padding of NHWC tensors (``ircolor_tpu/ops/padding.py``).

PyTorch reflection padding excludes the edge pixel; replication repeats it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.ops.layout import to_nchw, to_nhwc

_PAD_MODES = {"reflect": "reflect", "replicate": "replicate", "zero": "constant"}


def pad2d(
    x: torch.Tensor,
    pad: int | tuple[int, int, int, int],
    pad_type: str = "reflect",
) -> torch.Tensor:
    """Pad an NHWC tensor spatially; ``pad`` is one int or PyTorch-order
    ``(left, right, top, bottom)``."""
    if pad_type not in _PAD_MODES:
        raise NotImplementedError(f"pad type [{pad_type}] not implemented")
    if isinstance(pad, int):
        pad = (pad, pad, pad, pad)
    return to_nhwc(F.pad(to_nchw(x), tuple(pad), mode=_PAD_MODES[pad_type]))


def reflect_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    return pad2d(x, pad, "reflect")
