"""Spatial padding of NHWC tensors (``ircolor_tpu/ops/padding.py``).

PyTorch reflection padding excludes the edge pixel; replication repeats it.
``pad2d_spatial`` pads a list of H-shards (``parallel/spatial.py``): the
rows from the neighbour shards, the image's own padding at its edges; or
a grid of tiles, whose columns come from the neighbour tiles too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.ops.layout import to_nchw, to_nhwc
from ircolor_tpu_torch.parallel.spatial import halo_slabs, tiled

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


def _pad_w(x: torch.Tensor, r: int, pad_type: str) -> torch.Tensor:
    """``r`` columns of ``pad_type`` padding on each side of NHWC ``x``,
    in any dtype (the int8 slabs too): copies, as ``F.pad`` makes them."""
    w = x.shape[2]
    if pad_type == "zero":
        return F.pad(x, (0, 0, r, r))
    i = torch.arange(-r, w + r, device=x.device)
    if pad_type == "reflect":
        i = i.abs()
        i = torch.where(i >= w, 2 * w - 2 - i, i)
    else:
        i = i.clamp(0, w - 1)
    return x.index_select(2, i)


def pad2d_spatial(xs, r: int, pad_type: str = "reflect") -> list:
    """``pad2d(x, r, pad_type)`` of the image whose H-shards are ``xs``,
    per shard: (B, h + 2r, W + 2r, C) slabs, each holding its neighbours'
    ``r`` edge rows (``pad_type`` rows at the image's top and bottom). Of a
    grid of tiles: per tile (B, h + 2r, w + 2r, C), its neighbours' edge
    rows, columns and corners (``pad_type`` at the image's edges), in the
    grid's shape."""
    if pad_type not in _PAD_MODES:
        raise NotImplementedError(f"pad type [{pad_type}] not implemented")
    if tiled(xs):
        return halo_slabs(xs, r, pad_type)
    return [_pad_w(s, r, pad_type) for s in halo_slabs(xs, r, pad_type)]
