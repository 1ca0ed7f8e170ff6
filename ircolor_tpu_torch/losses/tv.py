"""Anisotropic (L1) total variation (``ircolor_tpu/losses/tv.py``): mean
|∂y| + mean |∂x| of neighbouring-pixel differences, NHWC input, or a list
of its H-shards (spatial training): each shard then differences its rows
and the first row of the next shard that has one (the seam), and both
means divide by the whole image's counts."""

from __future__ import annotations

import torch

from ircolor_tpu_torch.parallel.spatial import global_sum, sharded, window_slabs


def tv_loss(x) -> torch.Tensor:
    if sharded(x):
        return _tv_loss_spatial(x)
    diff_i = (x[:, 1:, :, :] - x[:, :-1, :, :]).abs().mean()
    diff_j = (x[:, :, 1:, :] - x[:, :, :-1, :]).abs().mean()
    return diff_i + diff_j


def _tv_loss_spatial(xs: list) -> torch.Tensor:
    b, w, c = xs[0].shape[0], xs[0].shape[2], xs[0].shape[3]
    h = sum(x.shape[1] for x in xs)
    rows = [(s[:, 1:] - s[:, :-1]).abs().sum() for s in window_slabs(xs, 2, 1, 0) if s is not None]
    cols = [(x[:, :, 1:] - x[:, :, :-1]).abs().sum() for x in xs]
    return global_sum(rows) / (b * (h - 1) * w * c) + global_sum(cols) / (b * h * (w - 1) * c)
