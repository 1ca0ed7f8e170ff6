"""Anisotropic (L1) total variation (``ircolor_tpu/losses/tv.py``): mean
|∂y| + mean |∂x| of neighbouring-pixel differences, NHWC input."""

from __future__ import annotations

import torch


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    diff_i = (x[:, 1:, :, :] - x[:, :-1, :, :]).abs().mean()
    diff_j = (x[:, :, 1:, :] - x[:, :, :-1, :]).abs().mean()
    return diff_i + diff_j
