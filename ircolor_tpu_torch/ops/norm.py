"""Instance normalization of NHWC tensors (``ircolor_tpu/ops/norm.py``).

``nn.InstanceNorm2d`` defaults: no affine parameters, biased variance,
eps 1e-5, statistics in float32 whatever the compute dtype. The f32 parity
path uses two-pass statistics; the bf16 path the one-pass E[x²]−μ² form,
whose moments are also what the normalize-on-load kernels consume.
"""

from __future__ import annotations

import torch


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Two-pass per-sample, per-channel spatial normalization."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def instance_norm_stats(
    x: torch.Tensor, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat (B, C) float32 ``(mean, inv_std)`` from single-pass moments."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2))
    meansq = x32.square().mean(dim=(1, 2))
    var = torch.clamp(meansq - mean.square(), min=0.0)
    return mean, torch.rsqrt(var + eps)


def instance_norm_onepass(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean, inv = instance_norm_stats(x, eps)
    y = (x.float() - mean[:, None, None, :]) * inv[:, None, None, :]
    return y.to(x.dtype)


def instance_norm_vjp(g: torch.Tensor, yhat: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """VJP of y → (y − mean(y))·inv(y) over the spatial axes per (b, c), at
    cotangent g with ŷ the normalized value: inv·(g − E[g] − ŷ·E[g·ŷ]), eps
    folded into inv (``pallas_resblock._in_bwd`` of the JAX package)."""
    gm = g.mean(dim=(1, 2), keepdim=True)
    gy = (g * yhat).mean(dim=(1, 2), keepdim=True)
    return inv.float()[:, None, None, :] * (g - gm - yhat * gy)
