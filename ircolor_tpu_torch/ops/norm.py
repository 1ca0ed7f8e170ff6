"""Instance normalization of NHWC tensors (``ircolor_tpu/ops/norm.py``).

``nn.InstanceNorm2d`` defaults: no affine parameters, biased variance,
eps 1e-5, statistics in float32 whatever the compute dtype. The f32 parity
path uses two-pass statistics; the bf16 path the one-pass E[x²]−μ² form,
whose moments are also what the normalize-on-load kernels consume.
The ``_spatial`` forms normalize an image held as a list of H-shards, or
as a grid of tiles (``parallel/spatial.py``), by its global statistics: the
per-shard (per-tile) sums are added across shards in shard (tile) order.
"""

from __future__ import annotations

import torch

from ircolor_tpu_torch.parallel.spatial import all_sum, regrid, tiled, tiles


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


def _pixels(xs) -> int:
    return sum(x.shape[1] * x.shape[2] for x in xs)


def instance_norm_spatial(xs, eps: float = 1e-5) -> list:
    """``instance_norm`` of the image whose H-shards (or tiles) are ``xs``:
    two passes over the shards, the global mean, then the global centred
    sum of squares."""
    if tiled(xs):
        return regrid(instance_norm_spatial(tiles(xs), eps), xs)
    n = _pixels(xs)
    x32 = [x.float() for x in xs]
    means = [s / n for s in all_sum([x.sum(dim=(1, 2), keepdim=True) for x in x32])]
    var = [s / n for s in all_sum([(x - m).square().sum(dim=(1, 2), keepdim=True)
                                   for x, m in zip(x32, means)])]
    return [((x - m) * torch.rsqrt(v + eps)).to(xs[0].dtype) for x, m, v in zip(x32, means, var)]


def instance_norm_stats_spatial(xs, eps: float = 1e-5) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``instance_norm_stats`` of the image whose H-shards are ``xs``, one
    (mean, inv_std) per shard on its device: one pass, Σx and Σx² added
    across shards (a grid's tiles: one a tile, in ``tiles`` order)."""
    xs = tiles(xs)
    n = _pixels(xs)
    sums = all_sum([torch.stack([x.float().sum(dim=(1, 2)), x.float().square().sum(dim=(1, 2))])
                    for x in xs])
    out = []
    for s in sums:
        mean, meansq = s[0] / n, s[1] / n
        out.append((mean, torch.rsqrt(torch.clamp(meansq - mean.square(), min=0.0) + eps)))
    return out


def instance_norm_onepass_spatial(xs, eps: float = 1e-5) -> list:
    return regrid([((x.float() - m[:, None, None, :]) * i[:, None, None, :]).to(x.dtype)
                   for x, (m, i) in zip(tiles(xs), instance_norm_stats_spatial(xs, eps))], xs)
