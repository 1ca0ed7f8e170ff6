"""Differentiable SSIM (``ircolor_tpu/losses/ssim.py``): 11×11 Gaussian
window (σ 1.5) applied separably with zero "same" padding, C1 = 0.01²,
C2 = 0.03², loss ``1 − mean(ssim_map)``. Inputs are NHWC images in [0, 1];
the windows run as depthwise 1-D convolutions in the input's dtype."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.ops.filters import gaussian_window_1d
from ircolor_tpu_torch.parallel.spatial import global_sum, sharded, window_slabs


def _gauss_filter(x: torch.Tensor, window_size: int, pad_h: bool = True) -> torch.Tensor:
    """(B, C, H, W) ⊛ g⊗g with zero padding window_size // 2 (without
    ``pad_h``, none in H: ``x`` holds its halo rows, and the result is
    window_size − 1 rows shorter)."""
    c = x.shape[1]
    g = torch.from_numpy(gaussian_window_1d(window_size, 1.5)).to(x.device, x.dtype)
    half = window_size // 2
    x = F.conv2d(x, g.view(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(half if pad_h else 0, 0),
                 groups=c)
    return F.conv2d(x, g.view(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, half), groups=c)


def _ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int,
              pad_h: bool = True) -> torch.Tensor:
    """The SSIM map of NCHW images (``_gauss_filter``'s ``pad_h``)."""
    mu1 = _gauss_filter(img1, window_size, pad_h)
    mu2 = _gauss_filter(img2, window_size, pad_h)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _gauss_filter(img1 * img1, window_size, pad_h) - mu1_sq
    sigma2_sq = _gauss_filter(img2 * img2, window_size, pad_h) - mu2_sq
    sigma12 = _gauss_filter(img1 * img2, window_size, pad_h) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )


def ssim_index(img1, img2, window_size: int = 11, size_average: bool = True) -> torch.Tensor:
    """Mean SSIM between NHWC [0, 1] images (per sample without
    ``size_average``). The images may be lists of H-shards (spatial
    training): each shard's map rows then come from its slab with
    window_size // 2 halo rows above and below (zero rows past the image's
    edges: the window's "same" padding), and the mean is the shards' sums
    over the whole map's count."""
    if sharded(img1):
        return _ssim_index_spatial(img1, img2, window_size, size_average)
    if img1.shape != img2.shape:
        raise ValueError("SSIM images must have the same shape")
    ssim_map = _ssim_map(img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2), window_size)
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def _ssim_index_spatial(img1: list, img2: list, window_size: int,
                        size_average: bool) -> torch.Tensor:
    if [x.shape for x in img1] != [x.shape for x in img2]:
        raise ValueError("SSIM images must have the same shards")
    half = window_size // 2
    sums = [_ssim_map(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2), window_size,
                      pad_h=False).sum(dim=(1, 2, 3))
            for a, b in zip(window_slabs(img1, window_size, 1, half),
                            window_slabs(img2, window_size, 1, half)) if a is not None]
    per_sample = global_sum(sums) / (sum(x.numel() for x in img1) // img1[0].shape[0])
    return per_sample.mean() if size_average else per_sample


def ssim_loss(img1, img2, window_size: int = 11, size_average: bool = True) -> torch.Tensor:
    return 1.0 - ssim_index(img1, img2, window_size, size_average)
