"""Image-quality metrics, batched on the device (``ircolor_tpu/eval/metrics.py``).

MAE, MSE, ``PSNR = −10·log10(mse + 1e-12)`` with inf at MSE 0, and the
scikit-image default SSIM (``data_range=1``, ``channel_axis=2``): a 7×7
uniform window, sample covariance (N/(N−1), N = 49), K1 = 0.01, K2 = 0.03,
the (win−1)//2 border crop (a VALID filter gives exactly the cropped
interior) and the mean over channels. Predictions are compared after the
uint8 round trip (``quantize_to_uint8_01``: clip, ×255, floor, ÷255).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def quantize_to_uint8_01(x01: torch.Tensor) -> torch.Tensor:
    return torch.floor(torch.clamp(x01, 0.0, 1.0) * 255.0) / 255.0


def _ssim_chfirst(pred: torch.Tensor, gt: torch.Tensor, win_size: int = 7,
                  k1: float = 0.01, k2: float = 0.03, data_range: float = 1.0) -> torch.Tensor:
    """(B, C, H, W) float32 → per-image SSIM (B,)."""
    np_pix = win_size * win_size
    cov_norm = np_pix / (np_pix - 1.0)

    def f(t):
        return F.avg_pool2d(t, win_size, stride=1)

    ux, uy = f(pred), f(gt)
    uxx, uyy, uxy = f(pred * pred), f(gt * gt), f(pred * gt)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2, 3))


def batched_metrics(pred01: torch.Tensor, gt01: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-image MAE/MSE/PSNR/SSIM over an NHWC batch (each (B,))."""
    p = pred01.float().permute(0, 3, 1, 2)
    g = gt01.float().permute(0, 3, 1, 2)
    diff = p - g
    mae = diff.abs().mean(dim=(1, 2, 3))
    mse = (diff * diff).mean(dim=(1, 2, 3))
    psnr = torch.where(mse == 0.0, torch.full_like(mse, math.inf), -10.0 * torch.log10(mse + 1e-12))
    return {"mae": mae, "mse": mse, "psnr": psnr, "ssim": _ssim_chfirst(p, g)}


def compute_metrics(pred_01: np.ndarray, gt_01: np.ndarray) -> tuple[float, float, float, float]:
    """Single-image host API (H, W, 3) float [0, 1] → (mae, mse, psnr, ssim)."""
    diff = pred_01.astype(np.float64) - gt_01.astype(np.float64)
    mae = float(np.mean(np.abs(diff)))
    mse = float(np.mean(diff**2))
    psnr = float("inf") if mse == 0 else -10.0 * math.log10(mse + 1e-12)
    ssim = float(
        _ssim_chfirst(
            torch.from_numpy(pred_01).float().permute(2, 0, 1)[None],
            torch.from_numpy(gt_01).float().permute(2, 0, 1)[None],
        )[0]
    )
    return mae, mse, psnr, ssim
