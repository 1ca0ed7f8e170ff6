"""The reference's losses and test metrics (``Code/ir_colorization.py``),
plain torch on NCHW float32:

  hinge GAN (1645-1662)  L_D = 0.5 (E[relu(1 - D(real))] + E[relu(1 + D(fake))]),
                         L_G,gan = -E[D(fake)]
  tv_loss (686-694)      mean |dy| + mean |dx|
  ssim_loss (699-750)    1 - mean SSIM map: 11x11 Gaussian window (sigma 1.5),
                         zero "same" padding, C1 = 0.01^2, C2 = 0.03^2
  compute_metrics (1184-1217) on the uint8 round trip of the prediction:
                         MAE, MSE, PSNR = -10 log10(MSE + 1e-12) (inf at 0),
                         scikit-image's default SSIM (data_range 1, a 7x7
                         uniform window, sample covariance, the border crop,
                         the mean over channels)
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def hinge_d(pred_real: torch.Tensor, pred_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - pred_real).mean() + F.relu(1.0 + pred_fake).mean())


def hinge_g(pred_fake: torch.Tensor) -> torch.Tensor:
    return -pred_fake.mean()


def tv(x: torch.Tensor) -> torch.Tensor:
    return ((x[:, :, 1:] - x[:, :, :-1]).abs().mean()
            + (x[:, :, :, 1:] - x[:, :, :, :-1]).abs().mean())


def _gauss_window(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float64) - (size - 1) / 2.0
    g = torch.exp(-coords**2 / (2.0 * sigma**2))
    g = (g / g.sum()).float()
    return (g[:, None] * g[None, :]).to(device)


def ssim_loss(a: torch.Tensor, b: torch.Tensor, size: int = 11) -> torch.Tensor:
    """1 - mean SSIM of [0, 1] images, the 2-D Gaussian window as one
    depthwise conv."""
    c = a.shape[1]
    win = _gauss_window(size, device=a.device).expand(c, 1, size, size)

    def f(t):
        return F.conv2d(t, win, padding=size // 2, groups=c)

    mu1, mu2 = f(a), f(b)
    s11 = f(a * a) - mu1 * mu1
    s22 = f(b * b) - mu2 * mu2
    s12 = f(a * b) - mu1 * mu2
    c1, c2 = 0.01**2, 0.03**2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return 1.0 - m.mean()


def to_uint8_grid(x01: torch.Tensor) -> torch.Tensor:
    """The test mode's round trip: clip to [0, 1], x255, floor, /255."""
    return torch.floor(x01.clamp(0.0, 1.0) * 255.0) / 255.0


def metrics(pred01: torch.Tensor, gt01: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-image MAE, MSE, PSNR, SSIM of NCHW [0, 1] images, in float64."""
    p, g = pred01.double(), gt01.double()
    d = p - g
    mae = d.abs().mean(dim=(1, 2, 3))
    mse = (d * d).mean(dim=(1, 2, 3))
    psnr = torch.where(mse == 0, torch.full_like(mse, math.inf), -10.0 * torch.log10(mse + 1e-12))
    n = 7
    cov = n * n / (n * n - 1.0)

    def f(t):
        return F.avg_pool2d(t, n, stride=1)

    ux, uy = f(p), f(g)
    vx = cov * (f(p * p) - ux * ux)
    vy = cov * (f(g * g) - uy * uy)
    vxy = cov * (f(p * g) - ux * uy)
    c1, c2 = 0.01**2, 0.03**2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return {"mae": mae, "mse": mse, "psnr": psnr, "ssim": s.mean(dim=(1, 2, 3))}
