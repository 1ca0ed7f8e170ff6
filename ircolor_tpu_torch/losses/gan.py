"""Hinge adversarial losses (``ircolor_tpu/losses/gan.py``), in float32:

  L_D = 0.5 · ( E[relu(1 − D(real))] + E[relu(1 + D(fake))] )
  L_G = −E[D(fake)]

over all patches of the PatchGAN score maps and the batch."""

from __future__ import annotations

import torch


def hinge_d_loss(pred_real: torch.Tensor, pred_fake: torch.Tensor) -> torch.Tensor:
    loss_real = torch.relu(1.0 - pred_real.float()).mean()
    loss_fake = torch.relu(1.0 + pred_fake.float()).mean()
    return 0.5 * (loss_real + loss_fake)


def hinge_g_loss(pred_fake: torch.Tensor) -> torch.Tensor:
    return -pred_fake.float().mean()
