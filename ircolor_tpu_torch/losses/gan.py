"""Hinge adversarial losses (``ircolor_tpu/losses/gan.py``), in float32:

  L_D = 0.5 · ( E[relu(1 − D(real))] + E[relu(1 + D(fake))] )
  L_G = −E[D(fake)]

over all patches of the PatchGAN score maps and the batch. The score maps
may be lists of H-shards (spatial training): each mean is then the shards'
sums over the whole map's count, and an empty shard adds nothing."""

from __future__ import annotations

import torch

from ircolor_tpu_torch.parallel.spatial import global_mean, on_shards


def hinge_d_loss(pred_real, pred_fake) -> torch.Tensor:
    loss_real = global_mean(on_shards(lambda p: torch.relu(1.0 - p.float()), pred_real))
    loss_fake = global_mean(on_shards(lambda p: torch.relu(1.0 + p.float()), pred_fake))
    return 0.5 * (loss_real + loss_fake)


def hinge_g_loss(pred_fake) -> torch.Tensor:
    return -global_mean(on_shards(lambda p: p.float(), pred_fake))
