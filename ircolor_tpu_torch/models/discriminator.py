"""PatchGAN discriminator (``ircolor_tpu/models/discriminator.py``).

At input_nc=4 (IR 1 ch ⊕ RGB 3 ch), ndf=64, n_layers=3:

  model.0   4×4 conv s2   4→64  + LeakyReLU(0.2)        (no norm, bias on)
  model.2   4×4 conv s2  64→128 + IN + LeakyReLU(0.2)
  model.5   4×4 conv s2 128→256 + IN + LeakyReLU(0.2)
  model.8   4×4 conv s1 256→512 + IN + LeakyReLU(0.2)
  model.11  4×4 conv s1 512→1                           (patch score map)

All convs pad 1. ``norm``: instance norm without affine parameters (the
default), ``batch`` (``models.common.BatchNorm`` at ``model.3``, ``.6``,
``.9``, convs without bias) or ``none``. Activations are NHWC like the
generator's; the ``nn.Sequential`` gives the parameters the reference
state_dict names, and ``forward`` applies its members itself in the
compute dtype (plain cuDNN convs on the card). Spatial training runs it
on H-shards (``forward_spatial``), as GSPMD partitions the JAX one.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ircolor_tpu_torch.models.common import (
    apply_norm,
    conv_nhwc,
    conv_nhwc_window_spatial,
    init_module_,
    make_norm,
    norm_nhwc_spatial,
    use_bias_for_norm,
)
from ircolor_tpu_torch.parallel.spatial import sharded


class NLayerDiscriminator(nn.Module):
    def __init__(
        self,
        input_nc: int = 4,
        ndf: int = 64,
        n_layers: int = 3,
        *,
        norm: str = "instance",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        use_bias = use_bias_for_norm(norm)
        self.dtype = dtype
        layers: list[nn.Module] = [
            nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1), nn.LeakyReLU(0.2, True)
        ]
        nf_mult = 1
        for n in range(1, n_layers):
            nf_prev, nf_mult = nf_mult, min(2**n, 8)
            layers += [
                nn.Conv2d(ndf * nf_prev, ndf * nf_mult, 4, stride=2, padding=1, bias=use_bias),
                make_norm(norm, ndf * nf_mult),
                nn.LeakyReLU(0.2, True),
            ]
        nf_prev, nf_mult = nf_mult, min(2**n_layers, 8)
        layers += [
            nn.Conv2d(ndf * nf_prev, ndf * nf_mult, 4, stride=1, padding=1, bias=use_bias),
            make_norm(norm, ndf * nf_mult),
            nn.LeakyReLU(0.2, True),
            nn.Conv2d(ndf * nf_mult, 1, 4, stride=1, padding=1),
        ]
        self.model = nn.Sequential(*layers)

    def init_weights(self, init_type: str, gain: float, gen: torch.Generator) -> None:
        init_module_(self, init_type, gain, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, input_nc) → (B, H', W', 1) patch scores, compute dtype;
        a list of H-shards goes to ``forward_spatial``."""
        if sharded(x):
            return self.forward_spatial(x)
        h = x
        for layer in self.model:
            if isinstance(layer, nn.Conv2d):
                h = conv_nhwc(layer, h, self.dtype)
            elif isinstance(layer, nn.LeakyReLU):
                h = F.leaky_relu(h, 0.2)
            else:
                h = apply_norm(layer, h)
        return h

    def forward_spatial(self, xs: list) -> list:
        """The forward on the H-shards ``xs`` of the input (spatial
        training): each conv on its shards' slabs of input rows
        (``models.common.conv_nhwc_window_spatial``: one halo row above and
        below at stride 2, one above and two below at stride 1, zero rows
        past the image's edges), the instance norms by the whole image's
        statistics (``norm_nhwc_spatial``). Returns the score map's shards,
        which may be empty: the stride-1 convs each take a row off the
        image. Batch norm is not ported under ``sp_devices`` (ROADMAP.md)."""
        h = list(xs)
        for layer in self.model:
            if isinstance(layer, nn.Conv2d):
                h = conv_nhwc_window_spatial(layer, h, self.dtype)
            elif isinstance(layer, nn.LeakyReLU):
                h = [F.leaky_relu(t, 0.2) for t in h]
            elif isinstance(layer, nn.InstanceNorm2d):
                h = norm_nhwc_spatial(h)
            elif not isinstance(layer, nn.Identity):
                raise NotImplementedError(f"the discriminator's {type(layer).__name__} under "
                                          "sp_devices > 1 is not ported yet (ROADMAP.md, Queue 1)")
        return h
