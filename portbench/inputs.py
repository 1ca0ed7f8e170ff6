"""What a run makes from its seed: the networks' weights and the frames.

Weights follow the reference's init (``init_weights``: N(0, 0.02) kernels,
zero biases) for G and D, and lecun-normal (variance 1/fan_in, zero biases)
for the random VGG tower that stands in for ImageNet's; they are drawn on
the device from one ``torch.Generator`` in one call, and named as the
reference's state dict names them, so the same dict loads into the
measured program and into the reference. The same seed on the same device
gives the same numbers.

Frames are the pattern of the repository's synthetic KAIST frames (smooth
gradients, a warm blob, a little sensor noise) with the visible frame a
fixed colormap of the IR; each frame has an IR level and contrast and a
visible brightness of its own, as a day's and a night's frames differ, so
the images of a batch weigh differently in its losses. They are made on the device in a few calls and kept as
the integer transport (uint16 IR, uint8 RGB, NHWC) in pinned host memory,
from where the window uploads them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_SEED_MASK = (1 << 63) - 1
_INIT_GAIN = 0.02


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of the seed's draws
    (0: weights, 1: frames)."""
    return torch.Generator(device=device).manual_seed((2 * int(seed) + stream) & _SEED_MASK)


def weight_specs(nets: dict[str, torch.nn.Module]) -> list[tuple[str, str, tuple, float]]:
    """(net, name, shape, std) of every parameter of the reference's
    ``nets`` ({"g": ..., "d": ..., "vgg": ...}); std 0 is a zero bias."""
    specs = []
    for key, net in nets.items():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                std = 0.0
            elif key == "vgg":
                std = 1.0 / math.sqrt(p.shape[1] * p.shape[2] * p.shape[3])
            else:
                std = _INIT_GAIN
            specs.append((key, name, tuple(p.shape), std))
    return specs


def make_weights(specs, seed: int, device) -> dict[str, dict[str, torch.Tensor]]:
    """{net: {name: float32 tensor}} on ``device`` from one draw."""
    sizes = [math.prod(shape) for _, _, shape, std in specs if std > 0]
    flat = torch.randn(sum(sizes), generator=generator(seed, 0, device), device=device)
    out: dict[str, dict[str, torch.Tensor]] = {}
    at = 0
    for key, name, shape, std in specs:
        if std > 0:
            n = math.prod(shape)
            t = flat[at:at + n].view(shape) * std
            at += n
        else:
            t = torch.zeros(shape, device=device)
        out.setdefault(key, {})[name] = t
    return out


def make_frames(seed: int, n_batches: int, batch: int, hw: tuple[int, int], device,
                pin: bool = True) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``n_batches`` batches of (uint16 IR (B, H, W, 1), uint8 RGB (B, H, W, 3)),
    every frame distinct, on the host (pinned where ``pin``)."""
    h, w = hw
    n = n_batches * batch
    gen = generator(seed, 1, device)
    phase = torch.rand(n, 1, 1, generator=gen, device=device) * (2 * math.pi)
    cx = torch.rand(n, 1, 1, generator=gen, device=device) * w
    cy = torch.rand(n, 1, 1, generator=gen, device=device) * h
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w)
    span = 0.3 + 0.4 * torch.rand(n, 1, 1, generator=gen, device=device)
    low = (1.0 - span) * torch.rand(n, 1, 1, generator=gen, device=device)
    f = 0.5 + 0.4 * torch.sin(xx / w * 4 * math.pi + phase) * torch.cos(yy / h * 2 * math.pi)
    f = f + 0.5 * torch.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * (h / 4) ** 2))
    f = low + span * (f - 0.1) / 1.3
    f = (f + 0.01 * torch.randn(n, h, w, generator=gen, device=device)).clamp(0.0, 1.0)
    ir = torch.round(f * 65535.0).to(torch.int32)
    light = 0.4 + 0.6 * torch.rand(n, 1, 1, 1, generator=gen, device=device)
    rgb = light * torch.stack([(1.5 * f - 0.2).clamp(0, 1), (1 - (f - 0.5).abs() * 2).clamp(0, 1),
                               (0.9 - f).clamp(0, 1)], dim=-1)
    rgb = torch.round(rgb * 255.0).to(torch.uint8)
    ir_np = ir.cpu().numpy().astype(np.uint16).reshape(n_batches, batch, h, w, 1)
    rgb_np = rgb.cpu().numpy().reshape(n_batches, batch, h, w, 3)
    out = []
    for i in range(n_batches):
        a, b = torch.from_numpy(ir_np[i]), torch.from_numpy(rgb_np[i])
        out.append((a.pin_memory(), b.pin_memory()) if pin else (a, b))
    return out
