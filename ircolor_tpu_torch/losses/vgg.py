"""VGG-16 perceptual feature tower through relu3_3 (``ircolor_tpu/losses/vgg.py``).

torchvision's ``vgg16().features[:16]`` (convs at 0, 2, 5, 7, 10, 12, 14;
two 2×2 max pools), frozen, with the same parameter names, so a torchvision
``vgg16`` state_dict loads directly (``load_vgg16_pth``). Inputs are NHWC
images in [−1, 1], mapped to [0, 1] and ImageNet-normalized in their own
dtype; the convs run in the compute dtype. Spatial training runs it on
H-shards (``forward_spatial``).

Without a weights file the tower is a deterministic random one: flax's
``Conv`` default init (lecun-normal, a normal of variance 1/fan_in truncated
at two standard deviations; zero biases) drawn from a ``torch.Generator``
seeded with ``seed`` — the JAX package's fallback distribution, not its
numbers.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ircolor_tpu_torch.ops.layout import to_nchw, to_nhwc
from ircolor_tpu_torch.parallel.spatial import sharded, window_slabs

# (name, out_channels); None entries are 2×2 stride-2 max pools.
VGG16_PLAN: tuple[tuple[str, int | None], ...] = (
    ("conv1_1", 64),
    ("conv1_2", 64),
    ("pool1", None),
    ("conv2_1", 128),
    ("conv2_2", 128),
    ("pool2", None),
    ("conv3_1", 256),
    ("conv3_2", 256),
    ("conv3_3", 256),
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# The std of a unit normal truncated to [−2, 2] (flax's variance_scaling).
_TRUNC_STD = 0.87962566103423978


class VGG16Features(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        layers: list[nn.Module] = []
        cin = 3
        for _name, ch in VGG16_PLAN:
            if ch is None:
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU(True)]
                cin = ch
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)

    def init_lecun_normal(self, gen: torch.Generator) -> None:
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                std = math.sqrt(1.0 / (m.in_channels * 9)) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC [−1, 1] → relu3_3 features, NHWC, compute dtype; a list of
        H-shards goes to ``forward_spatial``."""
        if sharded(x):
            return self.forward_spatial(x)
        mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
        h = to_nchw(((x + 1.0) / 2.0 - mean) / std)
        for layer in self.features:
            if isinstance(layer, nn.Conv2d):
                h = F.conv2d(h.to(self.dtype), layer.weight.to(self.dtype),
                             layer.bias.to(self.dtype), padding=1)
            elif isinstance(layer, nn.MaxPool2d):
                h = F.max_pool2d(h, 2, 2)
            else:
                h = torch.relu(h)
        return to_nhwc(h)


    def forward_spatial(self, xs: list) -> list:
        """The forward on the H-shards ``xs`` of the images (spatial
        training): each 3×3 conv on its shard's slab with one zero-padded
        halo row above and below, each 2×2 floor-mode pool on the rows whose
        window starts in the shard (``parallel.spatial.window_slabs``: a
        window that straddles two shards belongs to the upper one, which
        reads the lower one's first row; a shard may keep none). Returns
        the relu3_3 features' shards."""
        h = []
        for x in xs:
            mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
            std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
            h.append(((x + 1.0) / 2.0 - mean) / std)
        for layer in self.features:
            if isinstance(layer, nn.Conv2d):
                slabs = window_slabs([t.to(self.dtype) for t in h], 3, 1, 1)
                h = [t.new_zeros((t.shape[0], 0, t.shape[2], layer.out_channels), dtype=self.dtype)
                     if slab is None else
                     to_nhwc(F.conv2d(to_nchw(slab), layer.weight.to(slab.device, self.dtype),
                                      layer.bias.to(slab.device, self.dtype), padding=(0, 1)))
                     for t, slab in zip(h, slabs)]
            elif isinstance(layer, nn.MaxPool2d):
                h = [t.new_zeros((t.shape[0], 0, t.shape[2] // 2, t.shape[3]))
                     if slab is None else to_nhwc(F.max_pool2d(to_nchw(slab), 2, 2))
                     for t, slab in zip(h, window_slabs(h, 2, 2, 0))]
            else:
                h = [torch.relu(t) for t in h]
        return h


def load_vgg16_pth(path: str) -> dict[str, torch.Tensor]:
    """The tower's entries (``features.{0,2,5,7,10,12,14}``) of a torchvision
    ``vgg16`` state_dict file (a ``{'state_dict': ...}`` wrapper is
    unwrapped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    own = VGG16Features().state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{path}: not a torchvision vgg16 state_dict (missing {missing[:3]})")
    return {k: sd[k].float() for k in own}


def load_vgg16(path: str | None, seed: int = 0, dtype: torch.dtype = torch.float32) -> VGG16Features:
    """The frozen tower: weights from a torchvision ``.pth``, else the
    seeded lecun-normal fallback."""
    vgg = VGG16Features(dtype)
    if path is None:
        vgg.init_lecun_normal(torch.Generator().manual_seed(seed))
    else:
        vgg.load_state_dict(load_vgg16_pth(path))
    return vgg
