"""The plain reference of the colorization networks, written from the
reference repository's layer equations (yavuzmurattas/Infrared-Colorization-
with-ResNet-Generator-and-PatchGAN, ``Code/ir_colorization.py``):

  ResnetUNetGenerator (425-569)
    inc     ReflectionPad2d(3), Conv 7x7 1->ngf, InstanceNorm, ReLU
    down1   Conv 3x3 pad 1 ngf->2ngf, IN, ReLU, then Downsample: reflect pad
            1, depthwise [1,2,1]x[1,2,1]/16 blur at stride 2
    down2   the same, 2ngf->4ngf
    blocks  n x [ReflectionPad 1, Conv 3x3, IN, ReLU, ReflectionPad 1,
            Conv 3x3, IN] + x
    up1     UpsampleAA (bilinear x2, align_corners=True, then reflect pad 1
            and the stride-1 blur), concat [up, x1], Conv 3x3 pad 1
            6ngf->2ngf, IN, ReLU
    up2     the same with x0, 3ngf->ngf
    outc    ReflectionPad2d(3), Conv 7x7 ngf->3, tanh
  NLayerDiscriminator (576-635), n_layers 3: Conv 4x4 s2 + LeakyReLU(0.2);
    two Conv 4x4 s2 + IN + LeakyReLU; Conv 4x4 s1 + IN + LeakyReLU; Conv 4x4
    s1 -> 1 channel; every conv pads 1.
  VGGPerceptual (642-683): VGG-16 features[:16] (through relu3_3) on the
    ImageNet-normalized [0, 1] image.

NCHW, float32; the state-dict names are the reference's, so one dict of
weights loads into these modules and into the measured program's. The
instance norms are ``nn.InstanceNorm2d``'s defaults (no affine parameters,
biased variance, eps 1e-5).

``conv`` is the one place a convolution runs: ``quant`` (None, or a
callable taking (input, weight) and returning the pair to convolve) lets the
benchmark's control compute the same network in a lower precision. This
module imports nothing but torch.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

_BLUR_1D = (1.0, 2.0, 1.0)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def conv(x: torch.Tensor, layer: nn.Conv2d, quant=None, **kw) -> torch.Tensor:
    """``layer`` applied to ``x`` by ``F.conv2d`` with ``kw`` (stride,
    padding); ``quant`` rounds the input and weight first."""
    w = layer.weight
    if quant is not None:
        x, w = quant(x, w)
    return F.conv2d(x, w, layer.bias, **kw)


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    return F.instance_norm(x, eps=1e-5)


def _blur(x: torch.Tensor, stride: int) -> torch.Tensor:
    a = torch.tensor(_BLUR_1D, dtype=x.dtype, device=x.device)
    k = (a[:, None] * a[None, :]) / 16.0
    c = x.shape[1]
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"),
                    k.expand(c, 1, 3, 3), stride=stride, groups=c)


def downsample(x: torch.Tensor) -> torch.Tensor:
    """The anti-aliased /2: reflect pad 1, binomial blur at stride 2."""
    return _blur(x, 2)


def upsample_aa(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """The anti-aliased x2: bilinear (align_corners) to twice the plane,
    reflect pad 1, binomial blur at stride 1; then the reference's
    bilinear fix-up to the skip's plane where the two differ."""
    h, w = x.shape[2:]
    y = _blur(F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear", align_corners=True), 1)
    if tuple(y.shape[2:]) != tuple(size):
        y = F.interpolate(y, size=size, mode="bilinear", align_corners=True)
    return y


class ResnetBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), nn.InstanceNorm2d(dim), nn.ReLU(True),
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), nn.InstanceNorm2d(dim),
        )

    def forward(self, x: torch.Tensor, quant=None) -> torch.Tensor:
        h = F.relu(instance_norm(conv(F.pad(x, (1, 1, 1, 1), mode="reflect"),
                                      self.conv_block[1], quant)))
        return x + instance_norm(conv(F.pad(h, (1, 1, 1, 1), mode="reflect"),
                                      self.conv_block[5], quant))


# The generator's conv sites: the 7x7 stem, the two down convs, the 18 block
# convs, the two up convs, the 7x7 head. A control rounds those its cell's
# route runs in the lower precision (a serving mix's ``int8_sites``);
# training's control rounds the 3x3 convs.
SITES = ("inc", "down", "blocks", "up", "outc")
ROUNDED_SITES = ("down", "blocks", "up")


class Generator(nn.Module):
    """``ResnetUNetGenerator`` with instance norm, reflect padding, no
    dropout, the anti-aliased down and up paths."""

    def __init__(self, input_nc: int = 1, output_nc: int = 3, ngf: int = 64, n_blocks: int = 9):
        super().__init__()
        self.inc = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(input_nc, ngf, 7),
                                 nn.InstanceNorm2d(ngf), nn.ReLU(True))
        self.down1 = nn.Sequential(nn.Conv2d(ngf, 2 * ngf, 3, padding=1),
                                   nn.InstanceNorm2d(2 * ngf), nn.ReLU(True))
        self.down2 = nn.Sequential(nn.Conv2d(2 * ngf, 4 * ngf, 3, padding=1),
                                   nn.InstanceNorm2d(4 * ngf), nn.ReLU(True))
        self.resblocks = nn.Sequential(*[ResnetBlock(4 * ngf) for _ in range(n_blocks)])
        self.up1_conv = nn.Sequential(nn.Conv2d(6 * ngf, 2 * ngf, 3, padding=1),
                                      nn.InstanceNorm2d(2 * ngf), nn.ReLU(True))
        self.up2_conv = nn.Sequential(nn.Conv2d(3 * ngf, ngf, 3, padding=1),
                                      nn.InstanceNorm2d(ngf), nn.ReLU(True))
        self.outc = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7), nn.Tanh())

    def forward(self, x: torch.Tensor, quant=None, sites=ROUNDED_SITES) -> torch.Tensor:
        """IR (B, 1, H, W) in [-1, 1] -> RGB (B, 3, H, W) in [-1, 1].
        ``quant`` rounds the convs of ``sites`` (of ``SITES``) and no
        other."""
        def at(site):
            return quant if site in sites else None

        x0 = F.relu(instance_norm(conv(F.pad(x, (3, 3, 3, 3), mode="reflect"), self.inc[1],
                                       at("inc"))))
        x1 = downsample(F.relu(instance_norm(conv(x0, self.down1[0], at("down"), padding=1))))
        x2 = downsample(F.relu(instance_norm(conv(x1, self.down2[0], at("down"), padding=1))))
        h = x2
        for block in self.resblocks:
            h = block(h, at("blocks"))
        y = torch.cat([upsample_aa(h, x1.shape[2:]), x1], dim=1)
        y = F.relu(instance_norm(conv(y, self.up1_conv[0], at("up"), padding=1)))
        y = torch.cat([upsample_aa(y, x0.shape[2:]), x0], dim=1)
        y = F.relu(instance_norm(conv(y, self.up2_conv[0], at("up"), padding=1)))
        return torch.tanh(conv(F.pad(y, (3, 3, 3, 3), mode="reflect"), self.outc[1], at("outc")))


class Discriminator(nn.Module):
    """``NLayerDiscriminator`` at n_layers 3 with instance norm."""

    def __init__(self, input_nc: int = 4, ndf: int = 64):
        super().__init__()
        self.model = nn.Sequential(
            nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2, True),
            nn.Conv2d(ndf, 2 * ndf, 4, 2, 1), nn.InstanceNorm2d(2 * ndf), nn.LeakyReLU(0.2, True),
            nn.Conv2d(2 * ndf, 4 * ndf, 4, 2, 1), nn.InstanceNorm2d(4 * ndf),
            nn.LeakyReLU(0.2, True),
            nn.Conv2d(4 * ndf, 8 * ndf, 4, 1, 1), nn.InstanceNorm2d(8 * ndf),
            nn.LeakyReLU(0.2, True),
            nn.Conv2d(8 * ndf, 1, 4, 1, 1),
        )

    def forward(self, x: torch.Tensor, quant=None) -> torch.Tensor:
        m = self.model
        h = F.leaky_relu(conv(x, m[0], quant, stride=2, padding=1), 0.2)
        for i, stride in ((2, 2), (5, 2), (8, 1)):
            h = F.leaky_relu(instance_norm(conv(h, m[i], quant, stride=stride, padding=1)), 0.2)
        return conv(h, m[11], quant, stride=1, padding=1)


# VGG-16 features[:16]: (index, in, out) of each 3x3 conv; pools after 2 and 7.
VGG_CONVS = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
             (12, 256, 256), (14, 256, 256))
_VGG_POOL_AFTER = (2, 7)


class VGGFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        layers: dict[str, nn.Module] = {str(i): nn.Conv2d(cin, cout, 3, padding=1)
                                        for i, cin, cout in VGG_CONVS}
        self.features = nn.ModuleDict(layers)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, quant=None) -> torch.Tensor:
        """[-1, 1] RGB (B, 3, H, W) -> relu3_3 features."""
        mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
        h = ((x + 1.0) / 2.0 - mean) / std
        for i, _, _ in VGG_CONVS:
            h = F.relu(conv(h, self.features[str(i)], quant, padding=1))
            if i in _VGG_POOL_AFTER:
                h = F.max_pool2d(h, 2, 2)
        return h


def networks(model: dict, device="meta") -> dict[str, nn.Module]:
    """G, D and the VGG tower at a configuration's widths (its ``model``
    entry), on ``device`` (meta: shapes alone)."""
    with torch.device(device):
        return {"g": Generator(model["input_nc"], model["output_nc"], model["ngf"],
                               model["n_blocks"]),
                "d": Discriminator(model["input_nc"] + model["output_nc"], model["ndf"]),
                "vgg": VGGFeatures()}
