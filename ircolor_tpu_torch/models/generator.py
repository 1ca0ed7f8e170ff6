"""ResNet-bottleneck U-Net generator (``ircolor_tpu/models/generator.py``),
default topology, inference and training.

  encoder    inc: ReflectPad3 + 7×7 conv 1→64 + IN + ReLU
             down1/down2: 3×3 conv + IN + ReLU + blur-pool /2
  bottleneck n_blocks × ResnetBlock(256)
  decoder    up1/up2: AA-upsample ×2 → conv over concat(skip) + IN + ReLU
             outc: ReflectPad3 + 7×7 conv 64→3 + tanh

Activations are NHWC tensors (``ops.layout``). The ``nn.Sequential``
containers exist to give the parameters the reference state_dict names
(``inc.1``, ``down1.0``, ``resblocks.{i}.conv_block.{1,5}``, ``up1_conv.0``,
``outc.1``, ...); ``forward`` applies their members itself.

Routing is the JAX generator's, flag for flag and gate for gate (the area,
launch and small-batch-band gates, the channel alignment checks,
``_fused_dtype_ok``), minus ``_pallas_available``: routing does not depend
on the device. The kernel wrappers dispatch on the tensor's device instead
(CPU → plain version, CUDA → the kernel or an error), so the CPU tests run
the exact routing the card runs. The module-level names
``_fused_dtype_ok``, ``resnet_block_pallas``, ``resnet_block_pallas_q``,
``norm_relu_blur_down`` and ``outc_head`` match the JAX module's, so a test
can monkeypatch both packages the same way.

int8 serving (``quant_int8``) follows the JAX generator too: int8 inside
the fused blocks where they engage; the int8 route of ``QuantConv``
(``quant_conv_nhwc``) in down1, down2 and the unfused blocks, and the int8
``concat_conv3x3`` in up1 and up2, wherever neither the fused tails nor the
fused head engage (``_quant_convs``: batch 1 at 512×640, small planes);
``quant_fixed_u2`` (the fixed-scale up2 conv, where the fused kernels took
int8 off the decoder) and ``quant_head`` (the int8 head) as opt-in modes.
inc and the float 7×7 head stay float.

Not ported yet (raise ``NotImplementedError``; ``ROADMAP.md``):
``no_antialias``, ``no_antialias_up``, zero/replicate pads, dropout,
batch/none norms, the spatial mesh, remat.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ircolor_tpu_torch.kernels.blur import norm_blur_supported, norm_relu_blur_down
from ircolor_tpu_torch.kernels.head import head_supported, outc_head, outc_head_q
from ircolor_tpu_torch.kernels.resblock import resnet_block_pallas, resnet_block_pallas_q
from ircolor_tpu_torch.models.common import (
    concat_conv3x3,
    conv_nhwc,
    init_conv_,
    norm_nhwc,
    quant_conv_nhwc,
    use_bias_for_norm,
)
from ircolor_tpu_torch.ops.blurpool import blur_downsample, blur_upsample_aa
from ircolor_tpu_torch.ops.filters import binomial_filter_2d
from ircolor_tpu_torch.ops.padding import reflect_pad2d
from ircolor_tpu_torch.ops.resize import bilinear_align_corners


def _fused_dtype_ok(dtype) -> bool:
    """The fused kernels are bf16-only; the f32 parity path keeps two-pass
    IN statistics. Tests monkeypatch this to run the kernel routes in f32."""
    return dtype == torch.bfloat16


def _fused_tile_h(h: int) -> int | None:
    for th in (32, 16, 8, 4):
        if h % th == 0:
            return th
    return None


# The JAX package's gates, copied as they are (H100-tuned gates are later
# work): plane and launch floors of the fused blocks, the int8 blocks' lower
# plane floor, and the small-batch band where every fused kernel engages.
_FUSED_MIN_AREA = 12288
_FUSED_MIN_LAUNCH = 40960
_QUANT_FUSED_MIN_AREA = 4096


def _xla_smallbatch_band(b: int) -> bool:
    return 2 <= b <= 7


class _Blur(nn.Module):
    """Holds the reference's fixed binomial ``filt`` buffer (state_dict
    compatibility); the blur itself is ``ops.blurpool``."""

    def __init__(self, channels: int):
        super().__init__()
        filt = torch.from_numpy(binomial_filter_2d(3))
        self.register_buffer("filt", filt[None, None].repeat(channels, 1, 1, 1))


class ResnetBlock(nn.Module):
    """ReflectPad → 3×3 conv → IN → ReLU → ReflectPad → 3×3 conv → IN, + x."""

    def __init__(
        self,
        dim: int,
        *,
        use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        pallas_block: bool = False,
        pallas_block_min_area: int = _FUSED_MIN_AREA,
        pallas_block_min_launch: int = _FUSED_MIN_LAUNCH,
        pallas_block_bwd: str = "xla",
        quant_int8: bool = False,
    ):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.pallas_block = pallas_block
        self.pallas_block_bwd = pallas_block_bwd
        self.pallas_block_min_area = pallas_block_min_area
        self.pallas_block_min_launch = pallas_block_min_launch
        self.quant_int8 = quant_int8
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1),
            nn.Conv2d(dim, dim, 3, bias=use_bias),
            nn.InstanceNorm2d(dim),
            nn.ReLU(True),
            nn.ReflectionPad2d(1),
            nn.Conv2d(dim, dim, 3, bias=use_bias),
            nn.InstanceNorm2d(dim),
        )

    def fused(self, x: torch.Tensor) -> bool:
        """The JAX ResnetBlock's fused-route gate (single device)."""
        b, h, w, c = x.shape
        quant = self.quant_int8
        min_area = (
            min(self.pallas_block_min_area, _QUANT_FUSED_MIN_AREA)
            if quant
            else self.pallas_block_min_area
        )
        return (
            self.pallas_block
            and _fused_dtype_ok(self.dtype)
            and _fused_tile_h(h) is not None
            and w % 8 == 0
            and c % 128 == 0
            and self.dim % 128 == 0
            and (
                (h * w >= min_area and b * h * w >= self.pallas_block_min_launch)
                or _xla_smallbatch_band(b)
            )
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1, conv2 = self.conv_block[1], self.conv_block[5]
        if self.fused(x):
            # OIHW → HWIO in the compute dtype; the block's backward returns
            # dk in that dtype and autograd carries it back through the cast
            # and the permute. The biases are inert through IN: no gradient.
            k1 = conv1.weight.permute(2, 3, 1, 0).to(self.dtype)
            k2 = conv2.weight.permute(2, 3, 1, 0).to(self.dtype)
            if self.quant_int8:
                return resnet_block_pallas_q(x, k1, k2)
            return resnet_block_pallas(x, k1, k2, bwd=self.pallas_block_bwd)
        if self.quant_int8:
            h = quant_conv_nhwc(conv1, x, self.dtype, pad="reflect")
            h = torch.relu(norm_nhwc(h))
            h = quant_conv_nhwc(conv2, h, self.dtype, pad="reflect")
            return x + norm_nhwc(h)
        h = conv_nhwc(conv1, reflect_pad2d(x, 1), self.dtype)
        h = torch.relu(norm_nhwc(h))
        h = conv_nhwc(conv2, reflect_pad2d(h, 1), self.dtype)
        return x + norm_nhwc(h)


class ResnetUNetGenerator(nn.Module):
    """U-Net encoder/decoder with a ResNet bottleneck (module docstring)."""

    def __init__(
        self,
        input_nc: int = 1,
        output_nc: int = 3,
        ngf: int = 64,
        n_blocks: int = 9,
        *,
        norm: str = "instance",
        dtype: torch.dtype = torch.float32,
        pallas_block: bool = False,
        pallas_block_min_area: int = _FUSED_MIN_AREA,
        pallas_block_min_launch: int = _FUSED_MIN_LAUNCH,
        pallas_block_bwd: str = "xla",
        pallas_norm_blur: bool = False,
        pallas_norm_blur_min_area: int = 0,
        pallas_norm_blur_min_launch: int = 0,
        pallas_head: bool = False,
        pallas_head_min_area: int = 0,
        pallas_head_min_launch: int = 0,
        quant_int8: bool = False,
        quant_fixed_u2: bool = False,
        quant_head: bool = False,
    ):
        super().__init__()
        if norm != "instance":
            raise NotImplementedError(f"norm={norm!r} is not ported yet (ROADMAP.md, Queue 1)")
        use_bias = use_bias_for_norm(norm)
        self.ngf = ngf
        self.n_blocks = n_blocks
        self.dtype = dtype
        self.pallas_norm_blur = pallas_norm_blur
        self.pallas_norm_blur_min_area = pallas_norm_blur_min_area
        self.pallas_norm_blur_min_launch = pallas_norm_blur_min_launch
        self.pallas_head = pallas_head
        self.pallas_head_min_area = pallas_head_min_area
        self.pallas_head_min_launch = pallas_head_min_launch
        self.quant_int8 = quant_int8
        self.quant_fixed_u2 = quant_fixed_u2
        self.quant_head = quant_head

        def norm_relu(c):
            return [nn.InstanceNorm2d(c), nn.ReLU(True)]

        self.inc = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(input_nc, ngf, 7, bias=use_bias),
            *norm_relu(ngf),
        )
        self.down1 = nn.Sequential(
            nn.Conv2d(ngf, ngf * 2, 3, padding=1, bias=use_bias), *norm_relu(ngf * 2)
        )
        self.down1_down = _Blur(ngf * 2)
        self.down2 = nn.Sequential(
            nn.Conv2d(ngf * 2, ngf * 4, 3, padding=1, bias=use_bias), *norm_relu(ngf * 4)
        )
        self.down2_down = _Blur(ngf * 4)
        self.resblocks = nn.Sequential(*[
            ResnetBlock(
                ngf * 4, use_bias=use_bias, dtype=dtype, pallas_block=pallas_block,
                pallas_block_min_area=pallas_block_min_area,
                pallas_block_min_launch=pallas_block_min_launch,
                pallas_block_bwd=pallas_block_bwd, quant_int8=quant_int8,
            )
            for _ in range(n_blocks)
        ])
        self.up1_up = _Blur(ngf * 4)
        self.up1_conv = nn.Sequential(
            nn.Conv2d(ngf * 4 + ngf * 2, ngf * 2, 3, padding=1, bias=use_bias),
            *norm_relu(ngf * 2),
        )
        self.up2_up = _Blur(ngf * 2)
        self.up2_conv = nn.Sequential(
            nn.Conv2d(ngf * 2 + ngf, ngf, 3, padding=1, bias=use_bias),
            *norm_relu(ngf),
        )
        self.outc = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7), nn.Tanh()
        )

    def init_weights(self, init_type: str, gain: float, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_conv_(m, init_type, gain, gen)

    # --- the JAX generator's gates -----------------------------------------

    def _norm_blur_ok(self, y: torch.Tensor) -> bool:
        b, h, w, _ = y.shape
        return (
            self.pallas_norm_blur
            and _fused_dtype_ok(self.dtype)
            and (
                (h * w >= self.pallas_norm_blur_min_area
                 and b * h * w >= self.pallas_norm_blur_min_launch)
                or _xla_smallbatch_band(b)
            )
            and norm_blur_supported(tuple(y.shape))
        )

    def _head_ok(self, y: torch.Tensor) -> bool:
        b, h, w, _ = y.shape
        return (
            self.pallas_head
            and _fused_dtype_ok(self.dtype)
            and (
                (h * w >= self.pallas_head_min_area
                 and b * h * w >= self.pallas_head_min_launch)
                or _xla_smallbatch_band(b)
            )
            and head_supported(tuple(y.shape))
        )

    def _quant_convs(self, x: torch.Tensor) -> bool:
        """The JAX ``quant_convs``: whether down1, down2, up1 and up2 take
        the int8 route — int8 on and neither the fused tails nor the fused
        head engage for this input."""
        if not self.quant_int8:
            return False
        if not _fused_dtype_ok(self.dtype):
            return True
        bb, bh, bw = x.shape[0], x.shape[1], x.shape[2]
        ngf = self.ngf
        nb_on = self.pallas_norm_blur and any(
            ((hh * ww >= self.pallas_norm_blur_min_area
              and bb * hh * ww >= self.pallas_norm_blur_min_launch)
             or _xla_smallbatch_band(bb))
            and norm_blur_supported((1, hh, ww, cc))
            for hh, ww, cc in ((bh, bw, ngf * 2), (bh // 2, bw // 2, ngf * 4))
        )
        head_on = (
            self.pallas_head
            and ((bh * bw >= self.pallas_head_min_area
                  and bb * bh * bw >= self.pallas_head_min_launch)
                 or _xla_smallbatch_band(bb))
            and head_supported((1, bh, bw, ngf))
        )
        return not (nb_on or head_on)

    # --- forward -------------------------------------------------------------

    def _down(self, seq: nn.Sequential, x: torch.Tensor, quant: bool) -> torch.Tensor:
        if quant:
            y = quant_conv_nhwc(seq[0], x, self.dtype)
        else:
            y = conv_nhwc(seq[0], x, self.dtype)
        if self._norm_blur_ok(y):
            return norm_relu_blur_down(y)
        return blur_downsample(torch.relu(norm_nhwc(y)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """IR (B, H, W, input_nc) in [-1, 1] → RGB (B, H, W, output_nc) in
        [-1, 1], in the compute dtype."""
        dt = self.dtype
        quant_convs = self._quant_convs(x)
        dec_quant = "dynamic" if quant_convs else None

        x0 = conv_nhwc(self.inc[1], reflect_pad2d(x.to(dt), 3), dt)
        x0 = torch.relu(norm_nhwc(x0))                          # (B, H, W, 64)
        x1 = self._down(self.down1, x0, quant_convs)            # (B, H/2, W/2, 128)
        x2 = self._down(self.down2, x1, quant_convs)            # (B, H/4, W/4, 256)
        h = self.resblocks(x2)

        y = blur_upsample_aa(h)
        if y.shape[1:3] != x1.shape[1:3]:
            y = bilinear_align_corners(y, tuple(x1.shape[1:3]))
        y = torch.relu(norm_nhwc(concat_conv3x3(self.up1_conv[0], y, x1, dt, dec_quant)))

        y = blur_upsample_aa(y)
        if y.shape[1:3] != x0.shape[1:3]:
            y = bilinear_align_corners(y, tuple(x0.shape[1:3]))
        # The fixed-scale int8 up2 conv only where the fused kernels took
        # the dynamic int8 route off the decoder (the JAX ``quant_fixed``).
        if self.quant_int8 and not quant_convs and self.quant_fixed_u2:
            dec_quant = "fixed"
        y = concat_conv3x3(self.up2_conv[0], y, x0, dt, dec_quant)

        outc = self.outc[1]
        if self._head_ok(y):
            k7 = outc.weight.permute(2, 3, 1, 0).to(dt)         # OIHW → HWIO
            head = outc_head_q if self.quant_int8 and self.quant_head else outc_head
            return torch.tanh(head(y, k7) + outc.bias.to(dt))
        y = torch.relu(norm_nhwc(y))
        return torch.tanh(conv_nhwc(outc, reflect_pad2d(y, 3), dt))
