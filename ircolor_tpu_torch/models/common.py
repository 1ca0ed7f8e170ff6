"""Shared model plumbing (``ircolor_tpu/models/common.py`` subset).

* ``use_bias_for_norm``: conv bias iff instance norm.
* ``norm_nhwc``: instance norm in the JAX package's dtype rule — one-pass
  statistics on the bf16 path, two-pass on the f32 parity path.
* ``BatchNorm``, ``make_norm``, ``apply_norm``: the JAX ``Norm`` dispatch
  (``instance`` | ``batch`` | ``none``) as modules under the reference's
  state_dict names.
* ``conv_nhwc``: a ``nn.Conv2d``'s parameters applied to an NHWC tensor in
  the compute dtype (the JAX ``Conv(dtype=...)`` casts the same way).
* ``quant_conv_nhwc``: the same on the int8 route (``QuantConv``).
* ``concat_conv3x3``: a 3×3 zero-SAME conv over ``concat(a, b)`` computed as
  ``conv(a, K[:, :Ca]) + conv(b, K[:, Ca:])`` without materializing the
  concat, exactly as ``ConcatConv3x3`` adds its two terms; float, or int8
  with dynamic or fixed activation scales.
* ``norm_nhwc_spatial``, ``conv_nhwc_spatial``, ``quant_conv_nhwc_spatial``,
  ``concat_conv3x3_spatial``: the same on an image held as a list of
  H-shards (``parallel/spatial.py``), each shard's conv over its rows and
  their halo (stride 1), the instance norm by the global statistics;
  ``conv_nhwc_window_spatial`` at any kernel, stride and zero padding, on
  shards that may be unequal or empty (the discriminator, the VGG tower).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.distributed as dist
import torch.nn.functional as F

from ircolor_tpu_torch.ops.layout import to_nchw, to_nhwc
from ircolor_tpu_torch.ops.norm import (
    instance_norm,
    instance_norm_onepass,
    instance_norm_onepass_spatial,
    instance_norm_spatial,
)
from ircolor_tpu_torch.ops.padding import pad2d_spatial
from ircolor_tpu_torch.ops.quant import conv2d_int8, conv2d_int8_fixed, conv2d_int8_spatial
from ircolor_tpu_torch.parallel.spatial import window_slabs

NORM_TYPES = ("instance", "batch", "none")


def use_bias_for_norm(norm: str) -> bool:
    if norm not in NORM_TYPES:
        raise NotImplementedError(f"Normalization type [{norm}] not supported")
    return norm == "instance"


def norm_nhwc(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        return instance_norm_onepass(x)
    return instance_norm(x)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of the process group; its gradient likewise
    (every rank's loss reads the summed value)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


class BatchNorm(nn.Module):
    """Batch norm of NHWC tensors with ``nn.BatchNorm2d``'s state (``weight``,
    ``bias``, ``running_mean``, ``running_var``, ``num_batches_tracked``: the
    reference's keys) and the JAX package's arithmetic (flax ``BatchNorm``,
    momentum 0.9 ≡ torch's 0.1, eps 1e-5). Training: the batch statistics
    over (B, H, W) in float32, the mean and the biased variance E[x²] −
    mean² (clipped at 0), which also update the running statistics as
    0.9·r + 0.1·batch — torch's ``BatchNorm2d`` would feed them the
    unbiased variance, n/(n − 1) larger. Eval: the running statistics. The
    output is float32 whatever the input's dtype, as flax promotes a bf16
    input against its float32 parameters. Under ``frozen_running_stats``
    (a checkpointed block's recompute) the statistics are not updated
    again. With ``sync`` (data parallelism over a process group) the
    training statistics are the global batch's: the per-channel sums, sums
    of squares and counts are all-reduced, and their gradients too, as
    ``SyncBatchNorm`` does."""

    update_stats = True
    sync = False

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training and self.sync:
            c = x32.shape[-1]
            sums = torch.cat([x32.sum(dim=(0, 1, 2)), x32.square().sum(dim=(0, 1, 2)),
                              x32.new_full((1,), x32.numel() // c)])
            sums = _AllReduceSum.apply(sums)
            mean = sums[:c] / sums[-1]
            var = torch.clamp(sums[c:2 * c] / sums[-1] - mean.square(), min=0.0)
        elif self.training:
            mean = x32.mean(dim=(0, 1, 2))
            var = torch.clamp(x32.square().mean(dim=(0, 1, 2)) - mean.square(), min=0.0)
        if self.training:
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
                    self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        return (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """No ``BatchNorm`` of ``module`` updates its running statistics inside:
    the recompute of a checkpointed block (``remat``) repeats a forward
    whose update has already happened, and flax's ``nn.remat`` does not
    update twice."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def make_norm(norm: str, channels: int) -> nn.Module:
    """The norm layer of the reference's ``get_norm_layer``: a parameterless
    ``nn.InstanceNorm2d`` (applied as ``norm_nhwc``), ``BatchNorm``, or
    ``nn.Identity`` for ``"none"``."""
    if norm == "instance":
        return nn.InstanceNorm2d(channels)
    if norm == "batch":
        return BatchNorm(channels)
    if norm == "none":
        return nn.Identity()
    raise NotImplementedError(f"Normalization type [{norm}] not supported")


def apply_norm(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A ``make_norm`` layer on an NHWC tensor."""
    if isinstance(layer, nn.InstanceNorm2d):
        return norm_nhwc(x)
    return layer(x)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bias = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(
        to_nchw(x.to(dtype)), conv.weight.to(dtype), bias,
        stride=conv.stride, padding=conv.padding,
    )
    return to_nhwc(y)


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)


def quant_conv_nhwc(
    conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype, *, pad: str = "zero"
) -> torch.Tensor:
    """The JAX ``QuantConv``: a 3×3 ``nn.Conv2d``'s float32 parameters, at
    its stride (1, or 2 in the no_antialias down convs), applied on the
    int8 route (``ops.quant.conv2d_int8``) with one pixel of ``pad``
    (``"zero"``, or ``"reflect"`` for the resnet blocks, which reflect-pad
    and then convolve VALID in the JAX package: the same sums) or none
    (``"valid"``: ``x`` comes padded)."""
    return conv2d_int8(x, _hwio(conv), pad=pad, stride=conv.stride[0], bias=conv.bias,
                       out_dtype=dtype)


def concat_conv3x3(
    conv: nn.Conv2d, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype,
    quant: str | None = None,
) -> torch.Tensor:
    """``quant``: None (float), ``"dynamic"`` (``conv2d_int8``) or
    ``"fixed"`` (``conv2d_int8_fixed``). On the int8 routes each leg
    quantizes its own input and its own half of the weight; the legs are
    float32 terms summed, then the bias is added, then the cast."""
    ca = a.shape[-1]
    if quant is not None:
        fn = {"dynamic": conv2d_int8, "fixed": conv2d_int8_fixed}[quant]
        k = _hwio(conv)
        ya = fn(a, k[:, :, :ca], out_dtype=torch.float32)
        return fn(b, k[:, :, ca:], addend=ya, bias=conv.bias, out_dtype=dtype)
    w = conv.weight.to(dtype)
    y = F.conv2d(to_nchw(a.to(dtype)), w[:, :ca], padding=1) + F.conv2d(
        to_nchw(b.to(dtype)), w[:, ca:], padding=1
    )
    if conv.bias is not None:
        y = y + conv.bias.to(dtype)[None, :, None, None]
    return to_nhwc(y)


def norm_nhwc_spatial(xs) -> list[torch.Tensor]:
    """``norm_nhwc`` of the image whose H-shards are ``xs``."""
    if xs[0].dtype == torch.bfloat16:
        return instance_norm_onepass_spatial(xs)
    return instance_norm_spatial(xs)


def conv_nhwc_spatial(conv: nn.Conv2d, xs, dtype: torch.dtype, *, pad: int,
                      pad_type: str) -> list[torch.Tensor]:
    """``conv_nhwc`` (stride 1) of ``pad`` pixels of ``pad_type`` padding
    and ``conv`` applied VALID, on the image whose H-shards are ``xs``: the
    conv's own zero padding (down1, down2) or a pad module before it (inc,
    outc, the resnet blocks' reflect pads)."""
    out = []
    for slab in pad2d_spatial([x.to(dtype) for x in xs], pad, pad_type):
        dev = slab.device
        bias = None if conv.bias is None else conv.bias.to(dev, dtype)
        out.append(to_nhwc(F.conv2d(to_nchw(slab), conv.weight.to(dev, dtype), bias)))
    return out


def conv_nhwc_window_spatial(conv: nn.Conv2d, xs, dtype: torch.dtype) -> list[torch.Tensor]:
    """``conv_nhwc`` at the conv's own kernel, stride and zero padding (any
    of them: the discriminator's 4×4 convs at strides 2 and 1, the VGG
    tower's 3×3) on the image whose H-shards are ``xs``: each shard's
    output rows by ``parallel.spatial.window_heights``' owner rule, from its
    slab of input rows (``window_slabs``); a shard that keeps no output row
    gets an empty one. The shards may be unequal or empty."""
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    w_out = (xs[0].shape[2] + 2 * conv.padding[1] - conv.kernel_size[1]) // conv.stride[1] + 1
    out = []
    for x, slab in zip(xs, window_slabs([x.to(dtype) for x in xs], k, s, p)):
        if slab is None:
            out.append(x.new_zeros((x.shape[0], 0, w_out, conv.out_channels), dtype=dtype))
            continue
        dev = slab.device
        bias = None if conv.bias is None else conv.bias.to(dev, dtype)
        out.append(to_nhwc(F.conv2d(to_nchw(slab), conv.weight.to(dev, dtype), bias,
                                    stride=conv.stride, padding=(0, conv.padding[1]))))
    return out


def quant_conv_nhwc_spatial(conv: nn.Conv2d, xs, dtype: torch.dtype, *,
                            pad: str = "zero") -> list[torch.Tensor]:
    """``quant_conv_nhwc`` (stride 1) on the image whose H-shards are
    ``xs`` (``ops.quant.conv2d_int8_spatial``)."""
    return conv2d_int8_spatial(xs, _hwio(conv), pad=pad, bias=conv.bias, out_dtype=dtype)


def concat_conv3x3_spatial(conv: nn.Conv2d, as_, bs, dtype: torch.dtype,
                           quant: str | None = None) -> list[torch.Tensor]:
    """``concat_conv3x3`` on the images whose H-shards are ``as_`` and
    ``bs``, float or on the dynamic int8 route (the fixed-scale route runs
    only where the fused kernels took int8 off the decoder, which they
    never do under spatial sharding)."""
    ca = as_[0].shape[-1]
    if quant == "dynamic":
        k = _hwio(conv)
        ya = conv2d_int8_spatial(as_, k[:, :, :ca], out_dtype=torch.float32)
        return conv2d_int8_spatial(bs, k[:, :, ca:], addends=ya, bias=conv.bias, out_dtype=dtype)
    if quant is not None:
        raise NotImplementedError(f"the spatial concat conv takes quant None or 'dynamic', "
                                  f"got {quant!r}")
    out = []
    for sa, sb in zip(pad2d_spatial([a.to(dtype) for a in as_], 1, "zero"),
                      pad2d_spatial([b.to(dtype) for b in bs], 1, "zero")):
        w = conv.weight.to(sa.device, dtype)
        y = F.conv2d(to_nchw(sa), w[:, :ca]) + F.conv2d(to_nchw(sb), w[:, ca:])
        if conv.bias is not None:
            y = y + conv.bias.to(sa.device, dtype)[None, :, None, None]
        out.append(to_nhwc(y))
    return out


def init_norm_(bn: BatchNorm, gain: float, gen: torch.Generator) -> None:
    """The reference ``init_weights`` of a batch norm: weight N(1, gain),
    bias zero."""
    nn.init.normal_(bn.weight, 1.0, gain, generator=gen)
    nn.init.zeros_(bn.bias)


def init_module_(module: nn.Module, init_type: str, gain: float, gen: torch.Generator) -> None:
    """``init_conv_`` on every conv (and transposed conv) of ``module`` and
    ``init_norm_`` on every batch norm, in module order."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            init_conv_(m, init_type, gain, gen)
        elif isinstance(m, BatchNorm):
            init_norm_(m, gain, gen)


def init_conv_(conv: nn.Conv2d, init_type: str, gain: float, gen: torch.Generator) -> None:
    """The reference ``init_weights`` options: kernels per ``init_type``,
    biases zero (``normal`` is N(0, gain), the reference default)."""
    w = conv.weight
    if init_type == "normal":
        nn.init.normal_(w, 0.0, gain, generator=gen)
    elif init_type == "xavier":
        nn.init.xavier_normal_(w, gain=gain, generator=gen)
    elif init_type == "kaiming":
        nn.init.kaiming_normal_(w, a=0, mode="fan_in", generator=gen)
    elif init_type == "orthogonal":
        nn.init.orthogonal_(w, gain=gain, generator=gen)
    else:
        raise NotImplementedError(f"initialization method [{init_type}] is not implemented")
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)
