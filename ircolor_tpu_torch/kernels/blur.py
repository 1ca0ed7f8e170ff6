"""Fused down-stage tail: IN-normalize + ReLU + ReflectionPad(1) + binomial-3
blur-pool at stride 2 (``csrc/blur.cu``), and the blur-pool alone.

Counterpart of ``ircolor_tpu/ops/pallas_blur.py``: ``norm_relu_blur_down_pallas``
(the kernel), ``norm_relu_blur_down`` (the stats by a plain reduction,
then the kernel; differentiable, with the JAX package's hand-assembled
backward) and ``blur_downsample_pallas`` (no normalize; unwired in the JAX
generator, as here). One read of the input, one quarter-size write.
"""

from __future__ import annotations

import ctypes

import torch

from ircolor_tpu_torch.kernels import (
    LAUNCHES,
    build,
    exported_op,
    on_input_card,
    require,
    stream_ptr,
)
from ircolor_tpu_torch.ops.blurpool import blur_downsample
from ircolor_tpu_torch.ops.norm import instance_norm_stats, instance_norm_vjp

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("blur")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ircolor_norm_relu_blur_down.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.ircolor_norm_relu_blur_down.restype = i
        lib.ircolor_blur_down.argtypes = [p, p, i, i, i, i, p]
        lib.ircolor_blur_down.restype = i
        _lib = lib
    return _lib


def _blur_down_f32(z):
    """The JAX kernels' order of additions on float32 ``z``: rows first
    (z[2i−1] + 2·z[2i]) + z[2i+1], then the same over columns, then ×1/16
    once. Reflect reaches only row and column −1 (≡ 1): with even H and W
    the window never reads past the far edge."""
    xe, xo = z[:, 0::2], z[:, 1::2]
    xm = torch.cat([xo[:, :1], xo[:, :-1]], dim=1)  # x[2i−1]; x[−1] ≡ x[1]
    yh = xm + 2.0 * xe + xo
    ye, yo = yh[:, :, 0::2], yh[:, :, 1::2]
    ym = torch.cat([yo[:, :, :1], yo[:, :, :-1]], dim=2)
    return (ym + 2.0 * ye + yo) * (1.0 / 16.0)


def norm_relu_blur_down_plain(x, mean, inv):
    """Plain version of ``norm_relu_blur_down_pallas``."""
    z = torch.relu((x.float() - mean[:, None, None, :]) * inv[:, None, None, :])
    return _blur_down_f32(z).to(x.dtype)


def blur_downsample_plain(x):
    """Plain version of ``blur_downsample_pallas``: float32 inside, in the
    kernel's order, one rounding to x's dtype. ``ops.blurpool.blur_downsample``
    (a depthwise conv) is the same function, summed in another order."""
    return _blur_down_f32(x.float()).to(x.dtype)


@on_input_card
def blur_downsample_pallas(x):
    """(B, H, W, C) → (B, H/2, W/2, C) binomial-3 reflect blur-pool. Refuses
    what the JAX function refuses (``supported``); on the card also C % 8."""
    if not supported(tuple(x.shape)):
        raise ValueError(
            f"blur_downsample_pallas: unsupported shape {tuple(x.shape)} "
            "(needs even H and W and an H/2 tile: pallas_blur.supported)"
        )
    if x.device.type == "cpu":
        return blur_downsample_plain(x)
    b, h, w, c = x.shape
    require(x, "x", torch.bfloat16, (None, None, None, None))
    if c % 8:
        raise ValueError(f"blur_downsample kernel: C={c} (needs C % 8 == 0)")
    out = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    err = _load().ircolor_blur_down(x.data_ptr(), out.data_ptr(), b, h, w, c, stream_ptr(x))
    build.check(err, "blur_downsample")
    LAUNCHES["blur_downsample"] += 1
    return out


@on_input_card
def norm_relu_blur_down_pallas(x, mean, inv):
    """(B, H, W, C) raw conv output + per-(B, C) IN ``(mean, inv_std)`` →
    blur-pool of ``relu((x − mean)·inv)``, (B, H/2, W/2, C); in an export
    trace the op ``ircolor::norm_relu_blur_down``."""
    if (traced := exported_op("norm_relu_blur_down")) is not None:
        return traced(x, mean, inv)
    if x.device.type == "cpu":
        return norm_relu_blur_down_plain(x, mean, inv)
    b, h, w, c = x.shape
    require(x, "x", torch.bfloat16, (None, None, None, None))
    require(mean, "mean", torch.float32, (b, c))
    require(inv, "inv", torch.float32, (b, c))
    if h % 2 or w % 2 or c % 8 or h < 2:
        raise ValueError(
            f"norm_relu_blur_down kernel: unsupported shape {tuple(x.shape)} "
            "(needs even H and W, C % 8 == 0)"
        )
    out = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    err = _load().ircolor_norm_relu_blur_down(
        x.data_ptr(), mean.data_ptr(), inv.data_ptr(), out.data_ptr(),
        b, h, w, c, stream_ptr(x),
    )
    build.check(err, "norm_relu_blur_down")
    LAUNCHES["norm_relu_blur_down"] += 1
    return out


class _NormReluBlurDown(torch.autograd.Function):
    """The JAX package's ``_nrbd_vjp``: the forward saves x and its IN
    stats; the backward recomputes ŷ = (x − μ)·inv, applies the adjoint of
    the plain blur-pool (autograd of ``ops.blurpool.blur_downsample``),
    masks by ReLU and applies the closed-form IN backward. It does not read
    the forward's output, so it is the same whether the forward ran the
    kernel or the plain version."""

    @staticmethod
    def forward(ctx, x):
        mean, inv = instance_norm_stats(x)
        ctx.save_for_backward(x, mean, inv)
        return norm_relu_blur_down_pallas(x, mean, inv)

    @staticmethod
    def backward(ctx, g):
        x, mean, inv = ctx.saved_tensors
        yhat = (x.float() - mean[:, None, None, :]) * inv[:, None, None, :]
        z = torch.relu(yhat).to(x.dtype)
        with torch.enable_grad():
            zz = z.detach().requires_grad_()
            (dz,) = torch.autograd.grad(blur_downsample(zz), zz, g)
        dn = dz.float() * (yhat > 0)
        return instance_norm_vjp(dn, yhat, inv).to(x.dtype)


def norm_relu_blur_down(x: torch.Tensor) -> torch.Tensor:
    """``blurpool(relu(IN(x)))``: one-pass IN stats, then the fused pass.
    Differentiable in x."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _NormReluBlurDown.apply(x)
    mean, inv = instance_norm_stats(x)
    return norm_relu_blur_down_pallas(x, mean, inv)


def _pick_tile(h2: int, w: int = 0, c: int = 0, limit: int = 64 * 1024 * 1024) -> int | None:
    """The JAX kernel's H-tile pick — kept only because its shape contracts
    (``supported``, ``norm_blur_supported``) are copied as they are."""
    for th in (16, 8, 4, 2):
        if h2 % th != 0 or h2 // th < 2:
            continue
        if w and c:
            scratch = 2 * (2 * th + 1) * w * c * 2
            temps = 8 * (2 * th + 1) * w * c * 4
            if scratch + temps > int(limit * 0.75):
                continue
        return th
    return None


def supported(shape: tuple[int, ...]) -> bool:
    """The shapes ``pallas_blur.blur_downsample_pallas`` takes, as is."""
    _, h, w, c = shape
    return h % 2 == 0 and w % 2 == 0 and _pick_tile(h // 2, w, c) is not None


def norm_blur_supported(shape: tuple[int, ...]) -> bool:
    """The JAX routing gate (``pallas_blur.norm_blur_supported``), as is."""
    _, h, w, c = shape
    return (
        h % 2 == 0
        and w % 2 == 0
        and _pick_tile(h // 2, w, c, limit=96 * 1024 * 1024) is not None
        and c % 128 == 0
    )
