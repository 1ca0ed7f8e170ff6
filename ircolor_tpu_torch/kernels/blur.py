"""Fused down-stage tail: IN-normalize + ReLU + ReflectionPad(1) + binomial-3
blur-pool at stride 2 (``csrc/blur.cu``).

Counterpart of ``ircolor_tpu/ops/pallas_blur.py``: ``norm_relu_blur_down_pallas``
(the kernel) and ``norm_relu_blur_down`` (the stats by a plain reduction,
then the kernel; differentiable, with the JAX package's hand-assembled
backward). One read of the conv output, one quarter-size write.
"""

from __future__ import annotations

import ctypes

import torch

from ircolor_tpu_torch.kernels import LAUNCHES, build, require, stream_ptr
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
        _lib = lib
    return _lib


def norm_relu_blur_down_plain(x, mean, inv):
    """Plain version, with the JAX kernel's order of additions: rows first
    (x[2i−1] + 2·x[2i]) + x[2i+1], then the same over columns, ÷16."""
    z = torch.relu((x.float() - mean[:, None, None, :]) * inv[:, None, None, :])
    xe, xo = z[:, 0::2], z[:, 1::2]
    xm = torch.cat([xo[:, :1], xo[:, :-1]], dim=1)  # x[2i−1]; x[−1] ≡ x[1]
    yh = xm + 2.0 * xe + xo
    ye, yo = yh[:, :, 0::2], yh[:, :, 1::2]
    ym = torch.cat([yo[:, :, :1], yo[:, :, :-1]], dim=2)
    return ((ym + 2.0 * ye + yo) * (1.0 / 16.0)).to(x.dtype)


def norm_relu_blur_down_pallas(x, mean, inv):
    """(B, H, W, C) raw conv output + per-(B, C) IN ``(mean, inv_std)`` →
    blur-pool of ``relu((x − mean)·inv)``, (B, H/2, W/2, C)."""
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
        b, h, w, c, stream_ptr(),
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
    """The JAX kernel's H-tile pick — kept only because its routing gate
    (``norm_blur_supported``) is copied as it is."""
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


def norm_blur_supported(shape: tuple[int, ...]) -> bool:
    """The JAX routing gate (``pallas_blur.norm_blur_supported``), as is."""
    _, h, w, c = shape
    return (
        h % 2 == 0
        and w % 2 == 0
        and _pick_tile(h // 2, w, c, limit=96 * 1024 * 1024) is not None
        and c % 128 == 0
    )
