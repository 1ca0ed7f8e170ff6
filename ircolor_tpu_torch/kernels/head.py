"""Fused 7×7 output head: up2's IN-normalize + ReLU + ReflectionPad(3) + the
7×7 conv to 3 channels (``csrc/head.cu``), float and int8.

Counterpart of ``ircolor_tpu/ops/pallas_head.py``: ``conv7x7_head_pallas``
(the kernel; ``quant=True`` is the int8 form, kernel 4q), ``outc_head``
(stats by a plain reduction, then the kernel; differentiable, with the JAX
package's hand-assembled backward) and ``outc_head_q`` (the int8 form,
inference only). The caller adds the bias and the tanh.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.kernels import LAUNCHES, build, require, stream_ptr
from ircolor_tpu_torch.kernels.conv_int8 import int_conv_exact
from ircolor_tpu_torch.ops.norm import instance_norm_stats, instance_norm_vjp
from ircolor_tpu_torch.ops.quant import _QCLIP, quantize_weight_per_channel

_KS = 7
_SMEM_LIMIT = 227 * 1024

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("head")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ircolor_conv7x7_head.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.ircolor_conv7x7_head.restype = i
        lib.ircolor_conv7x7_head_smem_bytes.argtypes = [i]
        lib.ircolor_conv7x7_head_smem_bytes.restype = i
        lib.ircolor_conv7x7_head_q.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.ircolor_conv7x7_head_q.restype = i
        lib.ircolor_conv7x7_head_q_smem_bytes.argtypes = [i]
        lib.ircolor_conv7x7_head_q_smem_bytes.restype = i
        _lib = lib
    return _lib


def _normalize_relu(x, mean, inv):
    return torch.relu((x.float() - mean[:, None, None, :]) * inv[:, None, None, :])


def _pad_conv7(z: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """NHWC ``z`` ⊛ HWIO ``k`` after ReflectionPad(3), in z's dtype."""
    zp = F.pad(z.permute(0, 3, 1, 2), (3, 3, 3, 3), mode="reflect")
    return F.conv2d(zp, k.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def conv7x7_head_plain(x, mean, inv, kernel):
    """Plain version: the normalized input rounded to x's dtype, the conv in
    float32, the result rounded to x's dtype."""
    z = _normalize_relu(x, mean, inv).to(x.dtype).float()
    return _pad_conv7(z, kernel.to(x.dtype).float()).to(x.dtype)


def _quantize_head_weight(kernel):
    """(int8 kernel, float32 sc[co] = 6/127 · sw[co]) as the JAX kernel
    quantizes and dequantizes."""
    kq, sw = quantize_weight_per_channel(kernel)
    return kq, sw * (_QCLIP / 127.0)


def conv7x7_head_q_plain(x, mean, inv, kernel):
    """Plain version of the int8 form: z = relu((x − mean)·inv) in float32,
    q = min(round(z·127/6), 127), the exact integer conv, dequantized by
    one multiply and rounded to x's dtype."""
    q = torch.clamp(torch.round(_normalize_relu(x, mean, inv) * (127.0 / _QCLIP)), max=127.0)
    kq, sc = _quantize_head_weight(kernel)
    return (int_conv_exact(q, kq, "reflect").float() * sc).to(x.dtype)


def conv7x7_head_pallas(x, mean, inv, kernel, *, quant: bool = False):
    """(B, H, W, C) raw up2 conv output + per-(B, C) IN ``(mean, inv_std)``
    + (7, 7, C, Cout) weights → ``conv7×7_reflect3(relu((x−mean)·inv))``,
    (B, H, W, Cout). No bias, no tanh. ``quant=True``: the int8 form
    (weights quantized here per output channel, the input on the fixed
    127/6 grid in the kernel)."""
    if x.device.type == "cpu":
        plain = conv7x7_head_q_plain if quant else conv7x7_head_plain
        return plain(x, mean, inv, kernel)
    b, h, w, c = x.shape
    require(x, "x", torch.bfloat16, (None, None, None, None))
    require(mean, "mean", torch.float32, (b, c))
    require(inv, "inv", torch.float32, (b, c))
    lib = _load()
    cc = 16 if quant else 8
    smem = (lib.ircolor_conv7x7_head_q_smem_bytes if quant else lib.ircolor_conv7x7_head_smem_bytes)(c)
    if tuple(kernel.shape) != (_KS, _KS, c, 3) or c % cc or h < 4 or w < 4 or smem > _SMEM_LIMIT:
        raise ValueError(
            f"conv7x7 head kernel: unsupported x={tuple(x.shape)} "
            f"kernel={tuple(kernel.shape)} (needs (7, 7, C, 3), C % {cc} == 0, "
            "H, W >= 4)"
        )
    out = torch.empty((b, h, w, 3), dtype=x.dtype, device=x.device)
    if quant:
        kq, sc = _quantize_head_weight(kernel)
        # (7, 7, C, 3) → words of 4 consecutive input channels, (7, 7, C/4, 3).
        kw = kq.reshape(_KS, _KS, c // 4, 4, 3).permute(0, 1, 2, 4, 3).contiguous()
        err = lib.ircolor_conv7x7_head_q(
            x.data_ptr(), mean.data_ptr(), inv.data_ptr(), kw.view(torch.int32).data_ptr(),
            sc.contiguous().data_ptr(), out.data_ptr(), b, h, w, c, stream_ptr(),
        )
        build.check(err, "conv7x7_head_q")
        LAUNCHES["conv7x7_head_q"] += 1
        return out
    wf = kernel.to(torch.bfloat16).float().contiguous()
    err = lib.ircolor_conv7x7_head(
        x.data_ptr(), mean.data_ptr(), inv.data_ptr(), wf.data_ptr(),
        out.data_ptr(), b, h, w, c, stream_ptr(),
    )
    build.check(err, "conv7x7_head")
    LAUNCHES["conv7x7_head"] += 1
    return out


class _OutcHead(torch.autograd.Function):
    """The JAX package's ``_head_vjp``: the forward saves x, the kernel and
    the IN stats; the backward recomputes ŷ = (x − μ)·inv, takes the dgrad
    and wgrad of the reflect-pad 7×7 conv by autograd of the plain conv
    (cuDNN on the card), masks by ReLU and applies the closed-form IN
    backward. It does not read the forward's output, so it is the same
    whether the forward ran the kernel or the plain version."""

    @staticmethod
    def forward(ctx, x, kernel):
        mean, inv = instance_norm_stats(x)
        ctx.save_for_backward(x, kernel, mean, inv)
        return conv7x7_head_pallas(x, mean, inv, kernel)

    @staticmethod
    def backward(ctx, g):
        x, kernel, mean, inv = ctx.saved_tensors
        yhat = (x.float() - mean[:, None, None, :]) * inv[:, None, None, :]
        z = torch.relu(yhat).to(x.dtype)
        with torch.enable_grad():
            zz = z.detach().requires_grad_()
            kk = kernel.detach().requires_grad_()
            dz, dk = torch.autograd.grad(_pad_conv7(zz, kk), (zz, kk), g)
        dn = dz.float() * (yhat > 0)
        return instance_norm_vjp(dn, yhat, inv).to(x.dtype), dk.to(kernel.dtype)


def outc_head(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``conv7×7_reflect3(relu(IN(x)))``: one-pass IN stats, then the fused
    head (bias and tanh are the caller's). Differentiable in x and kernel."""
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        return _OutcHead.apply(x, kernel)
    mean, inv = instance_norm_stats(x)
    return conv7x7_head_pallas(x, mean, inv, kernel)


def outc_head_q(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The int8 form of ``outc_head`` (inference only: rounding has no
    gradient)."""
    mean, inv = instance_norm_stats(x)
    return conv7x7_head_pallas(x, mean, inv, kernel, quant=True)


# The JAX routing gate (pallas_head.head_supported), copied as it is.
_PACKS = (40, 32, 16, 8)


def _pick_pack(w: int, c: int) -> int | None:
    for p in _PACKS:
        if w % p == 0 and (w // p) % 8 == 0 and (p * c) % 128 == 0:
            return p
    return None


def _pick_tile(h: int, wg: int, c: int, p: int, limit: int) -> int | None:
    for th in (32, 16, 8, 4):
        if h % th != 0 or th > h:
            continue
        scratch = 2 * (th + 6) * wg * p * c * 2
        temps = 3 * (th + 6) * wg * p * c * 4
        if scratch + temps > int(limit * 0.75):
            continue
        return th
    return None


def head_supported(shape: tuple[int, ...], vmem_limit_mb: int = 96) -> bool:
    _, h, w, c = shape
    p = _pick_pack(w, c)
    return (
        p is not None
        and h >= 8
        and _pick_tile(h, w // p, c, p, vmem_limit_mb * 1024 * 1024) is not None
    )
