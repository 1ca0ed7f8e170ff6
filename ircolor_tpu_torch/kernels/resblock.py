"""Fused reflect-padded 3×3 conv of the resnet blocks (``csrc/resblock.cu``)
and the blocks built from it.

Counterparts of ``ircolor_tpu/ops/pallas_resblock.py``:
``conv3x3_reflect_fused`` (bf16), ``conv3x3_reflect_fused_q`` (int8),
``resnet_block_pallas`` and ``resnet_block_pallas_q``. One conv launch reads
the unpadded NHWC input once (reflect halos built on load, the previous IN
+ ReLU and, for int8, the quantization applied on load) and writes the raw
output once, with the per-(B, C) sums of the output for its instance norm.
The block epilogue ``x + ((raw2 − m2)·i2).to(dtype)`` stays plain torch.

The plain versions compute in float32 (bf16 products are exact there; the
int8 product in float64, exact for integers): on a CUDA device run them
with TF32 off, or they are not the reference.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.kernels import LAUNCHES, build, require, stream_ptr
from ircolor_tpu_torch.ops.quant import _AMAX_FLOOR, _QCLIP, quantize_weight_per_channel

_EPS = 1e-5
_BN = 128  # output channels per block of the kernel
_KBYTES = 32  # bytes of input channels per K chunk of the kernel

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("resblock")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ircolor_conv3x3_num_tiles.argtypes = [i, i]
        lib.ircolor_conv3x3_num_tiles.restype = i
        lib.ircolor_conv3x3_reflect.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.ircolor_conv3x3_reflect.restype = i
        _lib = lib
    return _lib


def _moments(s1: torch.Tensor, s2: torch.Tensor, n: int):
    """(mean, inv_std) from Σy, Σy² — the JAX kernels' epilogue formula."""
    mean = s1 / n
    var = s2 / n - mean * mean
    return mean, torch.rsqrt(var + _EPS)


def _conv_reflect(z: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """NHWC ``z`` ⊛ HWIO ``k`` with ReflectionPad(1), in z's dtype."""
    zp = F.pad(z.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return F.conv2d(zp, k.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def _normalize_relu(x, mean, inv):
    return torch.relu((x.float() - mean[:, None, None, :]) * inv[:, None, None, :])


# ---------------------------------------------------------------- bf16 ----


def conv3x3_reflect_fused_plain(x, kernel, mean=None, inv=None):
    """Plain version: (out, mean, inv) of ``conv3x3_reflect_fused``."""
    z = x if mean is None else _normalize_relu(x, mean, inv).to(x.dtype)
    y = _conv_reflect(z.float(), kernel.to(x.dtype).float())
    n = y.shape[1] * y.shape[2]
    m, i = _moments(y.sum(dim=(1, 2)), y.square().sum(dim=(1, 2)), n)
    return y.to(x.dtype), m, i


def _launch_conv(int8: bool, x, wpk, cout, *, mean, inv, qscale, sc):
    b, h, w, c = x.shape
    lib = _load()
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    ntiles = lib.ircolor_conv3x3_num_tiles(h, w)
    partial = torch.empty((b, ntiles, 2, cout), dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.ircolor_conv3x3_reflect(
        int(int8), x.data_ptr(), wpk.data_ptr(), ptr(mean), ptr(inv),
        ptr(qscale), ptr(sc), out.data_ptr(), partial.data_ptr(),
        b, h, w, c, cout, stream_ptr(),
    )
    name = "conv3x3_reflect_fused_q" if int8 else "conv3x3_reflect_fused"
    build.check(err, name)
    LAUNCHES[name] += 1
    s = partial.sum(dim=1)  # fixed-order reduce of the per-tile partials
    m, i = _moments(s[:, 0], s[:, 1], h * w)
    return out, m, i


def _check_conv(x, kernel, mean, inv, kchunk: int):
    b, h, w, c = x.shape
    cout = kernel.shape[-1]
    require(x, "x", torch.bfloat16, (None, None, None, None))
    if kernel.shape[:3] != (3, 3, c) or kernel.device != x.device:
        raise ValueError(f"kernel: expected (3, 3, {c}, Cout) on {x.device}")
    if c % kchunk or cout % _BN or h < 2 or w < 2 or b > 65535:
        raise ValueError(
            f"conv3x3 kernel: unsupported shape x={tuple(x.shape)} Cout={cout} "
            f"(needs C % {kchunk} == 0, Cout % {_BN} == 0, H, W >= 2)"
        )
    if mean is not None:
        require(mean, "mean", torch.float32, (b, c))
        require(inv, "inv", torch.float32, (b, c))


def conv3x3_reflect_fused(x, kernel, mean=None, inv=None):
    """ReflectionPad(1) 3×3 conv of unpadded NHWC ``x`` with HWIO ``kernel``
    → (raw output, IN mean, IN inv_std of it). With ``mean``/``inv`` the
    input is normalized and ReLU'd on load (rounded to x's dtype)."""
    if x.device.type == "cpu":
        return conv3x3_reflect_fused_plain(x, kernel, mean, inv)
    _check_conv(x, kernel, mean, inv, _KBYTES // 2)
    b, h, w, c = x.shape
    cout = kernel.shape[-1]
    kc = _KBYTES // 2
    wpk = (
        kernel.to(torch.bfloat16)
        .reshape(9, c // kc, kc, cout)
        .permute(1, 0, 3, 2)
        .contiguous()
    )
    return _launch_conv(False, x, wpk, cout, mean=mean, inv=inv, qscale=None, sc=None)


# ---------------------------------------------------------------- int8 ----


def _quantize_input(x, qscale, mean, inv):
    if mean is not None:
        z = _normalize_relu(x, mean, inv)
        return torch.clamp(torch.round(z * (127.0 / _QCLIP)), max=127.0)
    xf = x.float()
    return torch.clamp(torch.round(xf * qscale[:, None, None, None]), -127.0, 127.0)


def _int_conv_reflect(q: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """Exact integer ReflectionPad(1) 3×3 conv of integer-valued NHWC ``q``
    with HWIO int8 ``kq``, as im2col + a float64 matrix product (exact for
    integers below 2^53, whatever the summation order)."""
    b, h, w, c = q.shape
    cout = kq.shape[-1]
    zp = F.pad(q.double().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    cols = F.unfold(zp, 3)                                   # (B, C·9, H·W)
    wm = kq.permute(3, 2, 0, 1).reshape(cout, c * 9).double()  # OIHW rows
    return (wm @ cols).reshape(b, cout, h, w).permute(0, 2, 3, 1)


def conv3x3_reflect_fused_q_plain(x, kq, sc, *, qscale=None, mean=None, inv=None):
    """Plain version of ``conv3x3_reflect_fused_q``: the exact integer conv,
    dequantized in float32."""
    q = _quantize_input(x, qscale, mean, inv)
    y = _int_conv_reflect(q, kq).float() * sc[:, None, None, :]
    n = y.shape[1] * y.shape[2]
    m, i = _moments(y.sum(dim=(1, 2)), y.square().sum(dim=(1, 2)), n)
    return y.to(x.dtype), m, i


def conv3x3_reflect_fused_q(x, kq, sc, *, qscale=None, mean=None, inv=None):
    """int8 form: ``kq`` (3, 3, C, Cout) int8, ``sc`` (B, Cout) dequant
    scale, and exactly one of ``qscale`` (B,) = 127/amax (conv1: quantize
    the raw input) or ``mean``/``inv`` (conv2: normalize + ReLU, then the
    fixed 127/6 grid)."""
    if (mean is None) == (qscale is None):
        raise ValueError("need exactly one of qscale / (mean, inv)")
    if x.device.type == "cpu":
        return conv3x3_reflect_fused_q_plain(x, kq, sc, qscale=qscale, mean=mean, inv=inv)
    _check_conv(x, kq, mean, inv, _KBYTES)
    b, h, w, c = x.shape
    cout = kq.shape[-1]
    if kq.dtype != torch.int8:
        raise TypeError(f"kq: expected torch.int8, got {kq.dtype}")
    require(sc, "sc", torch.float32, (b, cout))
    if qscale is not None:
        require(qscale, "qscale", torch.float32, (b,))
    kc = _KBYTES
    wpk = kq.reshape(9, c // kc, kc, cout).permute(1, 0, 3, 2).contiguous()
    return _launch_conv(True, x, wpk, cout, mean=mean, inv=inv, qscale=qscale, sc=sc)


# --------------------------------------------------------------- blocks ----


def _block_epilogue(x, raw2, m2, i2):
    y = (raw2.float() - m2[:, None, None, :]) * i2[:, None, None, :]
    return x + y.to(x.dtype)


def resnet_block_pallas(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """One ResnetBlock: two fused conv launches + the elementwise epilogue.
    Conv biases are not applied: they are inert through instance norm."""
    raw1, m1, i1 = conv3x3_reflect_fused(x, k1)
    raw2, m2, i2 = conv3x3_reflect_fused(raw1, k2, m1, i1)
    return _block_epilogue(x, raw2, m2, i2)


def resnet_block_pallas_q(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """int8 ResnetBlock: the same schedule with both convs on int8 operands
    (per-channel weights; conv1 by the per-sample 127/amax of x, conv2 by
    the fixed 127/6 grid); the scales are absorbed by the instance norms."""
    b = x.shape[0]
    kq1, sw1 = quantize_weight_per_channel(k1)
    kq2, sw2 = quantize_weight_per_channel(k2)
    amax = torch.clamp(x.abs().amax(dim=(1, 2, 3)).float(), min=_AMAX_FLOOR)
    qs = 127.0 / amax
    sc1 = (amax / 127.0)[:, None] * sw1[None, :]
    raw1, m1, i1 = conv3x3_reflect_fused_q(x, kq1, sc1.contiguous(), qscale=qs)
    sc2 = ((_QCLIP / 127.0) * sw2[None, :]).expand(b, -1).contiguous()
    raw2, m2, i2 = conv3x3_reflect_fused_q(raw1, kq2, sc2, mean=m1, inv=i1)
    return _block_epilogue(x, raw2, m2, i2)
