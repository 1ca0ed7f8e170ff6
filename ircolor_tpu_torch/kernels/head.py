"""Fused 7×7 output head: up2's IN-normalize + ReLU + ReflectionPad(3) + the
7×7 conv to 3 channels (``csrc/head.cu``).

Counterpart of ``ircolor_tpu/ops/pallas_head.py``: ``conv7x7_head_pallas``
(float form; the int8 form ``quant=True`` is not ported yet) and
``outc_head`` (stats by a plain reduction, then the kernel). The caller adds
the bias and the tanh.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.kernels import LAUNCHES, build, require, stream_ptr
from ircolor_tpu_torch.ops.norm import instance_norm_stats

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
        _lib = lib
    return _lib


def conv7x7_head_plain(x, mean, inv, kernel):
    """Plain version: the normalized input rounded to x's dtype, the conv in
    float32, the result rounded to x's dtype."""
    z = torch.relu((x.float() - mean[:, None, None, :]) * inv[:, None, None, :])
    z = z.to(x.dtype).float().permute(0, 3, 1, 2)
    zp = F.pad(z, (3, 3, 3, 3), mode="reflect")
    k = kernel.to(x.dtype).float().permute(3, 2, 0, 1)
    return F.conv2d(zp, k).permute(0, 2, 3, 1).to(x.dtype)


def conv7x7_head_pallas(x, mean, inv, kernel):
    """(B, H, W, C) raw up2 conv output + per-(B, C) IN ``(mean, inv_std)``
    + (7, 7, C, Cout) weights → ``conv7×7_reflect3(relu((x−mean)·inv))``,
    (B, H, W, Cout). No bias, no tanh."""
    if x.device.type == "cpu":
        return conv7x7_head_plain(x, mean, inv, kernel)
    b, h, w, c = x.shape
    require(x, "x", torch.bfloat16, (None, None, None, None))
    require(mean, "mean", torch.float32, (b, c))
    require(inv, "inv", torch.float32, (b, c))
    lib = _load()
    if (
        tuple(kernel.shape) != (_KS, _KS, c, 3)
        or c % 8
        or h < 4
        or w < 4
        or lib.ircolor_conv7x7_head_smem_bytes(c) > _SMEM_LIMIT
    ):
        raise ValueError(
            f"conv7x7 head kernel: unsupported x={tuple(x.shape)} "
            f"kernel={tuple(kernel.shape)} (needs (7, 7, C, 3), C % 8 == 0, "
            "H, W >= 4)"
        )
    wf = kernel.to(torch.bfloat16).float().contiguous()
    out = torch.empty((b, h, w, 3), dtype=x.dtype, device=x.device)
    err = lib.ircolor_conv7x7_head(
        x.data_ptr(), mean.data_ptr(), inv.data_ptr(), wf.data_ptr(),
        out.data_ptr(), b, h, w, c, stream_ptr(),
    )
    build.check(err, "conv7x7_head")
    LAUNCHES["conv7x7_head"] += 1
    return out


def outc_head(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``conv7×7_reflect3(relu(IN(x)))``: one-pass IN stats, then the fused
    head (bias and tanh are the caller's)."""
    mean, inv = instance_norm_stats(x)
    return conv7x7_head_pallas(x, mean, inv, kernel)


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
