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
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.kernels import (
    LAUNCHES,
    build,
    exported_op,
    on_input_card,
    require,
    stream_ptr,
)
from ircolor_tpu_torch.kernels.conv_int8 import int_conv_exact
from ircolor_tpu_torch.ops.norm import instance_norm_stats, instance_norm_vjp
from ircolor_tpu_torch.ops.quant import _QCLIP, quantize_weight_per_channel

_KS = 7
_SMEM_LIMIT = 227 * 1024
# csrc/head.cu's block: 122 output columns (a 128-pixel window, 8 m16
# tiles), 4 raw units in flight, a ring of 4 prepared units, two (24, 132)
# f32/int32 staging rows.
_TW, _NPIX, _NRAW, _NA, _NCOL, _QS = 122, 128, 4, 4, 24, 132
_SMS = 132  # the H100's SMs, for the plan's wave count

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("head")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ircolor_conv7x7_head.argtypes = [p] * 7 + [i] * 9 + [p]
        lib.ircolor_conv7x7_head.restype = i
        _lib = lib
    return _lib


class HeadPlan(NamedTuple):
    """One launch of ``csrc/head.cu``: ``kst`` MMA K steps a staged unit
    (16 channels each in bf16, 32 in s8), ``kc`` = its channels,
    ``nchunk`` units an input row (C rounded up to ``kc``), ``th`` output
    rows a block, the grid (122-column strips, row bands, images) and the
    dynamic shared memory."""

    quant: bool
    kst: int
    kc: int
    nchunk: int
    th: int
    grid: tuple[int, int, int]
    smem: int


def _tile_bytes(nks: int) -> int:
    """csrc/head.cu's ``Tile<NKS>::BYTES``: NKS K steps of 128 pixels × 32
    bytes, each step padded against bank conflicts."""
    return nks * (_NPIX * 32 + (32 if nks >= 3 else 128 // nks))


@functools.lru_cache(maxsize=64)
def _head_plan(b: int, h: int, w: int, c: int, quant: bool) -> HeadPlan:
    """The launch plan from the shapes alone. K: one unit of 1, 2 or 4 steps
    (the fewest that hold C; a staging thread's 8 channels must divide its
    warpgroup's 128 threads) up to 64 channels, else 64-channel units. Rows
    a block: of 128, 64, 32, 16, the one whose waves (one 512-thread block
    an SM) × input rows a block (th + 6) is least, the taller on a tie."""
    kstep = 32 if quant else 16
    kst = min(1 << (-(-c // kstep) - 1).bit_length(), 64 // kstep)
    kc = kst * kstep
    nchunk = -(-c // kc)
    cols = -(-w // _TW)

    def cost(th: int) -> int:
        return -(-b * cols * -(-h // th) // _SMS) * (min(th, h) + 6)

    th = min((128, 64, 32, 16), key=lambda t: (cost(t), -t))
    rks = 2 * kst if quant else kst  # bf16 K steps of a staged raw unit
    smem = (_NRAW * _tile_bytes(rks) + _NA * _tile_bytes(kst) + 2 * _NCOL * _QS * 4
            + 2 * nchunk * kc * 4)
    return HeadPlan(quant, kst, kc, nchunk, th, (cols, -(-h // th), b), smem)


@functools.lru_cache(maxsize=32)
def _head_index(c: int, kst: int, nchunk: int, quant: bool) -> torch.Tensor:
    """Where each B fragment element comes from: (nchunk, 7 dy, kst, 3 n8
    tiles, 32 lanes, E) flat indices into the (7, 7, C, 3) weights, -1 for
    a zero. Column n = 3·dx + co of N = 24 (21–23 zero); lane = 4g + t
    holds column 8·tile + g and, in register order, the K rows of the
    ``mma.sync`` B fragment: bf16 m16n8k16 (E = 4) 2t, 2t+1, 2t+8, 2t+9;
    s8 m16n8k32 (E = 8) 4t..4t+3, 4t+16..4t+19, of channel
    chunk·kc + step·(16 or 32) + k (past C: zero)."""
    kstep, ne = (32, 8) if quant else (16, 4)
    lane, e = torch.arange(32)[:, None], torch.arange(ne)[None, :]
    t = lane % 4
    k = 4 * t + e % 4 + 16 * (e // 4) if quant else 2 * t + e % 2 + 8 * (e // 2)
    n = (8 * torch.arange(3)[:, None] + torch.arange(32)[None, :] // 4)[None, None, None, :, :, None]
    ch = (torch.arange(nchunk)[:, None] * kst + torch.arange(kst)[None, :]) * kstep
    ch = ch[:, None, :, None, None, None] + k  # (nchunk, 1, kst, 1, 32, E)
    dy = torch.arange(_KS)[None, :, None, None, None, None]
    flat = ((dy * _KS + n // 3) * c + ch) * 3 + n % 3
    return torch.where((n < 21) & (ch < c), flat, -1).contiguous()


@functools.lru_cache(maxsize=32)
def _head_index_on(c: int, kst: int, nchunk: int, quant: bool, device: torch.device) -> torch.Tensor:
    """The index table as the kernel reads it: int32 on the card, made
    once per shape (no launch in a serving step)."""
    return _head_index(c, kst, nchunk, quant).to(torch.int32).to(device)


def _head_weights(kernel: torch.Tensor, plan: HeadPlan) -> torch.Tensor:
    """The B fragments the kernel reads from ``kernel`` (7, 7, C, 3), in
    ``_head_index``'s layout: each weight once, zeros elsewhere."""
    idx = _head_index(kernel.shape[2], plan.kst, plan.nchunk, plan.quant).to(kernel.device)
    vals = kernel.reshape(-1)[idx.clamp(min=0)]
    return torch.where(idx >= 0, vals, torch.zeros((), dtype=kernel.dtype, device=kernel.device))


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


def check_shape(b: int, h: int, w: int, c: int, kernel_shape: tuple, quant: bool) -> HeadPlan:
    """The card's guard: (7, 7, C, 3) weights, C % 8 (the staging's 16-byte
    loads; channels past C up to the unit are zero-filled, in both forms),
    H, W ≥ 4 (reflect padding by 3), B ≤ 65535, the plan's shared memory
    within the block's 227 KB. Returns the plan."""
    plan = _head_plan(b, h, w, c, quant)
    if (tuple(kernel_shape) != (_KS, _KS, c, 3) or c % 8 or h < 4 or w < 4 or b > 65535
            or plan.smem > _SMEM_LIMIT):
        raise ValueError(
            f"conv7x7 head kernel: unsupported x={(b, h, w, c)} "
            f"kernel={tuple(kernel_shape)} (needs (7, 7, C, 3), C % 8 == 0, "
            "H, W >= 4, B <= 65535)"
        )
    return plan


@on_input_card
def conv7x7_head_pallas(x, mean, inv, kernel, *, quant: bool = False):
    """(B, H, W, C) raw up2 conv output + per-(B, C) IN ``(mean, inv_std)``
    + (7, 7, C, Cout) weights → ``conv7×7_reflect3(relu((x−mean)·inv))``,
    (B, H, W, Cout). No bias, no tanh. ``quant=True``: the int8 form
    (weights quantized here per output channel, the input on the fixed
    127/6 grid in the kernel). In an export trace the op
    ``ircolor::conv7x7_head``."""
    if (traced := exported_op("conv7x7_head")) is not None:
        return traced(x, mean, inv, kernel, quant)
    if x.device.type == "cpu":
        plain = conv7x7_head_q_plain if quant else conv7x7_head_plain
        return plain(x, mean, inv, kernel)
    b, h, w, c = x.shape
    require(x, "x", torch.bfloat16, (None, None, None, None))
    require(mean, "mean", torch.float32, (b, c))
    require(inv, "inv", torch.float32, (b, c))
    plan = check_shape(b, h, w, c, tuple(kernel.shape), quant)
    if x.data_ptr() % 16:
        raise ValueError("conv7x7 head kernel: x must start on a 16-byte boundary (cp.async)")
    if quant:  # the generator passes an HWIO view of its OIHW weight
        wt, sc = _quantize_head_weight(kernel)
        wt = wt.contiguous()
        require(wt, "kernel", torch.int8, (_KS, _KS, c, 3))
        sc_ptr = sc.contiguous().data_ptr()
    else:
        wt, sc_ptr = kernel.to(torch.bfloat16).contiguous(), None
        require(wt, "kernel", torch.bfloat16, (_KS, _KS, c, 3))
    bidx = _head_index_on(c, plan.kst, plan.nchunk, quant, x.device)
    out = torch.empty((b, h, w, 3), dtype=x.dtype, device=x.device)
    name = "conv7x7_head_q" if quant else "conv7x7_head"
    err = _load().ircolor_conv7x7_head(
        x.data_ptr(), mean.data_ptr(), inv.data_ptr(), wt.data_ptr(), bidx.data_ptr(),
        sc_ptr, out.data_ptr(), b, h, w, c, int(quant), plan.kst, plan.th, plan.nchunk,
        plan.smem, stream_ptr(x),
    )
    build.check(err, name)
    LAUNCHES[name] += 1
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
