"""Fused instance norm (+ ReLU, or + residual) of NHWC planes
(``csrc/instance_norm.cu``): TPU kernel 11.

Counterpart of ``ircolor_tpu/ops/pallas_kernels.py``: ``_pick_cb`` and
``pallas_fits`` (the JAX kernel's VMEM gate, copied with its constants: it
decides where the kernel runs, as it does there), ``run_in`` / ``run_in_res``
(the kernel launches), ``fused_instance_norm`` / ``fused_instance_norm_residual``
(differentiable: the backward is the JAX ``_fin_bwd`` / ``_finr_bwd`` math in
plain torch, reading only the saved input) and ``instance_norm_auto``.

The plain versions take the JAX kernel's steps in float32: the mean, the
centered variance, ``rsqrt(var + 1e-5)``, the optional ReLU or ``+ r``, then
one cast to x's dtype. The CUDA kernel slices channels its own way (32 bytes
a block); ``_pick_cb``'s channel block is only the gate.
"""

from __future__ import annotations

import ctypes

import torch

from ircolor_tpu_torch.kernels import LAUNCHES, build, on_input_card, require, stream_ptr
from ircolor_tpu_torch.ops.norm import instance_norm

# The JAX kernel's budget: 12 double-buffered plane-equivalents (16 with a
# residual) of one channel block within 30 MB of VMEM.
_VMEM_BUDGET_BYTES = 30 * 1024 * 1024
_EPS = 1e-5
_MODES = {"plain": 0, "relu": 1, "residual": 2}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("instance_norm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ircolor_instance_norm.argtypes = [i, i, i, p, p, p, i, i, i, i, p]
        lib.ircolor_instance_norm.restype = i
        _lib = lib
    return _lib


def _plane_bytes(h: int, w: int, cb: int, dtype: torch.dtype) -> int:
    return h * w * cb * dtype.itemsize


def _pick_cb(shape: tuple, dtype: torch.dtype, with_residual: bool) -> int | None:
    """The JAX kernel's channel block: 128 (where C % 128 == 0) or C, the
    first whose planes fit the budget; None where neither does."""
    if len(shape) != 4:
        return None
    _, h, w, c = shape
    n_planes = 16 if with_residual else 12
    candidates = ([128] if c % 128 == 0 else []) + [c]
    for cb in candidates:
        if n_planes * _plane_bytes(h, w, cb, dtype) <= _VMEM_BUDGET_BYTES:
            return cb
    return None


def pallas_fits(shape: tuple, dtype: torch.dtype, with_residual: bool = False) -> bool:
    """True where the JAX package runs kernel 11 for this shape and dtype."""
    return _pick_cb(tuple(shape), dtype, with_residual) is not None


def _check_fits(x: torch.Tensor, with_residual: bool) -> None:
    if not pallas_fits(tuple(x.shape), x.dtype, with_residual):
        raise ValueError(f"shape {tuple(x.shape)} {x.dtype} does not fit the fused IN kernel's gate")


def _normalize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x̂, inv_std) in float32: the mean, the centered variance, rsqrt."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    centered = x32 - mean
    var = (centered * centered).mean(dim=(1, 2), keepdim=True)
    inv = torch.rsqrt(var + _EPS)
    return centered * inv, inv


def fused_instance_norm_plain(x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """Plain version of ``run_in``."""
    y = _normalize(x)[0]
    return (torch.relu(y) if relu else y).to(x.dtype)


def fused_instance_norm_residual_plain(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain version of ``run_in_res``."""
    return (_normalize(x)[0] + r.float()).to(x.dtype)


@on_input_card
def _launch(mode: str, x: torch.Tensor, r: torch.Tensor | None) -> torch.Tensor:
    b, h, w, c = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x: expected torch.bfloat16 or torch.float32, got {x.dtype}")
    require(x, "x", x.dtype, (None, None, None, None))
    if r is not None:
        require(r, "r", x.dtype, (b, h, w, c))
    if b > 65535:
        raise ValueError(f"fused IN kernel: batch {b} > 65535")
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, r, out) if t is not None]
    vec = int(c % (16 // x.itemsize) == 0 and all(p % 16 == 0 for p in ptrs))
    err = _load().ircolor_instance_norm(
        int(x.dtype == torch.float32), _MODES[mode], vec, x.data_ptr(),
        None if r is None else r.data_ptr(), out.data_ptr(), b, h, w, c, stream_ptr(x),
    )
    name = "fused_instance_norm_residual" if r is not None else "fused_instance_norm"
    build.check(err, name)
    LAUNCHES[name] += 1
    return out


def run_in(x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """IN (+ ReLU) of NHWC ``x`` (bf16 or f32; a shape ``pallas_fits``
    admits), in one kernel launch; the plain version for a CPU tensor."""
    _check_fits(x, False)
    if x.device.type == "cpu":
        return fused_instance_norm_plain(x, relu)
    return _launch("relu" if relu else "plain", x, None)


def run_in_res(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``IN(x) + r`` in one kernel launch (a ResnetBlock's second half)."""
    _check_fits(x, True)
    if x.device.type == "cpu":
        return fused_instance_norm_residual_plain(x, r)
    return _launch("residual", x, r)


def _in_bwd(x: torch.Tensor, g: torch.Tensor, relu: bool) -> torch.Tensor:
    """The JAX ``_fin_bwd``: recompute x̂ from x; dx = (g − E[g] − x̂·E[g·x̂])·inv."""
    xhat, inv = _normalize(x)
    g32 = g.float()
    if relu:
        g32 = torch.where(xhat > 0, g32, torch.zeros_like(g32))
    gm = g32.mean(dim=(1, 2), keepdim=True)
    gx = (g32 * xhat).mean(dim=(1, 2), keepdim=True)
    return ((g32 - gm - xhat * gx) * inv).to(x.dtype)


class _FusedIN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, relu):
        ctx.save_for_backward(x)
        ctx.relu = relu
        return run_in(x, relu)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _in_bwd(x, g, ctx.relu), None


class _FusedINResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r):
        ctx.save_for_backward(x)
        ctx.r_dtype = r.dtype
        return run_in_res(x, r)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _in_bwd(x, g, False), g.to(ctx.r_dtype)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def fused_instance_norm(x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """Single-pass IN (+ ReLU); differentiable in x."""
    if _needs_grad(x):
        return _FusedIN.apply(x, relu)
    return run_in(x, relu)


def fused_instance_norm_residual(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Single-pass ``r + IN(x)``; differentiable in x and r."""
    if _needs_grad(x, r):
        return _FusedINResidual.apply(x, r)
    return run_in_res(x, r)


def instance_norm_auto(
    x: torch.Tensor,
    *,
    relu: bool = False,
    residual: torch.Tensor | None = None,
    use_pallas: bool = True,
) -> torch.Tensor:
    """The fused kernel where ``pallas_fits`` admits the shape, else the
    two-pass plain ops (``ops.norm.instance_norm``, then ReLU or + residual
    in x's dtype), as the JAX function picks."""
    if use_pallas and pallas_fits(tuple(x.shape), x.dtype, residual is not None):
        if residual is not None:
            return fused_instance_norm_residual(x, residual)
        return fused_instance_norm(x, relu)
    y = instance_norm(x)
    if relu:
        y = torch.relu(y)
    if residual is not None:
        y = y + residual
    return y
