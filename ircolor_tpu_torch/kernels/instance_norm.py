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

Row 11h, the shard form (``fused_instance_norm_spatial``,
``fused_instance_norm_residual_spatial``, ``instance_norm_auto_spatial``):
the plane held as a list of H-shards (``parallel/spatial.py``), whose
instance norm is the whole plane's. The JAX package's GSPMD gates kernel 11
on the global shape and runs it on the gathered plane; here nothing is
gathered. Each shard's (count, mean, centred sum of squares M2) per image
and channel comes from one stats launch over its own rows; the host merges
them in plain torch, in shard order on shard 0's device, by Chan's rule
(mean = Σ nᵢ·meanᵢ / n, M2 = Σ M2ᵢ + Σ nᵢ·(meanᵢ − mean)², inv =
rsqrt(M2 / n + 1e-5)), which keeps the centred two-pass accuracy without a
third read of x; one apply launch a shard then normalizes (+ ReLU | + r)
with one rounding. An empty shard gives n = 0 and adds nothing. The
backward is the IN backward in plain torch with the two plane means (of g
and of g·x̂) summed across the shards.
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
from ircolor_tpu_torch.ops.norm import instance_norm, instance_norm_spatial
from ircolor_tpu_torch.parallel.spatial import all_sum

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
        lib.ircolor_instance_norm_stats.argtypes = [i, i, p, p, p, i, i, i, i, p]
        lib.ircolor_instance_norm_stats.restype = i
        lib.ircolor_instance_norm_apply.argtypes = [i, i, i, p, p, p, p, p, i, i, i, i, p]
        lib.ircolor_instance_norm_apply.restype = i
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
    admits), in one kernel launch; the plain version for a CPU tensor; in
    an export trace the op ``ircolor::run_in``."""
    _check_fits(x, False)
    if (traced := exported_op("run_in")) is not None:
        return traced(x, relu)
    if x.device.type == "cpu":
        return fused_instance_norm_plain(x, relu)
    return _launch("relu" if relu else "plain", x, None)


def run_in_res(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``IN(x) + r`` in one kernel launch (a ResnetBlock's second half); in
    an export trace the op ``ircolor::run_in_res``."""
    _check_fits(x, True)
    if (traced := exported_op("run_in_res")) is not None:
        return traced(x, r)
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


# --- row 11h: the shard form ---------------------------------------------


def _global_shape(xs) -> tuple:
    b, _, w, c = xs[0].shape
    return (b, sum(x.shape[1] for x in xs), w, c)


def shard_stats_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the stats launch: (mean, M2), (B, C) float32, over
    the shard's H × W plane (zeros for an empty shard)."""
    x32 = x.float()
    if x.shape[1] == 0:
        z = x32.new_zeros((x.shape[0], x.shape[3]))
        return z, z.clone()
    mean = x32.mean(dim=(1, 2))
    return mean, (x32 - mean[:, None, None, :]).square().sum(dim=(1, 2))


def shard_apply_plain(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor, relu: bool = False,
                      r: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the apply launch: (x − mean)·inv, + ReLU or + r, one
    cast to x's dtype."""
    y = (x.float() - mean[:, None, None, :]) * inv[:, None, None, :]
    if relu:
        y = torch.relu(y)
    if r is not None:
        y = y + r.float()
    return y.to(x.dtype)


def merge_shard_stats(parts: list, eps: float = _EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Chan's merge of the shards' ``(n, mean, M2)`` in shard order on shard
    0's device: the plane's (mean, inverse std), (B, C) float32."""
    dev = parts[0][1].device
    n = sum(p[0] for p in parts)
    mean = None
    for ni, mi, _ in parts:
        if ni:
            term = mi.to(dev) * float(ni)
            mean = term if mean is None else mean + term
    mean = mean / float(n)
    m2 = None
    for ni, mi, qi in parts:
        if ni:
            term = qi.to(dev) + (mi.to(dev) - mean).square() * float(ni)
            m2 = term if m2 is None else m2 + term
    return mean, torch.rsqrt(m2 / float(n) + eps)


def _shard_dtype(x: torch.Tensor) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x: expected torch.bfloat16 or torch.float32, got {x.dtype}")


def _vec(x: torch.Tensor, *ts) -> int:
    return int(x.shape[-1] % (16 // x.itemsize) == 0
               and all(t.data_ptr() % 16 == 0 for t in (x, *ts) if t is not None))


@on_input_card
def _launch_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    b, h, w, c = x.shape
    _shard_dtype(x)
    require(x, "x", x.dtype, (None, None, None, None))
    if b > 65535:
        raise ValueError(f"fused IN kernel: batch {b} > 65535")
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    m2 = torch.empty_like(mean)
    err = _load().ircolor_instance_norm_stats(
        int(x.dtype == torch.float32), _vec(x), x.data_ptr(), mean.data_ptr(), m2.data_ptr(),
        b, h, w, c, stream_ptr(x))
    build.check(err, "fused_instance_norm shard stats")
    return mean, m2


@on_input_card
def _launch_apply(mode: str, x: torch.Tensor, r: torch.Tensor | None, mean: torch.Tensor,
                  inv: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    require(x, "x", x.dtype, (None, None, None, None))
    if r is not None:
        require(r, "r", x.dtype, (b, h, w, c))
    require(mean, "mean", torch.float32, (b, c))
    require(inv, "inv", torch.float32, (b, c))
    out = torch.empty_like(x)
    err = _load().ircolor_instance_norm_apply(
        int(x.dtype == torch.float32), _MODES[mode], _vec(x, r, out), x.data_ptr(),
        None if r is None else r.data_ptr(), mean.data_ptr(), inv.data_ptr(), out.data_ptr(),
        b, h, w, c, stream_ptr(x))
    build.check(err, "fused_instance_norm shard apply")
    return out


def _run_in_spatial(xs, relu: bool, residuals, plain: bool = False):
    """``run_in_spatial``'s shards and the plane's (mean, inv) on shard 0's
    device; with ``plain`` every shard on the plain versions."""
    _check_fits(torch.empty(_global_shape(xs), dtype=xs[0].dtype, device="meta"),
                residuals is not None)
    parts = []
    for x in xs:
        _shard_dtype(x)
        n = x.shape[1] * x.shape[2]
        if plain or n == 0 or x.device.type == "cpu":
            parts.append((n, *shard_stats_plain(x)))
        else:
            parts.append((n, *_launch_stats(x)))
    mean, inv = merge_shard_stats(parts)
    name = "fused_instance_norm_residual_halo" if residuals is not None else "fused_instance_norm_halo"
    mode = "residual" if residuals is not None else ("relu" if relu else "plain")
    out = []
    for i, x in enumerate(xs):
        r = None if residuals is None else residuals[i]
        m, v = mean.to(x.device), inv.to(x.device)
        if plain or x.shape[1] == 0 or x.device.type == "cpu":
            out.append(shard_apply_plain(x, m, v, relu, r))
        else:
            out.append(_launch_apply(mode, x, r, m, v))
            LAUNCHES[name] += 1
    return out, mean, inv


def run_in_spatial(xs, relu: bool = False, residuals=None) -> list[torch.Tensor]:
    """Row 11h: IN (+ ReLU, or + r) of the plane whose H-shards are ``xs``
    (bf16 or f32; a global shape ``pallas_fits`` admits), one output shard
    each. A CUDA shard takes two launches (its stats, then its apply after
    the merge) and adds one to ``fused_instance_norm(_residual)_halo``; a
    CPU shard runs the plain versions; an empty shard neither."""
    return _run_in_spatial(xs, relu, residuals)[0]


def run_in_spatial_plain(xs, relu: bool = False, residuals=None) -> list[torch.Tensor]:
    """Plain version of ``run_in_spatial``, on any device: each shard's
    statistics and output by ``shard_stats_plain`` and
    ``shard_apply_plain``, the same merge."""
    return _run_in_spatial(xs, relu, residuals, plain=True)[0]


def _in_bwd_spatial(xs, gs, mean, inv, relu: bool) -> list[torch.Tensor]:
    """``_in_bwd`` over the shards: x̂ from each shard and the plane's
    (mean, inv); E[g] and E[g·x̂] as sums across the shards over the plane's
    count."""
    n = sum(x.shape[1] * x.shape[2] for x in xs)
    xhat, g32 = [], []
    for x, g in zip(xs, gs):
        xh = (x.float() - mean.to(x.device)[:, None, None, :]) * inv.to(x.device)[:, None, None, :]
        gf = g.float()
        if relu:
            gf = torch.where(xh > 0, gf, torch.zeros_like(gf))
        xhat.append(xh)
        g32.append(gf)
    gm = all_sum([g.sum(dim=(1, 2), keepdim=True) for g in g32])
    gx = all_sum([(g * xh).sum(dim=(1, 2), keepdim=True) for g, xh in zip(g32, xhat)])
    return [((g - a / n - xh * (b / n)) * inv.to(x.device)[:, None, None, :]).to(x.dtype)
            for x, g, xh, a, b in zip(xs, g32, xhat, gm, gx)]


class _FusedINSpatial(torch.autograd.Function):
    """Row 11h over every shard; ``ts`` are the S input shards, then the S
    residual shards where ``with_res``."""

    @staticmethod
    def forward(ctx, relu, with_res, *ts):
        s = len(ts) // 2 if with_res else len(ts)
        xs, rs = list(ts[:s]), (list(ts[s:]) if with_res else None)
        out, mean, inv = _run_in_spatial(xs, relu, rs)
        ctx.save_for_backward(*xs, mean, inv)
        ctx.relu, ctx.s = relu, s
        ctx.r_dtypes = None if rs is None else [r.dtype for r in rs]
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        xs, mean, inv = list(saved[: ctx.s]), saved[ctx.s], saved[ctx.s + 1]
        dxs = _in_bwd_spatial(xs, gs, mean, inv, ctx.relu)
        drs = [] if ctx.r_dtypes is None else [g.to(dt) for g, dt in zip(gs, ctx.r_dtypes)]
        return (None, None, *dxs, *drs)


def fused_instance_norm_spatial(xs, relu: bool = False) -> list[torch.Tensor]:
    """``fused_instance_norm`` of the plane whose H-shards are ``xs``
    (row 11h); differentiable in every shard."""
    if _needs_grad(*xs):
        return list(_FusedINSpatial.apply(relu, False, *xs))
    return run_in_spatial(xs, relu)


def fused_instance_norm_residual_spatial(xs, rs) -> list[torch.Tensor]:
    """``fused_instance_norm_residual`` on H-shards: ``r + IN(x)`` shard by
    shard with the plane's statistics; differentiable in x and r."""
    if _needs_grad(*xs, *rs):
        return list(_FusedINSpatial.apply(False, True, *xs, *rs))
    return run_in_spatial(xs, residuals=rs)


def instance_norm_auto_spatial(xs, *, relu: bool = False, residuals=None,
                               use_pallas: bool = True) -> list[torch.Tensor]:
    """``instance_norm_auto`` on H-shards: row 11h where ``pallas_fits``
    admits the global shape (the shard heights summed), as the JAX
    package's GSPMD gate sees it; else the two-pass plain ops across the
    shards (``ops.norm.instance_norm_spatial``), then ReLU or + r."""
    if use_pallas and pallas_fits(_global_shape(xs), xs[0].dtype, residuals is not None):
        if residuals is not None:
            return fused_instance_norm_residual_spatial(xs, residuals)
        return fused_instance_norm_spatial(xs, relu)
    ys = instance_norm_spatial(xs)
    if relu:
        ys = [torch.relu(y) for y in ys]
    if residuals is not None:
        ys = [y + r for y, r in zip(ys, residuals)]
    return ys
