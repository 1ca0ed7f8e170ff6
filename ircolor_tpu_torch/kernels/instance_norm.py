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
and channel is kernel 11's passes 1 and 2 over its own rows; Chan's rule
merges them in shard order (mean = Σ nᵢ·meanᵢ / n, M2 = Σ (M2ᵢ + nᵢ·(meanᵢ −
mean)²), inv = 1 / sqrt(M2 / n + 1e-5)), which keeps the centred two-pass
accuracy without a third read of x; pass 3 then normalizes each shard (+
ReLU | + r) with one rounding. An empty shard gives n = 0 and adds nothing.
``halo_plan`` picks the form from where the shards are: every shard on one
card and S ≤ 8, the cluster form (one launch: a cluster of S blocks an
(image, channel slice), the shards' statistics merged through distributed
shared memory, nothing on the host between); any other CUDA layout, the
per-shard form (a stats launch a shard, the S partials copied to each
shard's card, an apply launch a shard that merges them itself); CPU
shards, the plain versions. The kernels' merge is one ``__device__``
function, and ``merge_shard_stats`` takes its steps in torch. The backward
is the IN backward in plain torch with the two plane means (of g and of
g·x̂) summed across the shards, from the forward's saved (mean, inv).

Its tile form: the plane held as a grid of tiles (test mode's 2-D H×W mesh,
``parallel/spatial.py``), Sh rows of Sw tiles, each tile its own rows and
columns. A tile is a shard of rows·columns pixels: its (count, mean, M2)
are the same passes over its own pixels, and the merge takes the tiles in
one fixed order, row by row (``parallel.spatial.tiles``), in the kernels,
in ``merge_shard_stats`` and in the plain version alike. Every cluster
rank and every per-shard launch carries its tile's rows, columns and
pointers, so the cluster form takes Sh·Sw ≤ 8 tiles of one plane on one
card (2×2, 4×2) and the per-shard form any count. A 1-D mesh is the Sw = 1
case, every shard the plane's width (``halo_plan`` is ``tile_plan`` with
every shard's columns the plane's). The tile form has no backward: 2-D
tiling serves only, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from dataclasses import dataclass

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
from ircolor_tpu_torch.parallel.spatial import (
    all_sum,
    image_shape,
    on_shards,
    regrid,
    tiled,
    tiles,
)
from ircolor_tpu_torch.utils.timing import span

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
        lib.ircolor_instance_norm_stats.argtypes = [i, i, i, p, p, p, i, i, i, i, p]
        lib.ircolor_instance_norm_stats.restype = i
        ints, ptrs = ctypes.POINTER(i), ctypes.POINTER(p)
        lib.ircolor_instance_norm_apply.argtypes = [i, i, i, i, p, p, p, ints, i, p, p, p, i, i, i,
                                                    i, p]
        lib.ircolor_instance_norm_apply.restype = i
        lib.ircolor_instance_norm_cluster.argtypes = [i, i, i, i, i, ptrs, ptrs, ptrs, ints, ints,
                                                      p, p, i, i, i, p]
        lib.ircolor_instance_norm_cluster.restype = i
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


def _check_fits_shape(shape: tuple, dtype: torch.dtype, with_residual: bool) -> None:
    if not pallas_fits(shape, dtype, with_residual):
        raise ValueError(f"shape {tuple(shape)} {dtype} does not fit the fused IN kernel's gate")


def _check_fits(x: torch.Tensor, with_residual: bool) -> None:
    _check_fits_shape(tuple(x.shape), x.dtype, with_residual)


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
    name = "fused_instance_norm_residual" if r is not None else "fused_instance_norm"
    with span("kernel." + name):
        out = torch.empty_like(x)
        ptrs = [t.data_ptr() for t in (x, r, out) if t is not None]
        vec = int(c % (16 // x.itemsize) == 0 and all(p % 16 == 0 for p in ptrs))
        err = _load().ircolor_instance_norm(
            int(x.dtype == torch.float32), _MODES[mode], vec, x.data_ptr(),
            None if r is None else r.data_ptr(), out.data_ptr(), b, h, w, c, stream_ptr(x),
        )
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

# The shard forms' limits (``csrc/instance_norm.cu``): the portable cluster
# size (the cluster form's largest S), a block's dynamic shared memory, the
# per-shard form's count table, a block's warps.
CLUSTER_MAX = 8
_MAX_SMEM = 232448
_MAX_SHARDS = 256
_NWARPS = 16
_NO_CLUSTER = -1  # the cluster launch's code where no cluster fits the card


def _shard_head_bytes(dtype: torch.dtype, slice_bytes: int) -> int:
    """Shared memory ahead of a shard form block's staged plane: per-warp
    partial sums, the shard's (mean, M2), the plane's (mean, inv)."""
    return (_NWARPS + 4) * (slice_bytes // dtype.itemsize) * 4


def _slice_bytes(pixels: tuple, c: int, dtype: torch.dtype) -> int:
    """A shard form block's channel slice: 64 bytes where C holds that many
    and the largest shard's (of ``pixels`` each) 64-byte slice plane fits
    in shared memory with the head (on the H100 at the 16×64×64×256
    bottleneck, S = 2: 0.036 ms a cluster launch against 0.048 at 32
    bytes, ``tools/in_halo_probe.py``: one CTA a SM in two full waves),
    else 32. Both forms take the same, so their sums run in the same
    order."""
    fits = _shard_head_bytes(dtype, 64) + max(pixels) * 64 <= _MAX_SMEM
    return 64 if fits and c * dtype.itemsize >= 64 else 32


@dataclass(frozen=True)
class HaloPlan:
    """How a row-11h call runs. ``form``: "cluster" (one launch), "per_shard"
    (a stats and an apply launch a shard) or "plain"; ``cluster``: the
    cluster size (S in the cluster form, else 0); ``starts`` / ``rows`` /
    ``cols``: the rows before each shard in shard order (a 1-D mesh: its
    first row in the plane), its rows and its columns; ``slice_bytes``: a
    block's channel slice in both kernel forms (0 for "plain"); in the
    cluster form ``staged``: each CTA's staged bytes (0: the CTA reads x
    again), ``stage_cap``: the launch's staging bytes (the largest of
    ``staged``), ``smem``: a CTA's dynamic shared memory (the head and the
    stage)."""

    form: str
    cluster: int
    starts: tuple
    rows: tuple
    slice_bytes: int = 0
    staged: tuple = ()
    stage_cap: int = 0
    smem: int = 0
    cols: tuple = ()


def halo_form(devices, per_shard: bool = False) -> str:
    """The form for shards (or tiles) on ``devices``: every one on the CPU →
    "plain"; every one on one card and at most ``CLUSTER_MAX`` → "cluster"
    (unless ``per_shard``); any other CUDA layout → "per_shard"."""
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "plain"
    if kinds != {"cuda"}:
        raise ValueError(f"row 11h: shards on {sorted(kinds)}; every shard must be on the CPU, "
                         "or every one on a card")
    if not per_shard and len(devices) <= CLUSTER_MAX and len({d.index for d in devices}) == 1:
        return "cluster"
    return "per_shard"


@functools.lru_cache(maxsize=256)
def tile_plan(heights: tuple, cols: tuple, c: int, dtype: torch.dtype, devices: tuple,
              per_shard: bool = False) -> HaloPlan:
    """The launch plan of a row-11h call on shards (or tiles, in tile
    order) of ``heights`` rows and ``cols`` columns of a plane of ``c``
    channels on ``devices``: the form, the cluster size, the shard table,
    the channel slice, and each cluster CTA's staged bytes (its shard's
    slice plane, rows·cols·slice bytes, where that fits in a block's
    shared memory with the head; else 0)."""
    form = halo_form(devices, per_shard)
    table = (tuple(itertools.accumulate((0, *heights[:-1]))), tuple(heights))
    if form == "plain":
        return HaloPlan(form, 0, *table, cols=cols)
    pixels = tuple(h * w for h, w in zip(heights, cols))
    sb = _slice_bytes(pixels, c, dtype)
    if form == "per_shard":
        return HaloPlan(form, 0, *table, sb, cols=cols)
    head = _shard_head_bytes(dtype, sb)
    staged = tuple(n * sb if head + n * sb <= _MAX_SMEM else 0 for n in pixels)
    return HaloPlan(form, len(heights), *table, sb, staged, max(staged), head + max(staged), cols)


def halo_plan(heights: tuple, w: int, c: int, dtype: torch.dtype, devices: tuple,
              per_shard: bool = False) -> HaloPlan:
    """``tile_plan`` of H-shards of ``heights`` rows of a (B, ·, w, c)
    plane: every shard ``w`` columns."""
    return tile_plan(tuple(heights), (w,) * len(heights), c, dtype, tuple(devices), per_shard)


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
    """Plain version of pass 3: (x − mean)·inv, + ReLU or + r, one cast to
    x's dtype."""
    y = (x.float() - mean[:, None, None, :]) * inv[:, None, None, :]
    if relu:
        y = torch.relu(y)
    if r is not None:
        y = y + r.float()
    return y.to(x.dtype)


def merge_shard_stats(parts: list, eps: float = _EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Chan's merge of the shards' ``(n, mean, M2)`` in shard order on shard
    0's device, the plane's (mean, inverse std), (B, C) float32: the steps
    of the kernels' ``merge_parts``, one IEEE rounding each, mean = (Σ
    nᵢ·meanᵢ) / n, M2 = Σ (M2ᵢ + nᵢ·(meanᵢ − mean)²), inv = 1 / sqrt(M2 / n
    + eps). An empty shard adds nothing. n divides as a tensor, so that a
    card divides too (it multiplies by the reciprocal of a scalar); the
    square root is taken in float64 and rounded once to float32, which is
    the correctly rounded float32 root (``__fsqrt_rn``; the CPU's float32
    ``torch.sqrt`` is off by an ulp on ~0.7% of inputs)."""
    dev = parts[0][1].device
    n = torch.full_like(parts[0][1].to(dev), float(sum(p[0] for p in parts)))
    mean = torch.zeros_like(n)
    for ni, mi, _ in parts:
        if ni:
            mean = mean + mi.to(dev) * float(ni)
    mean = mean / n
    m2 = torch.zeros_like(n)
    for ni, mi, qi in parts:
        if ni:
            m2 = m2 + (qi.to(dev) + (mi.to(dev) - mean).square() * float(ni))
    return mean, 1 / torch.sqrt((m2 / n + eps).double()).float()


def _shard_dtype(x: torch.Tensor) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x: expected torch.bfloat16 or torch.float32, got {x.dtype}")


def _vec_all(*groups) -> int:
    """1 where C allows 16-byte units and every non-empty shard's x, r and
    out is 16-byte aligned: one rule for both forms, so that their sums
    run in the same order."""
    x = groups[0][0]
    if x.shape[-1] % (16 // x.itemsize):
        return 0
    return int(all(t.data_ptr() % 16 == 0 for g in groups if g is not None for t in g
                   if t.numel()))


def _require_shards(xs, rs) -> None:
    b, _, _, c = xs[0].shape
    if b > 65535:
        raise ValueError(f"fused IN kernel: batch {b} > 65535")
    for i, x in enumerate(xs):
        require(x, f"x[{i}]", xs[0].dtype, (b, None, None, c))
        if rs is not None:
            require(rs[i], f"r[{i}]", x.dtype, tuple(x.shape))


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


@on_input_card
def _launch_cluster(mode: str, xs, rs, plan: HaloPlan):
    """The cluster form: one launch over every shard or tile (all on this
    card), each with its own rows and columns."""
    _require_shards(xs, rs)
    b, _, _, c = xs[0].shape
    outs = [torch.empty_like(x) for x in xs]
    mean, inv = torch.empty((2, b, c), dtype=torch.float32, device=xs[0].device)
    err = _load().ircolor_instance_norm_cluster(
        int(xs[0].dtype == torch.float32), _MODES[mode], _vec_all(xs, rs, outs), plan.slice_bytes,
        len(xs), _ptrs(xs), None if rs is None else _ptrs(rs), _ptrs(outs),
        (ctypes.c_int * len(xs))(*plan.rows), (ctypes.c_int * len(xs))(*plan.cols),
        mean.data_ptr(), inv.data_ptr(), b, c, plan.stage_cap, stream_ptr(xs[0]))
    if err == _NO_CLUSTER:
        raise RuntimeError(f"row 11h: no cluster of {plan.cluster} blocks with {plan.smem} bytes "
                           "of shared memory each fits the card")
    build.check(err, "fused_instance_norm shard cluster")
    return outs, mean, inv


@on_input_card
def _launch_stats(x: torch.Tensor, vec: int, slice_bytes: int) -> torch.Tensor:
    """The per-shard form's stats launch: (2, B, C) float32, the shard's
    mean and M2."""
    b, h, w, c = x.shape
    part = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    err = _load().ircolor_instance_norm_stats(
        int(x.dtype == torch.float32), vec, slice_bytes, x.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), b, h, w, c, stream_ptr(x))
    build.check(err, "fused_instance_norm shard stats")
    return part


@on_input_card
def _launch_apply(mode: str, x: torch.Tensor, r, out: torch.Tensor, table: torch.Tensor, counts,
                  vec: int, slice_bytes: int, save: bool):
    """The per-shard form's apply launch: the merge of ``table`` ((S, 2, B,
    C) on x's card) and pass 3 into ``out``; with ``save`` it also returns
    the plane's (mean, inv)."""
    b, h, w, c = x.shape
    mean = inv = None
    if save:
        mean, inv = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    err = _load().ircolor_instance_norm_apply(
        int(x.dtype == torch.float32), _MODES[mode], vec, slice_bytes, x.data_ptr(),
        None if r is None else r.data_ptr(), table.data_ptr(), counts, len(counts),
        None if mean is None else mean.data_ptr(), None if inv is None else inv.data_ptr(),
        out.data_ptr(), b, h, w, c, stream_ptr(x))
    build.check(err, "fused_instance_norm shard apply")
    return mean, inv


def _run_per_shard(mode: str, name: str, xs, rs, plan: HaloPlan):
    """The per-shard form: a stats launch a non-empty shard (or tile), the
    S partials copied to each shard's card, an apply launch a non-empty
    shard that merges them itself (the first also writes the plane's
    (mean, inv))."""
    if len(xs) > _MAX_SHARDS:
        raise ValueError(f"row 11h: {len(xs)} shards > {_MAX_SHARDS}")
    _require_shards(xs, rs)
    b, _, _, c = xs[0].shape
    outs = [torch.empty_like(x) for x in xs]
    vec = _vec_all(xs, rs, outs)
    parts = [_launch_stats(x, vec, plan.slice_bytes) if x.shape[1] * x.shape[2] else
             torch.zeros((2, b, c), dtype=torch.float32, device=x.device) for x in xs]
    counts = (ctypes.c_int * len(xs))(*[x.shape[1] * x.shape[2] for x in xs])
    tables, mean, inv = {}, None, None
    for i, x in enumerate(xs):
        if not x.shape[1] * x.shape[2]:
            continue
        if x.device not in tables:
            tables[x.device] = torch.stack([p.to(x.device) for p in parts])
        m, v = _launch_apply(mode, x, None if rs is None else rs[i], outs[i], tables[x.device],
                             counts, vec, plan.slice_bytes, mean is None)
        if mean is None:
            mean, inv = m, v
        LAUNCHES[name] += 1
    return outs, mean, inv


def _run_plain_spatial(xs, relu: bool, residuals):
    parts = [(x.shape[1] * x.shape[2], *shard_stats_plain(x)) for x in xs]
    mean, inv = merge_shard_stats(parts)
    out = [shard_apply_plain(x, mean.to(x.device), inv.to(x.device), relu,
                             None if residuals is None else residuals[i])
           for i, x in enumerate(xs)]
    return out, mean, inv


def _run_in_spatial(xs, relu: bool, residuals, plain: bool = False, per_shard: bool = False):
    """``run_in_spatial``'s shards (tiles, in the grid's shape) and the
    plane's (mean, inv); with ``plain`` every shard on the plain versions;
    with ``per_shard`` the per-shard form also where the cluster form would
    run (so that tests and ``chip_smoke.py`` can hold the two forms against
    each other). A grid runs as the list of its tiles in tile order."""
    flat, rs = tiles(xs), None if residuals is None else tiles(residuals)
    _check_fits_shape(image_shape(xs), flat[0].dtype, rs is not None)
    for x in flat:
        _shard_dtype(x)
    plan = None if plain else tile_plan(tuple(x.shape[1] for x in flat),
                                        tuple(x.shape[2] for x in flat), flat[0].shape[3],
                                        flat[0].dtype, tuple(x.device for x in flat), per_shard)
    if plan is None or plan.form == "plain":
        outs, mean, inv = _run_plain_spatial(flat, relu, rs)
    else:
        name = (f"fused_instance_norm{'_residual' if rs is not None else ''}"
                f"_{'tile' if tiled(xs) else 'halo'}")
        mode = "residual" if rs is not None else ("relu" if relu else "plain")
        with span("kernel." + name):
            if plan.form == "per_shard":
                outs, mean, inv = _run_per_shard(mode, name, flat, rs, plan)
            else:
                outs, mean, inv = _launch_cluster(mode, flat, rs, plan)
                LAUNCHES[name] += 1
    return regrid(outs, xs), mean, inv


def run_in_spatial(xs, relu: bool = False, residuals=None) -> list:
    """Row 11h: IN (+ ReLU, or + r) of the plane whose H-shards are ``xs``
    (bf16 or f32; a global shape ``pallas_fits`` admits), one output shard
    each, with no gather; of a grid of tiles, its tile form (module
    docstring), one output tile each. Every shard on one card and S ≤ ``CLUSTER_MAX``:
    the cluster form, one launch, +1 to
    ``fused_instance_norm(_residual)_halo``; any other CUDA layout: the
    per-shard form, a stats and an apply launch a non-empty shard, +1 a
    non-empty shard; CPU shards: the plain versions. The tile form counts
    as ``fused_instance_norm(_residual)_tile``. Both kernel forms and
    the plain version merge the shards' statistics by the same steps
    (``merge_shard_stats``)."""
    return _run_in_spatial(xs, relu, residuals)[0]


def run_in_spatial_plain(xs, relu: bool = False, residuals=None) -> list:
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


def _differentiable(xs, rs=()) -> bool:
    """Whether a row-11h call on shards must record its backward; a grid of
    tiles never does (2-D tiling serves only, as the JAX package's does:
    its training reads no W axis), and raises where it would."""
    if not _needs_grad(*tiles(xs), *tiles(rs)):
        return False
    if tiled(xs):
        raise NotImplementedError("row 11h's tile form has no backward: 2-D H×W tiling runs in "
                                  "test mode only (run it under torch.inference_mode)")
    return True


def fused_instance_norm_spatial(xs, relu: bool = False) -> list:
    """``fused_instance_norm`` of the plane whose H-shards (or tiles) are
    ``xs`` (row 11h); differentiable in every H-shard."""
    if _differentiable(xs):
        return list(_FusedINSpatial.apply(relu, False, *xs))
    return run_in_spatial(xs, relu)


def fused_instance_norm_residual_spatial(xs, rs) -> list:
    """``fused_instance_norm_residual`` on H-shards (or tiles): ``r + IN(x)``
    shard by shard with the plane's statistics; differentiable in x and r
    on H-shards."""
    if _differentiable(xs, rs):
        return list(_FusedINSpatial.apply(False, True, *xs, *rs))
    return run_in_spatial(xs, residuals=rs)


def instance_norm_auto_spatial(xs, *, relu: bool = False, residuals=None,
                               use_pallas: bool = True) -> list[torch.Tensor]:
    """``instance_norm_auto`` on H-shards (or tiles): row 11h where
    ``pallas_fits`` admits the global shape (the shard heights summed, the
    tile widths too), as the JAX package's GSPMD gate sees it; else the
    two-pass plain ops across the shards (``ops.norm.instance_norm_spatial``),
    then ReLU or + r."""
    if use_pallas and pallas_fits(image_shape(xs), tiles(xs)[0].dtype, residuals is not None):
        if residuals is not None:
            return fused_instance_norm_residual_spatial(xs, residuals)
        return fused_instance_norm_spatial(xs, relu)
    ys = instance_norm_spatial(xs)
    if relu:
        ys = on_shards(torch.relu, ys)
    if residuals is not None:
        ys = on_shards(torch.add, ys, residuals)
    return ys
