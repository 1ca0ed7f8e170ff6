"""The resnet blocks' 3×3 convs and the blocks built from them: the bf16
and int8 forward convs and the dgrad (an operand pass and one TMA +
``wgmma`` GEMM with an epilogue policy, ``csrc/conv_fwd.cu``) and the wgrad
(``csrc/wgrad.cu``).

Counterparts of ``ircolor_tpu/ops/pallas_resblock.py``:
``conv3x3_reflect_fused`` (bf16), ``conv3x3_reflect_fused_q`` (int8),
``conv3x3_dgrad_fused``, ``conv3x3_wgrad_fused`` (also in the enc/dec
segment modes ``pad="zero"``, ``mask_p``, no aux, which
``kernels/encdec.py`` runs), ``resnet_block_pallas`` (differentiable,
``bwd`` = ``"xla"`` | ``"fused"`` | ``"fused_wg"``),
``resnet_block_pallas_q``, their spatial forms over a list of H-shards
(``resnet_block_pallas(_q)_spatial``: the block convs' halo forms, the
neighbour shards' rows as halo rows and the IN sums added across shards)
and ``conv3x3_sum_fused`` (one or two input
legs, zero or reflect halos, the IN stats of the f32 sum; ``_launch_bf16``
also serves ``kernels/block.py`` and ``kernels/conv.py`` in the VALID
mode). A bf16 conv is an operand pass where its halo or a normalize needs
one (the reflect-padded input, or the previous IN + ReLU applied) and a
TMA + ``wgmma`` GEMM that writes the raw output once with per-tile sums of
the output for its instance norm, added over the tiles in order by a
small kernel: one C call enqueues the three. The int8 conv is the same GEMM
on s8 operands: its pass writes the quantized, reflect-padded input as
int8 and its epilogue dequantizes; the int8 block conv runs a form of it
whose producers quantize the input as they load it (no pass), enqueued with
the tile sum by one C call (``_q_fused``). The block epilogue
``x + ((raw2 − m2)·i2).to(dtype)`` stays plain torch.

The plain versions compute in float32 (bf16 products are exact there; the
int8 product in float64, exact for integers): on a CUDA device run them
with TF32 off, or they are not the reference.
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
from ircolor_tpu_torch.ops.norm import instance_norm_vjp
from ircolor_tpu_torch.ops.quant import _AMAX_FLOOR, _QCLIP, quantize_weight_per_channel
from ircolor_tpu_torch.parallel.spatial import all_max, all_sum, exchange_halo_rows
from ircolor_tpu_torch.utils.timing import span

_EPS = 1e-5
_BN = 128  # output channels per block of the conv kernels

_lib_fwd = None
_lib_wgrad = None


def _load_fwd():
    global _lib_fwd
    if _lib_fwd is None:
        lib = build.load("conv_fwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.ircolor_conv_fwd_tile_rows, lib.ircolor_conv_fwd_tile_cols):
            fn.argtypes, fn.restype = [], i
        lib.ircolor_conv_fwd_smem.argtypes, lib.ircolor_conv_fwd_smem.restype = [i], i
        if (lib.ircolor_conv_fwd_tile_rows(), lib.ircolor_conv_fwd_tile_cols()) != (_CF_TH, _CF_TW):
            raise RuntimeError("csrc/conv_fwd.cu and _conv_plan disagree on the tile shape")
        for fn, args in (
            (lib.ircolor_conv_fwd_pass, [p] * 6 + [i] * 5 + [p]),
            (lib.ircolor_conv_fwd_gemm, [p, p, i, p, p, i, p, p] + [i] * 7 + [p]),
            (lib.ircolor_conv_fwd, [p, p, i, p, p, i] + [p] * 6 + [i] + [p] * 3 + [i] * 7 + [p]),
            (lib.ircolor_conv_dgrad_pass, [p] * 7 + [i] * 5 + [p]),
            (lib.ircolor_conv_dgrad_fold, [p] * 4 + [i] * 5 + [p]),
            (lib.ircolor_conv_dgrad_gemm, [p, p, i] + [p] * 7 + [i] * 5 + [p]),
            (lib.ircolor_conv_q_pass, [p] * 6 + [ctypes.c_float, p] + [i] * 4 + [p]),
            (lib.ircolor_conv_q_gemm, [p, p, p, i, p, p] + [i] * 5 + [p]),
            (lib.ircolor_conv_q8_pad, [p, p] + [i] * 4 + [p]),
            (lib.ircolor_conv_qconv_gemm, [p] * 6 + [i] * 12 + [p]),
            (lib.ircolor_conv_q_fwd, [p] * 3 + [ctypes.c_longlong] * 2 + [p] * 5
             + [ctypes.c_float] + [p] * 3 + [i] * 6 + [p]),
        ):
            fn.argtypes, fn.restype = args, i
        _lib_fwd = lib
    return _lib_fwd


def _load_wgrad():
    global _lib_wgrad
    if _lib_wgrad is None:
        lib = build.load("wgrad")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.ircolor_wgrad_chunk_rows, lib.ircolor_wgrad_chunk_cols,
                   lib.ircolor_wgrad_gemm_smem):
            fn.argtypes, fn.restype = [], i
        if (lib.ircolor_wgrad_chunk_rows(), lib.ircolor_wgrad_chunk_cols()) != (_WG_TR, _WG_TC):
            raise RuntimeError("csrc/wgrad.cu and _wgrad_plan disagree on the chunk shape")
        lib.ircolor_wgrad_transform.argtypes = [p] * 11 + [i] * 6 + [p]
        lib.ircolor_wgrad_transform.restype = i
        lib.ircolor_wgrad_gemm.argtypes = [p] * 3 + [i] * 8 + [p]
        lib.ircolor_wgrad_gemm.restype = i
        _lib_wgrad = lib
    return _lib_wgrad


def _ptr(t):
    """A tensor's device pointer for a launch, or None (a null pointer)."""
    return None if t is None else t.data_ptr()


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


# The spatial halo forms of the block convs (JAX ``halo``): ``"reflect"``
# reflects rows −1 and H from x itself; ``"separate"`` takes them from
# ``halo_rows = (top, bot)``, (B, 1, W, C) each (the neighbour shards' edge
# rows); ``"provided"``: x is a slab of H + 2 rows whose first and last are
# those rows (no product path runs it: it keeps the JAX API, and on the card
# runs as ``"separate"`` on the slab's rows, ``_pass_halo_args``). Columns
# are reflected within each row in every form.
HALOS = ("reflect", "provided", "separate")


def _check_halo(x, halo: str, halo_rows) -> None:
    """The JAX function's halo asserts, as ``ValueError``s."""
    if halo not in HALOS:
        raise ValueError(f"halo must be one of {HALOS}, got {halo!r}")
    if (halo_rows is not None) != (halo == "separate"):
        raise ValueError("halo_rows go with halo='separate', and only with it")
    if halo == "separate":
        b, _, w, c = x.shape
        for t in halo_rows:
            if tuple(t.shape) != (b, 1, w, c) or t.device != x.device:
                raise ValueError(f"halo rows: expected {(b, 1, w, c)} on {x.device}, "
                                 f"got {tuple(t.shape)} on {t.device}")


def _halo_slab(x, halo: str = "reflect", halo_rows=None):
    """The rows −1 … H that a halo form reads: (B, H + 2, W, C)."""
    if halo == "provided":
        return x
    if halo == "separate":
        return torch.cat([halo_rows[0], x, halo_rows[1]], dim=1)
    return x[:, _reflect_rows(x.shape[1])]


def _stats_out(s, n: int, sums: bool):
    """The IN statistics a block conv returns from its (B, 2, Cout) sums
    Σy, Σy²: those sums (``sums``, for a caller that adds them across
    shards first) or (mean, inv_std) over its n pixels."""
    return (s,) if sums else _moments(s[:, 0], s[:, 1], n)


def _sums(y):
    """The (B, 2, Cout) f32 sums Σy, Σy² of a (B, H, W, Cout) f32 output."""
    return torch.stack([y.sum(dim=(1, 2)), y.square().sum(dim=(1, 2))], dim=1)


def conv3x3_reflect_fused_plain(x, kernel, mean=None, inv=None, *, halo="reflect",
                                halo_rows=None, sums=False):
    """Plain version: (out, mean, inv) of ``conv3x3_reflect_fused``, or
    (out, sums) with ``sums``."""
    _check_halo(x, halo, halo_rows)
    slab = _halo_slab(x, halo, halo_rows)
    z = slab if mean is None else _normalize_relu(slab, mean, inv).to(x.dtype)
    zp = F.pad(z.float().permute(0, 3, 1, 2), (1, 1, 0, 0), mode="reflect")
    y = F.conv2d(zp, kernel.to(x.dtype).float().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    return (y.to(x.dtype), *_stats_out(_sums(y), y.shape[1] * y.shape[2], sums))


def conv3x3_reflect_fused(x, kernel, mean=None, inv=None, *, halo="reflect", halo_rows=None,
                          sums=False):
    """3×3 conv of NHWC ``x`` with HWIO ``kernel`` under ReflectionPad(1),
    its rows −1 and H per ``halo`` (``HALOS``) → (raw output, IN mean, IN
    inv_std of it), or (raw output, (B, 2, Cout) Σy, Σy²) with ``sums``.
    With ``mean``/``inv`` the input (halo rows included) is normalized and
    ReLU'd on load (rounded to x's dtype). The halo forms count apart, as
    ``conv3x3_reflect_fused_halo``. In an export trace the reflect form is
    the op ``ircolor::conv3x3_reflect_fused`` (``library.py``)."""
    traced = exported_op("conv3x3_reflect_fused") if halo == "reflect" and not sums else None
    if traced is not None:
        return traced(x, kernel, mean, inv)
    if x.device.type == "cpu":
        return conv3x3_reflect_fused_plain(x, kernel, mean, inv, halo=halo, halo_rows=halo_rows,
                                           sums=sums)
    _check_halo(x, halo, halo_rows)
    name = "conv3x3_reflect_fused" + ("" if halo == "reflect" else "_halo")
    return _launch_bf16(name, halo, (x,), (kernel,), mean=mean, inv=inv, halo_rows=halo_rows,
                        sums=sums)


# ------------------------------------------- halo modes and input legs ----

# The forward GEMM's output tile (csrc/conv_fwd.cu's TH, TW; checked when
# the library loads), its two consumer warpgroups of TH / 2 rows, each two
# m64 sub-tiles of 64 / TW rows, and the input channels of a K stage (KC:
# one 64-byte swizzled row of A a pixel: 32 bf16, or 64 int8 in the int8
# conv's stages).
_CF_TH, _CF_TW = 8, 32
_CF_WG = 2
_CF_KC = 32
_CF_KC_S8 = 64
# Persistent GEMM blocks: one wave of an H100's 132 SMs (fixed here, never
# read from the card; the results do not depend on it).
_CF_WAVE = 132
# The bf16 forward conv runs N = 64 where its output blocks' rounds of a
# wave cost at least this much less than at N = 128 (cost: rounds × N,
# ``_conv_plan``). On an H100 a round of N = 64 blocks takes 0.56–0.59 of
# an N = 128 round, not half (``PERF.md`` §6), so a pick 15% below
# in this cost is still a gain on the card (the b4 halo shards: 25% and
# 17% below, 12% and 4% faster); row 7's down2 launch at b32 (0.3%) keeps
# N = 128.
_N64_GAIN = 0.15


class ConvPlan(NamedTuple):
    """The forward conv's launches for one call. The GEMM's ``grid``
    persistent blocks run output blocks ``blk``, ``blk + grid``, …; output
    block ``blk = (b · ntiles + tile) · ncob + cob`` owns output rows
    ``(tile // ntc) · TH + [0, TH)``, columns ``(tile % ntc) · TW + [0,
    TW)`` of image b (those that exist) and output channels ``cob · bn +
    [0, bn)`` (``bn`` 128, or 64 where Cout % 128 ≠ 0: the dgrad's N = 64
    form). Its K loop runs stages (leg, KC-channel chunk, dx), each an
    A box ``a_box`` (channels, columns, rows, images) read at column ``c0 +
    dx − shift``, row ``r0 − shift`` of the leg's source, and two weight
    boxes ``b_box`` (output channels, input channels, dx, dy) — or, in the
    int8 convs' plans (``s8``: KC = 64 int8 channels, the same bytes), one
    box (input channels, output channels, dx, dy) of the K-major weights.
    An s8 leg's last chunk may run past its channels (TMA reads zeros
    there), and ``ncob · bn`` past ``cout`` (the int8 conv's weights come
    zero-extended to both). ``pass_pad``: the operand pass on every leg
    first — 1 reflect-pads (and normalizes with mean/inv), 0 only
    normalizes the pre-padded input, None runs no pass. ``stride`` 2 (the
    int8 conv): a stage holds two boxes of the source read at element
    strides of 2 on W and H from column ``2·c0 + dx − shift``: ``a_box``
    (traversed: 2·TW columns, 2·(TH + 1) rows; landed: TW × (TH + 1)
    pixels) from row ``2·r0 − shift``, for taps dy 0 and 2, and its TH-row
    form from the row after, for dy 1."""

    h: int
    w: int
    cout: int
    chunks: tuple
    shift: int
    pass_pad: int | None
    ntr: int
    ntc: int
    ntiles: int
    ncob: int
    blocks: int
    grid: int
    a_box: tuple
    b_box: tuple
    bn: int = _BN
    stride: int = 1


@functools.lru_cache(maxsize=256)
def _conv_plan(b: int, h: int, w: int, legs: tuple, cout: int, halo: str, norm: bool = False,
               s8: bool = False, bn: int | None = None, stride: int = 1) -> ConvPlan:
    """The plan of the forward conv of ``legs`` (a tuple of each leg's
    input channels) into an h × w × cout output: a function of the shapes
    alone, cached (a forward asks for the same few plans again). ``s8``:
    the int8 convs' (int8 stages of 64 channels). ``bn``: output channels
    a block; by default 64 where cout % 128 ≠ 0, and for bf16 where the
    output blocks' rounds of the 132-block wave cost at least
    ``_N64_GAIN`` less at N = 64 than at 128 (cost: ⌈blocks / 132⌉ · N,
    the int8 conv's rule: a grid of a few hundred blocks, whose last round
    runs short at N = 128), else 128 (the int8 block conv always: its
    q-stats policy runs N = 128 only; the int8 conv picks its own,
    ``kernels/conv_int8.py:_plan``; the dgrad passes its own). ``stride``
    2: the int8 conv, reading its source through strided boxes (the halo
    as at stride 1)."""
    ntr, ntc = -(-h // _CF_TH), -(-w // _CF_TW)
    pass_pad = 1 if halo == "reflect" else (0 if halo == "valid" and norm else None)
    kc = _CF_KC_S8 if s8 else _CF_KC
    if bn is None:
        bn = _BN if cout % _BN == 0 else 64
        tiles = b * ntr * ntc

        def cost(n: int) -> int:
            return -(-tiles * (cout // n) // _CF_WAVE) * n

        if bn == _BN and not s8 and cost(64) <= (1 - _N64_GAIN) * cost(_BN):
            bn = 64
    ncob = -(-cout // bn)
    blocks = b * ntr * ntc * ncob
    b_box = (kc, bn, 1, 3) if s8 else (64, kc, 1, 3)
    a_box = (kc, _CF_TW, _CF_TH + 2, 1) if stride == 1 else (kc, 2 * _CF_TW, 2 * (_CF_TH + 1), 1)
    return ConvPlan(h, w, cout, tuple(-(-c // kc) for c in legs), int(halo == "zero"), pass_pad,
                    ntr, ntc, ntr * ntc, ncob, blocks, min(blocks, _CF_WAVE), a_box, b_box, bn,
                    stride)


def _conv_blocks(plan: ConvPlan):
    """Every output block as (persistent block, blk, b, tile, r0, c0, co0),
    in the kernel's index arithmetic."""
    for x in range(plan.grid):
        for blk in range(x, plan.blocks, plan.grid):
            mt, cob = divmod(blk, plan.ncob)
            b, tile = divmod(mt, plan.ntiles)
            tr, tc = divmod(tile, plan.ntc)
            yield x, blk, b, tile, tr * _CF_TH, tc * _CF_TW, cob * plan.bn


def _conv_a_offsets():
    """Byte offset in the A buffer of each (warpgroup, sub-tile, dy)'s m64
    operand: the tap's first pixel row, one 2·KC-byte row a pixel."""
    return {(wg, t, dy): ((_CF_TH // _CF_WG) * wg + 2 * t + dy) * _CF_TW * 2 * _CF_KC
            for wg in range(_CF_WG) for t in range(2) for dy in range(3)}


def _conv_pass_plain(x, mean=None, inv=None, *, pad: int = 1, halo="reflect", halo_rows=None):
    """Plain version of the operand pass: x, or bf16(relu((x − mean)·inv)),
    padded by one pixel (``pad`` 1: rows −1 and H per ``halo``, columns
    reflected through common.cuh's index map) or as it is (``pad`` 0)."""
    if not pad:
        return x if mean is None else _normalize_relu(x, mean, inv).to(x.dtype)
    slab = _halo_slab(x, halo, halo_rows)
    z = slab if mean is None else _normalize_relu(slab, mean, inv).to(x.dtype)
    return z[:, :, _reflect_rows(z.shape[2])].contiguous()


def _pass_halo_args(x, halo: str, halo_rows):
    """(x, top, bot) of a pass launch, tensors the caller holds until the
    launch is queued (their memory is not reused before it). The pass reads
    its halo rows from ``top``/``bot`` alone: the ``provided`` slab goes as
    its interior rows with its edge rows as the separate halo rows. The
    halo rows must start on 16-byte boundaries, as x does."""
    if halo == "provided":
        x, halo_rows = x[:, 1:-1].contiguous(), (x[:, :1].contiguous(), x[:, -1:].contiguous())
    top = bot = None
    if halo_rows is not None:
        top, bot = halo_rows
        for t, name in ((top, "top"), (bot, "bot")):
            require(t, f"halo row {name}", x.dtype, (x.shape[0], 1, x.shape[2], x.shape[3]))
            if t.data_ptr() % 16:
                raise ValueError("halo rows must start on 16-byte boundaries")
    return x, top, bot


@on_input_card
def _conv_pass(x, mean=None, inv=None, *, pad: int = 1, halo="reflect", halo_rows=None):
    """The operand pass (the plain version for CPU tensors)."""
    if x.device.type == "cpu":
        return _conv_pass_plain(x, mean, inv, pad=pad, halo=halo, halo_rows=halo_rows)
    x, top, bot = _pass_halo_args(x, halo, halo_rows)
    b, h, w, c = x.shape
    out = torch.empty((b, h + 2 * pad, w + 2 * pad, c), dtype=x.dtype, device=x.device)
    err = _load_fwd().ircolor_conv_fwd_pass(
        x.data_ptr(), _ptr(mean), _ptr(inv), _ptr(top), _ptr(bot), out.data_ptr(), b, h, w, c,
        pad, stream_ptr(x))
    build.check(err, "conv operand pass")
    return out


def _conv_acc_plain(srcs, kernels, plan: ConvPlan) -> torch.Tensor:
    """The GEMM's accumulator over whole tiles, (B, ntr·TH, ntc·TW, the
    kernels' Cout), in the kernel's K order: leg → chunk of the plan's KC
    channels → dx buffer → dy (zeros where a box lies outside its source,
    and in a leg's channels past its own up to its kernel's: TMA's fill).
    f32 for bf16 operands; int8 operands are summed exactly, in float64
    (exact while |acc| < 2^53, which the s32 accumulator's range is far
    inside)."""
    b = srcs[0].shape[0]
    hh, ww = plan.ntr * _CF_TH, plan.ntc * _CF_TW
    kc = plan.a_box[0]
    s8 = srcs[0].dtype == torch.int8
    dt = torch.float64 if s8 else torch.float32
    acc = srcs[0].new_zeros((b, hh, ww, kernels[0].shape[-1]), dtype=dt)
    for x, k in zip(srcs, kernels):
        xp = x.new_zeros((b, hh + 2, ww + 2, k.shape[2]), dtype=dt)
        s, c = plan.shift, x.shape[-1]
        xp[:, s : s + x.shape[1], s : s + x.shape[2], :c] = x.to(dt)[:, : hh + 2 - s, : ww + 2 - s]
        kf = k.to(dt) if s8 else k.to(torch.bfloat16).float()
        for ci in range(0, k.shape[2], kc):
            for dx in range(3):
                buf = xp[:, :, dx : dx + ww, ci : ci + kc]
                for dy in range(3):
                    acc += torch.einsum("bhwc,co->bhwo", buf[:, dy : dy + hh],
                                        kf[dy, dx, ci : ci + kc])
    return acc


def _tile_sum_plain(partial: torch.Tensor) -> torch.Tensor:
    """Plain version of ``csrc/conv_fwd.cu``'s tile-sum kernel: the (B,
    ntiles, 2, Cout) per-tile sums added over the tiles one at a time, in
    order → (B, 2, Cout)."""
    s = partial[:, 0].clone()
    for t in range(1, partial.shape[1]):
        s += partial[:, t]
    return s


def _tile_sums(t: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """(B, ntiles, Cout) sums of an f32 (B, H, W, Cout) tensor over each
    TH × TW tile's pixels that exist."""
    b = t.shape[0]
    z = t.new_zeros((b, plan.ntr * _CF_TH, plan.ntc * _CF_TW, plan.cout))
    z[:, : plan.h, : plan.w] = t
    z = z.reshape(b, plan.ntr, _CF_TH, plan.ntc, _CF_TW, plan.cout)
    return z.sum(dim=(2, 4)).reshape(b, plan.ntiles, plan.cout)


def _conv_gemm_plain(srcs, kernels, plan: ConvPlan, stats: bool = True, sc=None):
    """Plain version of the GEMM (``_conv_acc_plain``), cvt to f32 and × the
    (B, Cout) dequant scale ``sc`` where given (the int8 conv), then the
    bf16 output and the (B, ntiles, 2, Cout) per-tile moments of the pixels
    that exist (None without ``stats``)."""
    y = _conv_acc_plain(srcs, kernels, plan)[:, : plan.h, : plan.w]
    if sc is not None:
        y = y.float() * sc[:, None, None, :]
    out = y.to(torch.bfloat16)
    if not stats:
        return out, None
    return out, torch.stack([_tile_sums(y, plan), _tile_sums(y.square(), plan)], dim=2)


@on_input_card
def _conv_gemm(srcs, kernels, plan: ConvPlan, stats: bool = True):
    """The GEMM: (bf16 out, per-tile moments or None); the plain version
    for CPU tensors."""
    x0 = srcs[0]
    if x0.device.type == "cpu":
        return _conv_gemm_plain(srcs, kernels, plan, stats)
    ks = [k.to(torch.bfloat16).contiguous() for k in kernels]
    if any(t.data_ptr() % 16 for t in (*srcs, *ks)):
        raise ValueError("conv GEMM: inputs and kernels must start on 16-byte boundaries")
    b = x0.shape[0]
    out = torch.empty((b, plan.h, plan.w, plan.cout), dtype=torch.bfloat16, device=x0.device)
    partial = None
    if stats:
        partial = torch.empty((b, plan.ntiles, 2, plan.cout), dtype=torch.float32,
                              device=x0.device)
    x1, k1 = (srcs[1], ks[1]) if len(srcs) == 2 else (None, None)
    err = _load_fwd().ircolor_conv_fwd_gemm(
        x0.data_ptr(), ks[0].data_ptr(), x0.shape[-1], _ptr(x1), _ptr(k1),
        0 if x1 is None else x1.shape[-1], out.data_ptr(), _ptr(partial), b, plan.h, plan.w,
        plan.cout, plan.shift, plan.bn, plan.grid, stream_ptr(srcs[0]),
    )
    build.check(err, "conv GEMM")
    return out, partial


@on_input_card
def _conv_fwd(legs, kernels, plan: ConvPlan, mean=None, inv=None, *, halo="reflect",
              halo_rows=None, stats: bool = True):
    """The bf16 conv's launches in one C call (``ircolor_conv_fwd``): the
    operand pass on each leg where the plan has one, then the GEMM — those
    of ``_conv_pass`` and ``_conv_gemm``, bit for bit — and with ``stats``
    the tile-sum kernel (``_tile_sum_plain``). Returns (bf16 out, (B, 2,
    Cout) Σy, Σy² or None); on CPU tensors, the plain versions."""
    x0 = legs[0]
    if x0.device.type == "cpu":
        srcs = legs if plan.pass_pad is None else [
            _conv_pass_plain(x, mean, inv, pad=plan.pass_pad, halo=halo, halo_rows=halo_rows)
            for x in legs]
        out, partial = _conv_gemm_plain(srcs, kernels, plan, stats)
        return out, None if partial is None else _tile_sum_plain(partial)
    top = bot = None
    zps = [None, None]
    if plan.pass_pad is not None:
        if halo != "reflect":
            x0, top, bot = _pass_halo_args(x0, halo, halo_rows)
            legs = (x0,)
        zps = [torch.empty((x.shape[0], plan.h + 2, plan.w + 2, x.shape[-1]), dtype=x.dtype,
                           device=x.device) for x in legs] + [None]
    ks = [k.to(torch.bfloat16).contiguous() for k in kernels]
    if any(t.data_ptr() % 16 for t in (*legs, *ks)):
        raise ValueError("conv: inputs and kernels must start on 16-byte boundaries")
    b = x0.shape[0]
    out = torch.empty((b, plan.h, plan.w, plan.cout), dtype=torch.bfloat16, device=x0.device)
    partial = sums = None
    if stats:
        partial = torch.empty((b, plan.ntiles, 2, plan.cout), dtype=torch.float32,
                              device=x0.device)
        sums = torch.empty((b, 2, plan.cout), dtype=torch.float32, device=x0.device)
    x1, k1 = (legs[1], ks[1]) if len(legs) == 2 else (None, None)
    err = _load_fwd().ircolor_conv_fwd(
        x0.data_ptr(), ks[0].data_ptr(), x0.shape[-1], _ptr(x1), _ptr(k1),
        0 if x1 is None else x1.shape[-1], _ptr(mean), _ptr(inv), _ptr(top), _ptr(bot),
        _ptr(zps[0]), _ptr(zps[1]), -1 if plan.pass_pad is None else plan.pass_pad,
        out.data_ptr(), _ptr(partial), _ptr(sums), b, plan.h, plan.w, plan.cout, plan.shift,
        plan.bn, plan.grid, stream_ptr(x0))
    build.check(err, "conv")
    return out, sums


def _launch_bf16(name: str, halo: str, legs, kernels, *, mean=None, inv=None,
                 stats: bool = True, halo_rows=None, sums: bool = False):
    """The bf16 conv (``csrc/conv_fwd.cu``) in ``halo`` mode over one or
    two input legs (``kernels[i]`` (3, 3, Cᵢ, Cout) for ``legs[i]``; the K
    loop runs leg 0's channels, then leg 1's, into one f32 accumulator):
    the operand pass where the plan has one, then the GEMM, enqueued by one
    C call (``_conv_fwd``). ``valid``: the
    legs are pre-padded, the output is 2 smaller in H and W. ``provided`` /
    ``separate`` (one leg): the block conv's spatial halo forms, planned
    as ``reflect``. ``mean``/``inv`` (one leg, not with zero halos): the
    input is normalized + ReLU'd first. Returns the bf16 output, and with
    ``stats`` its IN (mean, inv) from the f32 sums, or with ``sums`` the
    (B, 2, Cout) sums. Raises on what the kernel does not take."""
    x0 = legs[0]
    b, hi, wi = x0.shape[:3]
    h = hi - 2 if halo in ("valid", "provided") else hi
    w = wi - 2 if halo == "valid" else wi
    cout = kernels[0].shape[-1]
    if len(legs) > 2:
        raise ValueError(f"{name} kernel: at most 2 input legs, got {len(legs)}")
    for x, k in zip(legs, kernels):
        require(x, "x", torch.bfloat16, (b, hi, wi, None))
        c = x.shape[-1]
        if tuple(k.shape) != (3, 3, c, cout) or k.device != x.device:
            raise ValueError(f"kernel: expected (3, 3, {c}, {cout}) on {x.device}")
        if c % 64:
            raise ValueError(f"{name} kernel: an input leg has C={c} (needs C % 64 == 0)")
    if cout % _BN or h < (2 if halo == "reflect" else 1) or w < 2:
        raise ValueError(
            f"{name} kernel: unsupported shape x={tuple(x0.shape)} Cout={cout} "
            f"(needs Cout % {_BN} == 0)"
        )
    if mean is not None:
        if len(legs) > 1 or halo == "zero":
            raise ValueError(f"{name} kernel: mean/inv take one leg and reflect or VALID halos")
        require(mean, "mean", torch.float32, (b, x0.shape[-1]))
        require(inv, "inv", torch.float32, (b, x0.shape[-1]))
    spatial = halo in ("provided", "separate")
    with span("kernel." + name):
        plan = _conv_plan(b, h, w, tuple(x.shape[-1] for x in legs), cout,
                          "reflect" if spatial else halo, norm=mean is not None)
        out, s = _conv_fwd(legs, kernels, plan, mean, inv, halo=halo if spatial else "reflect",
                           halo_rows=halo_rows, stats=stats or sums)
        LAUNCHES[name] += 1
        if not (stats or sums):
            return out
        return (out, *_stats_out(s, h * w, sums))


def _check_sum_fused(inputs, kernels, pad: str, tile_h: int) -> None:
    """The JAX function's asserts, as ``ValueError``s (its 128-lane rule is
    a TPU DMA constraint, not one of the function)."""
    if pad not in _PADS:
        raise ValueError(f"pad must be one of {_PADS}, got {pad!r}")
    if not inputs or len(inputs) != len(kernels):
        raise ValueError("need one kernel per input, and at least one input")
    b, h, w, _ = inputs[0].shape
    cout = kernels[0].shape[-1]
    for x, k in zip(inputs, kernels):
        if tuple(x.shape[:3]) != (b, h, w):
            raise ValueError(f"input {tuple(x.shape)}: expected (B, H, W) = {(b, h, w)}")
        if tuple(k.shape) != (3, 3, x.shape[-1], cout):
            raise ValueError(f"kernel {tuple(k.shape)} for input {tuple(x.shape)}")
    if h % tile_h:
        raise ValueError(f"H={h} must divide tile_h={tile_h}")
    if w % 8:
        raise ValueError(f"W={w} must be 8-aligned")


def conv3x3_sum_fused_plain(inputs, kernels, *, pad="zero"):
    """Plain version of ``conv3x3_sum_fused``: one float32 conv over the
    channel concat (≡ Σᵢ conv(xᵢ, kᵢ), with no rounding between legs), the
    one-pass moments of that f32 sum (``_moments``: var = Σy²/n − mean²,
    eps 1e-5), then one rounding of the output to the inputs' dtype.
    ``zero`` halos are zero rows and columns; ``reflect`` reads x[−1] as
    x[1]."""
    dt = inputs[0].dtype
    x = torch.cat([t.float() for t in inputs], dim=-1)
    k = torch.cat([kk.to(dt).float() for kk in kernels], dim=2)
    mode = "reflect" if pad == "reflect" else "constant"
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode=mode)
    y = F.conv2d(xp, k.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    n = y.shape[1] * y.shape[2]
    m, i = _moments(y.sum(dim=(1, 2)), y.square().sum(dim=(1, 2)), n)
    return y.to(dt), m, i


def conv3x3_sum_fused(inputs, kernels, *, pad="zero", tile_h=16):
    """SAME 3×3 conv Σᵢ conv(inputsᵢ, kernelsᵢ) (≡ one conv over their
    channel concat, which is never made), ``pad`` ``"zero"`` or
    ``"reflect"``, → (out in the inputs' dtype, IN mean, IN inv_std of the
    f32 sum). ``tile_h`` is the JAX function's H tile: checked (H % tile_h
    == 0), not a CUDA tiling. On the card: bf16, at most 2 legs, each
    C % 16 == 0 (so a 64-channel leg runs too), Cout % 128 == 0."""
    _check_sum_fused(inputs, kernels, pad, tile_h)
    if inputs[0].device.type == "cpu":
        return conv3x3_sum_fused_plain(inputs, kernels, pad=pad)
    return _launch_bf16("conv3x3_sum_fused", pad, inputs, kernels)


# ---------------------------------------------------------------- int8 ----


def _quantize_input(x, qscale, mean, inv):
    if mean is not None:
        z = _normalize_relu(x, mean, inv)
        return torch.clamp(torch.round(z * (127.0 / _QCLIP)), max=127.0)
    xf = x.float()
    return torch.clamp(torch.round(xf * qscale[:, None, None, None]), -127.0, 127.0)


def conv3x3_reflect_fused_q_plain(x, kq, sc, *, qscale=None, mean=None, inv=None,
                                  halo="reflect", halo_rows=None, sums=False, packed=None):
    """Plain version of ``conv3x3_reflect_fused_q``: the exact integer conv,
    dequantized in float32 (``packed``, the card GEMM's repack of kq, is
    not read)."""
    _check_halo(x, halo, halo_rows)
    q = _quantize_input(_halo_slab(x, halo, halo_rows), qscale, mean, inv)
    y = int_conv_exact(q[:, :, _reflect_rows(q.shape[2])], kq, "valid").float()
    y = y * sc[:, None, None, :]
    return (y.to(x.dtype), *_stats_out(_sums(y), y.shape[1] * y.shape[2], sums))


# The int8 conv on the card: the operand pass writes the quantized,
# reflect-padded input as int8, then the forward conv's GEMM (csrc/conv_fwd.cu)
# runs it on s8 operands against the K-major weights with the q-stats
# epilogue: y = f32(s32 sum)·sc, the bf16 output and the per-(b, tile) sums.

# conv2's fixed grid, 127/6, as torch multiplies by it: the Python float
# rounded once to float32 (ctypes rounds it the same way).
_QFIXED = 127.0 / _QCLIP


def _q_pass_plain(x, qscale=None, mean=None, inv=None, *, halo="reflect", halo_rows=None):
    """Plain version of the int8 operand pass: ``_quantize_input`` as int8,
    padded by one pixel (rows −1 and H per ``halo``, columns reflected
    through common.cuh's index map)."""
    q = _quantize_input(_halo_slab(x, halo, halo_rows), qscale, mean, inv).to(torch.int8)
    return q[:, :, _reflect_rows(q.shape[2])].contiguous()


@on_input_card
def _q_pass(x, qscale=None, mean=None, inv=None, *, halo="reflect", halo_rows=None):
    """The int8 operand pass (the plain version for CPU tensors)."""
    if x.device.type == "cpu":
        return _q_pass_plain(x, qscale, mean, inv, halo=halo, halo_rows=halo_rows)
    x, top, bot = _pass_halo_args(x, halo, halo_rows)
    b, h, w, c = x.shape
    out = torch.empty((b, h + 2, w + 2, c), dtype=torch.int8, device=x.device)
    err = _load_fwd().ircolor_conv_q_pass(
        x.data_ptr(), _ptr(qscale), _ptr(mean), _ptr(inv), _ptr(top), _ptr(bot), _QFIXED,
        out.data_ptr(), b, h, w, c, stream_ptr(x))
    build.check(err, "int8 operand pass")
    return out


def _q_weights(kq: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """HWIO int8 weights repacked K-major (``wgmma`` takes s8 operands
    K-major only) and zero-extended to the plan's channels: (3, 3, ncob·bn,
    chunks·64) — (3, 3, Cout, C) where those fill whole blocks."""
    _, _, c, cout = kq.shape
    cp, coutp = plan.chunks[0] * plan.a_box[0], plan.ncob * plan.bn
    if (c, cout) == (cp, coutp):
        return kq.transpose(2, 3).contiguous()
    kt = kq.new_zeros((3, 3, coutp, cp))
    kt[:, :, :cout, :c] = kq.transpose(2, 3)
    return kt


def _q_b_box(kflat: torch.Tensor, c: int, cout: int, ci0: int, co0: int, dx: int,
             bn: int = _BN) -> torch.Tensor:
    """What the GEMM's weight box at (ci0, co0, dx, 0) reads from the
    repacked weights ``kflat`` (flattened): (3 dy, bn output channels, 64
    input channels), through csrc/conv_fwd.cu's ``make_q_weight_map``
    (dims (C, Cout, 3, 3), strides 1, C, Cout·C, 3·Cout·C)."""
    dy = torch.arange(3)[:, None, None]
    n = torch.arange(bn)[None, :, None]
    k = torch.arange(_CF_KC_S8)[None, None, :]
    return kflat[(ci0 + k) + (co0 + n) * c + dx * cout * c + dy * 3 * cout * c]


@on_input_card
def _q_gemm(zq, kt, sc, plan: ConvPlan):
    """The int8 GEMM: (bf16 out, per-tile sums); the plain version for CPU
    tensors."""
    if zq.device.type == "cpu":  # the K-major weights read back as HWIO
        return _conv_gemm_plain([zq], [kt.transpose(2, 3)], plan, sc=sc)
    b, c = zq.shape[0], zq.shape[-1]
    out = torch.empty((b, plan.h, plan.w, plan.cout), dtype=torch.bfloat16, device=zq.device)
    partial = torch.empty((b, plan.ntiles, 2, plan.cout), dtype=torch.float32, device=zq.device)
    err = _load_fwd().ircolor_conv_q_gemm(
        zq.data_ptr(), kt.data_ptr(), sc.data_ptr(), c, out.data_ptr(), partial.data_ptr(), b,
        plan.h, plan.w, plan.cout, plan.grid, stream_ptr(zq))
    build.check(err, "int8 conv GEMM")
    return out, partial


# The quantize-on-load form (``ircolor_conv_q_fwd``): its producer threads
# (csrc/conv_fwd.cu QL_CONVERT), a chunk's (TH + 2) × (TW + 2) input pixels
# and its 16-channel quantize units (QL_UNITS), a stage's copy units
# (QL_COPY: TH + 2 rows × TW columns × 4).
_QL_CONVERT = 256
_QL_BOX = (_CF_TH + 2, _CF_TW + 2)
_QL_UNITS = _QL_BOX[0] * _QL_BOX[1] * (_CF_KC_S8 // 16)
_QL_COPY = _QL_BOX[0] * _CF_TW * (_CF_KC_S8 // 16)


def _q_rows(x, halo: str, halo_rows, h: int):
    """What the quantize-on-load kernel reads rows from: (rows (B, H, W, C),
    top, bot (B, 1, W, C) or None: reflect) — the ``provided`` slab's
    interior and edge rows as views of it, which the kernel reads through
    pointer offsets and the slab's image stride, no copy."""
    if halo == "provided":
        return x[:, 1 : h + 1], x[:, :1], x[:, h + 1 :]
    if halo == "separate":
        return x, halo_rows[0], halo_rows[1]
    return x, None, None


def _q_load_walk():
    """The producers' walks in the kernel's index arithmetic. Quantize:
    ("q", thread t, unit u, tile pixel p = u // 4, channel group u % 4) for
    u = t + 256·m over a chunk's units. Copy (each dx): ("c", t, unit v, A
    buffer row prow = v // 4, channel group v % 4, tile pixel prow + 2·(prow
    // TW)) for v = t + 256·m over a stage's units: the tile's columns dx …
    dx + TW − 1 of each of its TH + 2 rows."""
    for t in range(_QL_CONVERT):
        for u in range(t, _QL_UNITS, _QL_CONVERT):
            yield "q", t, u, u // 4, u % 4
        for v in range(t, _QL_COPY, _QL_CONVERT):
            prow = v // 4
            yield "c", t, v, prow, v % 4, prow + 2 * (prow // _CF_TW)


def _q_a_offset(dx: int, prow: int, cq: int) -> int:
    """Byte offset in a stage's A buffer (dx: the stage's tap column) of
    pixel row ``prow``, 16-channel group ``cq``: 64-byte rows, TMA's 64-byte
    swizzle (the 16-byte chunk index XOR bits 1–2 of the row), as the GEMM's
    descriptors read it; the s8 tile's pixels are laid out alike
    (``swz64``)."""
    return dx * (_CF_TH + 2) * _CF_TW * 64 + prow * 64 + ((cq ^ ((prow >> 1) & 3)) << 4)


def _q_load_plain(x, b: int, r0: int, c0: int, ci0: int, qscale=None, mean=None, inv=None, *,
                  halo="reflect", halo_rows=None, h: int | None = None) -> torch.Tensor:
    """Plain version of what the quantize-on-load producers write for one
    (image b, tile at r0, c0, chunk at ci0): the A buffers of the chunk's
    three stages (dx), (3, TH + 2, TW, 64) int8, unswizzled. Box row i is input row r0 − 1 + i (−1
    from top or row 1, H from bot or row H − 2, past H zeros), box column
    j input column c0 − 1 + j (−1 as 1, W as W − 2, past W zeros),
    quantized as ``_quantize_input``; buffer dx holds box columns dx …
    dx + TW − 1."""
    h = x.shape[1] - (2 if halo == "provided" else 0) if h is None else h
    rows, top, bot = _q_rows(x, halo, halo_rows, h)
    w, kc = rows.shape[2], _CF_KC_S8
    zero = rows.new_zeros((w, kc))
    box = []
    for i in range(_QL_BOX[0]):
        gr = r0 - 1 + i
        if gr < 0:
            r = (top[b, 0] if top is not None else rows[b, 1])[:, ci0 : ci0 + kc]
        elif gr == h:
            r = (bot[b, 0] if bot is not None else rows[b, h - 2])[:, ci0 : ci0 + kc]
        else:
            r = rows[b, gr, :, ci0 : ci0 + kc] if gr < h else zero
        box.append(r)
    gc = torch.arange(c0 - 1, c0 - 1 + _QL_BOX[1])
    col = torch.where(gc < 0, 1, torch.where(gc == w, w - 2, gc)).clamp(max=w - 1)
    z = torch.stack(box)[:, col][None]  # (1, TH + 2, TW + 2, 64)
    q = _quantize_input(z, None if qscale is None else qscale[b : b + 1],
                        None if mean is None else mean[b : b + 1, ci0 : ci0 + kc],
                        None if inv is None else inv[b : b + 1, ci0 : ci0 + kc])[0]
    gr = torch.arange(r0 - 1, r0 - 1 + _QL_BOX[0])
    q = torch.where(((gr <= h)[:, None] & (gc <= w)[None, :])[..., None], q, 0.0)
    return torch.stack([q[:, dx : dx + _CF_TW] for dx in range(3)]).to(torch.int8)


@on_input_card
def _q_fused(x, kt, sc, plan: ConvPlan, qscale=None, mean=None, inv=None, *, halo="reflect",
             halo_rows=None):
    """The int8 block conv in one C call (``ircolor_conv_q_fwd``): the GEMM
    quantizes its input as its producer loads it (no operand pass, rows
    −1 and H from the halo rows or reflected), then the in-order tile sum.
    ``kt``: the K-major weights (``_q_weights``). Returns (bf16 out, (B, 2,
    Cout) Σy, Σy²); on CPU tensors the plain versions of the pass, the
    GEMM and the tile sum, whose bits it gives (``_q_load_plain`` holds the
    producer's tiles to the pass's)."""
    if x.device.type == "cpu":
        zq = _q_pass_plain(x, qscale, mean, inv, halo=halo, halo_rows=halo_rows)
        out, partial = _conv_gemm_plain([zq], [kt.transpose(2, 3)], plan, sc=sc)
        return out, _tile_sum_plain(partial)
    rows, top, bot = _q_rows(x, halo, halo_rows, plan.h)
    b, h, w, c = rows.shape
    if halo == "provided":
        require(x, "x", torch.bfloat16, (b, h + 2, w, c))
        x_img = t_img = (h + 2) * w * c
    else:
        x_img, t_img = h * w * c, w * c
        for t, name in ((top, "top"), (bot, "bot")):
            if t is not None:
                require(t, f"halo row {name}", x.dtype, (b, 1, w, c))
    if any(t.data_ptr() % 16 for t in (rows, top, bot, mean, inv) if t is not None):
        raise ValueError("conv3x3_reflect_fused_q: x, the halo rows, mean and inv must start "
                         "on 16-byte boundaries")
    out = torch.empty((b, h, w, plan.cout), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((b, plan.ntiles, 2, plan.cout), dtype=torch.float32, device=x.device)
    sums = torch.empty((b, 2, plan.cout), dtype=torch.float32, device=x.device)
    err = _load_fwd().ircolor_conv_q_fwd(
        rows.data_ptr(), _ptr(top), _ptr(bot), x_img, t_img, kt.data_ptr(), sc.data_ptr(),
        _ptr(qscale), _ptr(mean), _ptr(inv), _QFIXED, out.data_ptr(), partial.data_ptr(),
        sums.data_ptr(), b, h, w, c, plan.cout, plan.grid, stream_ptr(x))
    build.check(err, "int8 block conv")
    return out, sums


def _check_q_shape(b: int, h: int, w: int, c: int, cout: int) -> None:
    """Raise unless the int8 conv's kernels take the shape."""
    if c % _CF_KC_S8 or cout % _BN or h < 2 or w < 2 or b > 65535:
        raise ValueError(
            f"conv3x3_reflect_fused_q kernel: unsupported shape x={(b, h, w, c)} Cout={cout} "
            f"(needs C % {_CF_KC_S8} == 0, Cout % {_BN} == 0, H, W >= 2, B <= 65535)"
        )


def conv3x3_reflect_fused_q(x, kq, sc, *, qscale=None, mean=None, inv=None, halo="reflect",
                            halo_rows=None, sums=False, packed=None):
    """int8 form: ``kq`` (3, 3, C, Cout) int8, ``sc`` (B, Cout) dequant
    scale, and exactly one of ``qscale`` (B,) = 127/amax (conv1: quantize
    the raw input) or ``mean``/``inv`` (conv2: normalize + ReLU, then the
    fixed 127/6 grid). ``halo``, ``halo_rows`` and ``sums`` as in
    ``conv3x3_reflect_fused`` (the halo rows quantized like the rest); the
    halo forms count apart, as ``conv3x3_reflect_fused_q_halo``.
    ``packed``: ``kq`` repacked K-major by ``q_pack`` (a caller that runs
    one kq on several shards repacks it once); by default repacked here.

    On the card one C call of ``csrc/conv_fwd.cu`` (``_q_fused``): the s8
    GEMM quantizes its input as it loads it and dequantizes in its q-stats
    epilogue, then a small kernel adds the per-tile sums in order. The
    output is the plain version's bit for bit, and the operand pass and
    GEMM launched apart (``_q_pass``, ``_q_gemm``: the path before it, kept
    as its reference on the card). In an export trace the reflect form is
    the op ``ircolor::conv3x3_reflect_fused_q`` (``library.py``)."""
    if (mean is None) == (qscale is None):
        raise ValueError("need exactly one of qscale / (mean, inv)")
    traced = exported_op("conv3x3_reflect_fused_q") if halo == "reflect" and not sums else None
    if traced is not None:
        return traced(x, kq, sc, qscale, mean, inv)
    if x.device.type == "cpu":
        return conv3x3_reflect_fused_q_plain(x, kq, sc, qscale=qscale, mean=mean, inv=inv,
                                             halo=halo, halo_rows=halo_rows, sums=sums)
    _check_halo(x, halo, halo_rows)
    require(x, "x", torch.bfloat16, (None, None, None, None))
    b, h, w, c = x.shape
    if halo == "provided":
        h -= 2
    cout = kq.shape[-1]
    if kq.shape[:3] != (3, 3, c) or kq.device != x.device:
        raise ValueError(f"kq: expected (3, 3, {c}, Cout) on {x.device}")
    _check_q_shape(b, h, w, c, cout)
    if mean is not None:
        require(mean, "mean", torch.float32, (b, c))
        require(inv, "inv", torch.float32, (b, c))
    if any(t.data_ptr() % 16 for t in (x, mean, inv) if t is not None):
        raise ValueError("conv3x3_reflect_fused_q: x, mean and inv must start on 16-byte "
                         "boundaries (the kernels read them 16 bytes at a time)")
    if kq.dtype != torch.int8:
        raise TypeError(f"kq: expected torch.int8, got {kq.dtype}")
    require(sc, "sc", torch.float32, (b, cout))
    if qscale is not None:
        require(qscale, "qscale", torch.float32, (b,))
    if packed is not None and packed.device != x.device:
        raise ValueError(f"packed: expected a tensor on {x.device}")
    name = "conv3x3_reflect_fused_q" + ("" if halo == "reflect" else "_halo")
    with span("kernel." + name):
        if packed is None:
            packed = q_pack(kq)
        require(packed, "packed", torch.int8, (3, 3, cout, c))
        plan = _conv_plan(b, h, w, (c,), cout, "reflect", s8=True)
        out, s = _q_fused(x, packed, sc, plan, qscale, mean, inv, halo=halo, halo_rows=halo_rows)
        LAUNCHES[name] += 1
        return (out, *_stats_out(s, h * w, sums))


def q_pack(kq: torch.Tensor) -> torch.Tensor:
    """The block conv's int8 HWIO weights (3, 3, C, Cout) repacked K-major,
    (3, 3, Cout, C), as its GEMM reads them (``_q_weights`` for C % 64 ==
    0 and Cout % 128 == 0, which need no zero extension)."""
    return kq.transpose(2, 3).contiguous()


# ------------------------------------------------------------ backward ----

def _col(v: torch.Tensor) -> torch.Tensor:
    return v.float()[:, None, None, :]


def _in_bwd_input(p, comp, m, inv, gm, gy, mask_p=False):
    """The dgrad/wgrad operand: dy = inv·((p − gm) − n̂·gy), n̂ = (comp − m)·inv,
    each step rounded in float32 in the kernels' order, then to p's dtype.
    ``mask_p``: p enters after a ReLU of n̂, so it is kept where comp > m."""
    pf, cf = p.float(), comp.float()
    if mask_p:
        pf = torch.where(cf > _col(m), pf, torch.zeros_like(pf))
    nhat = (cf - _col(m)) * _col(inv)
    return (_col(inv) * ((pf - _col(gm)) - nhat * _col(gy))).to(p.dtype)


def _reflect_conv_dgrad(dy: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """VJP of ``conv2d(ReflectionPad(1)(z), k)`` w.r.t. NHWC z: the full
    (zero-extended) transposed conv, then the pad's halo rows and columns
    folded back onto rows 1 / H−2 and columns 1 / W−2 (corners included)."""
    h, w = dy.shape[1], dy.shape[2]
    f = F.conv_transpose2d(dy.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1))
    f[:, :, 2] += f[:, :, 0]
    f[:, :, h - 1] += f[:, :, h + 1]
    f[:, :, :, 2] += f[:, :, :, 0]
    f[:, :, :, w - 1] += f[:, :, :, w + 1]
    return f[:, :, 1 : h + 1, 1 : w + 1].permute(0, 2, 3, 1)


def _zero_conv_dgrad(dy: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """VJP of the zero-SAME ``conv2d(z, k, padding=1)`` w.r.t. NHWC z."""
    f = F.conv_transpose2d(dy.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1)
    return f.permute(0, 2, 3, 1)


_PADS = ("reflect", "zero")


def _check_mode(pad: str, aux=None, mask_stats=None, znorm=None) -> None:
    if pad not in _PADS:
        raise ValueError(f"pad must be one of {_PADS}, got {pad!r}")
    if aux is None and mask_stats is not None:
        raise ValueError("mask_stats needs the aux operand")
    if znorm is not None and pad == "zero":
        raise ValueError("znorm takes reflect halos only")


def _is_segment(pad: str, mask_p: bool, aux_missing: bool = False) -> bool:
    """The enc/dec segment modes, counted apart from the blocks'."""
    return pad == "zero" or mask_p or aux_missing


def conv3x3_dgrad_fused_plain(p, comp, aux, kernel_fwd, m, inv, gm, gy, mask_stats=None,
                              *, emit_dy=True, pad="reflect", mask_p=False):
    """Plain version of ``conv3x3_dgrad_fused``: the IN backward rounded to
    p's dtype, the dgrad conv (and fold) in float32."""
    _check_mode(pad, aux, mask_stats)
    dy = _in_bwd_input(p, comp, m, inv, gm, gy, mask_p)
    conv_dgrad = _reflect_conv_dgrad if pad == "reflect" else _zero_conv_dgrad
    acc = conv_dgrad(dy.float(), kernel_fwd.to(p.dtype).float())
    dy_out = dy if emit_dy else None
    if aux is None:
        return acc.to(p.dtype), dy_out
    a = aux.float()
    if mask_stats is None:
        return (acc + a).to(p.dtype), dy_out
    mm, mi = (_col(v) for v in mask_stats)
    accm = torch.where(a > mm, acc, torch.zeros_like(acc))
    stats = torch.stack([accm.sum(dim=(1, 2)), (accm * ((a - mm) * mi)).sum(dim=(1, 2))], dim=1)
    return accm.to(p.dtype), dy_out, stats


# The dgrad on the card: the operand pass writes dy (the IN backward), for
# reflect halos a small kernel writes the fold lines, then the forward
# conv's GEMM (csrc/conv_fwd.cu) runs dy against kdg with zero halos and the
# dgrad's epilogue: the fold terms, then the mask-stats, residual or store
# policy.


class DgradPlan(NamedTuple):
    """The dgrad's launches for one call: the operand pass (dy), the fold
    lines where ``fold`` (reflect halos: rows (B, 2, W+2, Cout) = F[−1,
    −1..W], F[H, −1..W] and cols (B, H, 2, Cout) = F[0..H−1, −1], F[0..H−1,
    W], f32), then the GEMM ``conv``: one leg of C channels, zero halos,
    N blocks of ``conv.bn``; its stat partials are (B, conv.ntiles, 2,
    Cout)."""

    conv: ConvPlan
    fold: bool


def _dgrad_plan(b: int, h: int, w: int, c: int, cout: int, pad: str) -> DgradPlan:
    """The dgrad's plan: a function of the shapes alone."""
    return DgradPlan(_conv_plan(b, h, w, (c,), cout, "zero", bn=_BN if cout % _BN == 0 else 64),
                     pad == "reflect")


def _dgrad_kernel(kernel_fwd: torch.Tensor) -> torch.Tensor:
    """kdg = rot180(k) transposed in channels, HWIO (3, 3, C, Cin): the
    zero-SAME correlation of dy with kdg is ``conv_transpose2d(dy, k,
    padding=1)``."""
    return kernel_fwd.to(torch.bfloat16).flip(0, 1).transpose(2, 3).contiguous()


@on_input_card
def _dgrad_pass(p, comp, m, inv, gm, gy, mask_p=False):
    """The operand pass in its dy mode: ``_in_bwd_input`` (itself for CPU
    tensors)."""
    if p.device.type == "cpu":
        return _in_bwd_input(p, comp, m, inv, gm, gy, mask_p)
    b, h, w, c = p.shape
    dy = torch.empty_like(p)
    err = _load_fwd().ircolor_conv_dgrad_pass(
        p.data_ptr(), comp.data_ptr(), m.data_ptr(), inv.data_ptr(), gm.data_ptr(), gy.data_ptr(),
        dy.data_ptr(), b, h, w, c, int(mask_p), stream_ptr(p))
    build.check(err, "dgrad operand pass")
    return dy


def _dgrad_fold_plain(dy, kernel_fwd):
    """Plain version of the fold-line kernel: (rows, cols) f32, each line
    pixel 3 taps × C of dy and the forward kernel (3, 3, Cout, C): rows[:,
    0 | 1, s] = F[−1 | H, s − 1] = Σᵤ dy[0 | H−1, s−2+u]·k[0 | 2, 2−u]ᵀ,
    cols[:, r, 0 | 1] = F[r, −1 | W] = Σᵤ dy[r−1+u, 0 | W−1]·k[2−u, 0 | 2]ᵀ
    (dy outside the plane is zero)."""
    h, w = dy.shape[1], dy.shape[2]
    d = dy.float()
    kf = kernel_fwd.to(torch.bfloat16).float()

    def line(src, taps):  # src (B, n + 2·halo, C) zero-extended, taps [(ty, tx)] by u
        n = src.shape[1] - 2
        return sum(src[:, u : u + n] @ kf[ty, tx].T for u, (ty, tx) in enumerate(taps))

    rows = torch.stack([line(F.pad(d[:, r], (0, 0, 2, 2)), [(ty, 2 - u) for u in range(3)])
                        for r, ty in ((0, 0), (h - 1, 2))], dim=1)
    cols = torch.stack([line(F.pad(d[:, :, c], (0, 0, 1, 1)), [(2 - u, tx) for u in range(3)])
                        for c, tx in ((0, 0), (w - 1, 2))], dim=2)
    return rows, cols


@on_input_card
def _dgrad_fold(dy, kernel_fwd):
    """The fold-line kernel: (rows, cols) f32 (the plain version for CPU
    tensors)."""
    if dy.device.type == "cpu":
        return _dgrad_fold_plain(dy, kernel_fwd)
    b, h, w, c = dy.shape
    cout = kernel_fwd.shape[2]
    k = kernel_fwd.to(torch.bfloat16).contiguous()
    rows = torch.empty((b, 2, w + 2, cout), dtype=torch.float32, device=dy.device)
    cols = torch.empty((b, h, 2, cout), dtype=torch.float32, device=dy.device)
    err = _load_fwd().ircolor_conv_dgrad_fold(
        dy.data_ptr(), k.data_ptr(), rows.data_ptr(), cols.data_ptr(), b, h, w, c, cout,
        stream_ptr(dy))
    build.check(err, "dgrad fold lines")
    return rows, cols


def _dgrad_fold_terms(h: int, w: int, r: int, c: int) -> list:
    """The fold-line entries the GEMM's epilogue adds to output pixel (r, c)
    (``fold_terms`` in csrc/conv_fwd.cu), in its order: ("rows", side, j) is
    rows[:, side, j] = F[−1 | H, j − 1], ("cols", r, side) is cols[:, r,
    side] = F[r, −1 | W]."""
    terms = []
    for side in (0, 1):
        if r == (h - 2 if side else 1):
            terms.append(("rows", side, c + 1))
            if c == 1:
                terms.append(("rows", side, 0))
            if c == w - 2:
                terms.append(("rows", side, w + 1))
    for side in (0, 1):
        if c == (w - 2 if side else 1):
            terms.append(("cols", r, side))
    return terms


def _dgrad_gemm_plain(dy, kdg, plan: DgradPlan, aux=None, mask_stats=None, fold=None):
    """Plain version of the GEMM with the dgrad's epilogue: the K loop's f32
    accumulator (``_conv_acc_plain``), plus each fold pixel's fold terms,
    then the policy → (bf16 dz, (B, ntiles, 2, Cout) partials of the
    mask-stats policy or None)."""
    cp = plan.conv
    y = _conv_acc_plain([dy], [kdg], cp)[:, : cp.h, : cp.w]
    if fold is not None:
        lines = dict(zip(("rows", "cols"), fold))
        edge = {(r, c) for r in (1, cp.h - 2) for c in range(cp.w)}
        edge |= {(r, c) for c in (1, cp.w - 2) for r in range(cp.h)}
        for r, c in sorted(edge):
            terms = [lines[name][:, i, j] for name, i, j in _dgrad_fold_terms(cp.h, cp.w, r, c)]
            y[:, r, c] += sum(terms[1:], terms[0])
    if aux is None:
        return y.to(torch.bfloat16), None
    a = aux.float()
    if mask_stats is None:
        return (y + a).to(torch.bfloat16), None
    mm, mi = (_col(v) for v in mask_stats)
    y = torch.where(a > mm, y, torch.zeros_like(y))
    partial = torch.stack([_tile_sums(y, cp), _tile_sums(y * ((a - mm) * mi), cp)], dim=2)
    return y.to(torch.bfloat16), partial


@on_input_card
def _dgrad_gemm(dy, kdg, plan: DgradPlan, aux=None, mask_stats=None, fold=None):
    """The GEMM with the dgrad's epilogue (the plain version for CPU
    tensors)."""
    if dy.device.type == "cpu":
        return _dgrad_gemm_plain(dy, kdg, plan, aux, mask_stats, fold)
    cp = plan.conv
    b, c = dy.shape[0], dy.shape[-1]
    out = torch.empty((b, cp.h, cp.w, cp.cout), dtype=torch.bfloat16, device=dy.device)
    mm, mi = mask_stats if mask_stats is not None else (None, None)
    partial = None
    if mask_stats is not None:
        partial = torch.empty((b, cp.ntiles, 2, cp.cout), dtype=torch.float32, device=dy.device)
    rows, cols = fold if fold is not None else (None, None)

    err = _load_fwd().ircolor_conv_dgrad_gemm(
        dy.data_ptr(), kdg.data_ptr(), c, _ptr(aux), _ptr(mm), _ptr(mi), _ptr(rows), _ptr(cols),
        out.data_ptr(), _ptr(partial), b, cp.h, cp.w, cp.cout, cp.grid, stream_ptr(dy))
    build.check(err, "dgrad GEMM")
    return out, partial


def conv3x3_dgrad_fused(p, comp, aux, kernel_fwd, m, inv, gm, gy, mask_stats=None, *,
                        emit_dy=True, pad="reflect", mask_p=False):
    """Fused dgrad of ``conv2d(ReflectionPad(1)(·), kernel_fwd)`` preceded by
    an instance norm, for the block backward::

        dy = inv·((p − gm) − n̂·gy),  n̂ = (comp − m)·inv      # IN backward
        dz = reflect_pad_vjp(conv_full(dy, rot180(k)ᵀ))       # dgrad + fold

    With ``mask_stats=(mm, mi)`` (launch 1) returns ``(dz·(aux > mm), dy,
    stats)``, stats (B, 2, Cin) = Σdz_masked, Σdz_masked·(aux − mm)·mi taken
    from the float32 value; without it (launch 2) ``(dz + aux, dy)``. ``dy``
    (p's dtype) is None when ``emit_dy=False``.

    The enc/dec segment modes: ``pad="zero"`` (the dgrad of a zero-SAME
    conv: no fold), ``mask_p`` (p taken as p·[comp > m] before the IN
    backward) and ``aux=None`` (returns ``(dz, dy)``).

    On the card: the operand pass (dy), for reflect halos the fold lines,
    then the forward conv's GEMM with the dgrad's epilogue (``DgradPlan``);
    the stats are the per-tile partials summed here in a fixed order."""
    _check_mode(pad, aux, mask_stats)
    if p.device.type == "cpu":
        return conv3x3_dgrad_fused_plain(p, comp, aux, kernel_fwd, m, inv, gm, gy,
                                         mask_stats, emit_dy=emit_dy, pad=pad, mask_p=mask_p)
    b, h, w, c = p.shape
    cin = kernel_fwd.shape[2]
    require(p, "p", torch.bfloat16, (None, None, None, None))
    require(comp, "comp", torch.bfloat16, (b, h, w, c))
    if aux is not None:
        require(aux, "aux", torch.bfloat16, (b, h, w, cin))
    if kernel_fwd.shape != (3, 3, cin, c) or kernel_fwd.device != p.device:
        raise ValueError(f"kernel_fwd: expected (3, 3, Cin, {c}) on {p.device}")
    if c % 64 or cin % 64 or h < 4 or w < 4:
        raise ValueError(
            f"conv3x3_dgrad_fused: unsupported shape p={tuple(p.shape)} Cin={cin} "
            "(needs C % 64 == 0, Cin % 64 == 0, H, W >= 4)"
        )
    if any(t.data_ptr() % 16 for t in (p, comp) + ((aux,) if aux is not None else ())):
        raise ValueError("conv3x3_dgrad_fused: p, comp and aux must start on 16-byte boundaries")
    for name, v in (("m", m), ("inv", inv), ("gm", gm), ("gy", gy)):
        require(v, name, torch.float32, (b, c))
    if mask_stats is not None:
        require(mask_stats[0], "mm", torch.float32, (b, cin))
        require(mask_stats[1], "mi", torch.float32, (b, cin))
    name = "conv3x3_dgrad_fused" + ("_seg" if _is_segment(pad, mask_p, aux is None) else "")
    with span("kernel." + name):
        plan = _dgrad_plan(b, h, w, c, cin, pad)
        dy = _dgrad_pass(p, comp, m, inv, gm, gy, mask_p)
        fold = _dgrad_fold(dy, kernel_fwd) if plan.fold else None
        out, partial = _dgrad_gemm(dy, _dgrad_kernel(kernel_fwd), plan, aux, mask_stats, fold)
        LAUNCHES[name] += 1
        dy_out = dy if emit_dy else None
        if mask_stats is None:
            return out, dy_out
        return out, dy_out, partial.sum(dim=1)  # fixed-order reduce of the per-tile partials


def conv3x3_wgrad_fused_plain(z, p, comp, m, inv, gm, gy, znorm=None, *, pad="reflect",
                              mask_p=False):
    """Plain version of ``conv3x3_wgrad_fused``: both operands rounded as
    the kernel rounds them, the contraction in float32."""
    _check_mode(pad, znorm=znorm)
    zz = z if znorm is None else _normalize_relu(z, *znorm).to(z.dtype)
    dy = _in_bwd_input(p, comp, m, inv, gm, gy, mask_p).float()
    _, h, w, cz = z.shape
    mode = "reflect" if pad == "reflect" else "constant"
    zp = F.pad(zz.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode=mode).permute(0, 2, 3, 1)
    taps = [
        torch.einsum("bhwi,bhwo->io", zp[:, ty : ty + h, tx : tx + w], dy)
        for ty in range(3)
        for tx in range(3)
    ]
    return torch.stack(taps).reshape(3, 3, cz, dy.shape[-1])


def conv3x3_wgrad_fused(z, p, comp, m, inv, gm, gy, znorm=None, *, pad="reflect", mask_p=False):
    """Fused wgrad of ``conv2d(ReflectionPad(1)(Z), k)`` for the block
    backward: ``dk`` (3, 3, Cz, Co) float32 with Z = z, or relu((z − zm)·zi)
    for ``znorm=(zm, zi)``, and dy the IN backward of ``conv3x3_dgrad_fused``,
    both recomputed from the tensors the forward saved. The segment modes:
    ``pad="zero"`` (zero halos; not with ``znorm``) and ``mask_p``.

    On the card two launches of ``csrc/wgrad.cu``: the transform pass (dy,
    and for reflect halos the padded Z), then the GEMM into the plan's f32
    workspace slots, summed here in a fixed order."""
    _check_mode(pad, znorm=znorm)
    if z.device.type == "cpu":
        return conv3x3_wgrad_fused_plain(z, p, comp, m, inv, gm, gy, znorm, pad=pad,
                                         mask_p=mask_p)
    b, h, w, cz = z.shape
    co = p.shape[-1]
    require(z, "z", torch.bfloat16, (None, None, None, None))
    require(p, "p", torch.bfloat16, (b, h, w, None))
    require(comp, "comp", torch.bfloat16, (b, h, w, co))
    if cz % 64 or co % 128 or h < 2 or w < 2:
        raise ValueError(
            f"conv3x3_wgrad_fused: unsupported shape z={tuple(z.shape)} Co={co} "
            "(needs Cz % 64 == 0, Co % 128 == 0, H, W >= 2)"
        )
    if any(t.data_ptr() % 16 for t in (z, p, comp)):
        raise ValueError("conv3x3_wgrad_fused: z, p and comp must start on 16-byte boundaries")
    for name, v in (("m", m), ("inv", inv), ("gm", gm), ("gy", gy)):
        require(v, name, torch.float32, (b, co))
    if znorm is not None:
        require(znorm[0], "zm", torch.float32, (b, cz))
        require(znorm[1], "zi", torch.float32, (b, cz))
    name = "conv3x3_wgrad_fused" + ("_seg" if _is_segment(pad, mask_p) else "")
    with span("kernel." + name):
        zsrc, dy = _wgrad_transform(z, p, comp, m, inv, gm, gy, znorm, pad=pad, mask_p=mask_p)
        ws = _wgrad_gemm(zsrc, dy, _wgrad_plan(b, h, w, cz, co), pad=pad)
        LAUNCHES[name] += 1
        return ws.sum(dim=0).reshape(3, 3, cz, co)  # fixed-order reduce of the slots


# The wgrad GEMM's K chunk: TR × TC pixels of one image (csrc/wgrad.cu's
# TR, TC; checked when the library loads).
_WG_TR, _WG_TC = 2, 32
# Blocks the plan aims at: one wave of 132 (an H100's SM count, fixed here,
# never read from the card, so the slots and the sums' order depend on the
# shapes alone).
_WG_WAVE = 132


class WgradPlan(NamedTuple):
    """The wgrad GEMM's work split. An M-block is (tap, 64 input channels):
    mb = tap · ncib + ci // 64. Block (tile, slot), tile = mt · ncob + cob,
    owns M-blocks mt · mper + [0, mper) that exist (mb < nmb), output
    channels cob · cw + [0, cw), and chunks [slot · cps, min((slot + 1) ·
    cps, nchunks)) of the (B, ntr, ntc) grid of TR × TC pixel chunks.
    ``swap`` (Co % 256 ≠ 0): 4 M-blocks × 128 output channels a block, dy
    on the A side; else 2 × 256, Z on the A side."""

    swap: bool
    mper: int
    cw: int
    ncib: int
    nmb: int
    mtiles: int
    ncob: int
    ntr: int
    ntc: int
    nchunks: int
    slots: int
    cps: int


def _wgrad_plan(b: int, h: int, w: int, cz: int, co: int) -> WgradPlan:
    """Tiles, chunks and workspace slots of the wgrad GEMM: a function of
    the shapes alone (about one ``_WG_WAVE`` of blocks)."""
    swap = co % 256 != 0
    mper, cw = (4, 128) if swap else (2, 256)
    ncib = cz // 64
    nmb = 9 * ncib
    mtiles = -(-nmb // mper)
    ncob = co // cw
    ntr, ntc = -(-h // _WG_TR), -(-w // _WG_TC)
    nchunks = b * ntr * ntc
    slots = max(1, min(nchunks, _WG_WAVE // (mtiles * ncob)))
    cps = -(-nchunks // slots)
    return WgradPlan(swap, mper, cw, ncib, nmb, mtiles, ncob, ntr, ntc, nchunks,
                     -(-nchunks // cps), cps)


def _wgrad_work(plan: WgradPlan):
    """Every block's share as (slot, tap, ci0, co0, k0, k1): input channels
    ci0 + [0, 64), output channels co0 + [0, cw), chunks [k0, k1), in the
    kernel's index arithmetic."""
    for slot in range(plan.slots):
        k0 = slot * plan.cps
        k1 = min(k0 + plan.cps, plan.nchunks)
        for tile in range(plan.mtiles * plan.ncob):
            mt, cob = divmod(tile, plan.ncob)
            for mb in range(mt * plan.mper, min((mt + 1) * plan.mper, plan.nmb)):
                tap, cib = divmod(mb, plan.ncib)
                yield slot, tap, cib * 64, cob * plan.cw, k0, k1


def _reflect_rows(n: int) -> torch.Tensor:
    """Source index of padded rows −1 … n of a ReflectionPad(1): common.cuh's
    ``reflect_index``."""
    i = torch.arange(-1, n + 1).abs()
    return torch.where(i >= n, 2 * n - 2 - i, i)


def _wgrad_transform_plain(z, p, comp, m, inv, gm, gy, znorm=None, *, pad="reflect",
                           mask_p=False):
    """Plain version of the transform pass: (zsrc, dy). dy is
    ``_in_bwd_input``; zsrc is z itself for zero halos (the GEMM's
    out-of-bounds reads are its halo), else Z (z, or bf16(relu((z −
    zm)·zi))) reflect-padded to (B, H+2, W+2, Cz) through the index map."""
    dy = _in_bwd_input(p, comp, m, inv, gm, gy, mask_p)
    if pad == "zero":
        return z, dy
    return _conv_pass_plain(z, *(znorm or (None, None)), pad=1), dy


@on_input_card
def _wgrad_transform(z, p, comp, m, inv, gm, gy, znorm=None, *, pad="reflect", mask_p=False):
    """The transform pass (the plain version for CPU tensors)."""
    if p.device.type == "cpu":
        return _wgrad_transform_plain(z, p, comp, m, inv, gm, gy, znorm, pad=pad, mask_p=mask_p)
    b, h, w, cz = z.shape
    dy = torch.empty_like(p)
    zp = None
    if pad == "reflect":
        zp = torch.empty((b, h + 2, w + 2, cz), dtype=z.dtype, device=z.device)
    zm, zi = znorm if znorm is not None else (None, None)

    err = _load_wgrad().ircolor_wgrad_transform(
        _ptr(z) if zp is not None else None, p.data_ptr(), comp.data_ptr(), m.data_ptr(),
        inv.data_ptr(), gm.data_ptr(), gy.data_ptr(), _ptr(zm), _ptr(zi), dy.data_ptr(), _ptr(zp),
        b, h, w, cz, p.shape[-1], int(mask_p), stream_ptr(p),
    )
    build.check(err, "wgrad transform")
    return (z if zp is None else zp), dy


def _wgrad_chunks(t: torch.Tensor, plan: WgradPlan) -> torch.Tensor:
    """(B, ntr·TR, ntc·TC, C) → (nchunks, TR·TC, C) in chunk order."""
    b, c = t.shape[0], t.shape[-1]
    t = t.reshape(b, plan.ntr, _WG_TR, plan.ntc, _WG_TC, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(plan.nchunks, _WG_TR * _WG_TC, c)


def _wgrad_gemm_plain(zsrc, dy, plan: WgradPlan, *, pad="reflect") -> torch.Tensor:
    """Plain version of the GEMM: the (slots, 9, Cz, Co) f32 partials, each
    warpgroup's share of ``_wgrad_work`` as the kernel reads it — chunks of
    TR × TC pixels, zeros wherever a box lies outside its plane."""
    b, h, w, co = dy.shape
    cz = zsrc.shape[-1]
    hh, ww = plan.ntr * _WG_TR, plan.ntc * _WG_TC
    dyx = dy.new_zeros((b, hh, ww, co), dtype=torch.float32)
    dyx[:, :h, :w] = dy.float()
    off = 0 if pad == "reflect" else 1  # zsrc row of padded row r: r − off
    zbig = dy.new_zeros((b, hh + 2, ww + 2, cz), dtype=torch.float32)
    zbig[:, off : off + zsrc.shape[1], off : off + zsrc.shape[2]] = zsrc.float()
    dyc = _wgrad_chunks(dyx, plan)
    zc = [_wgrad_chunks(zbig[:, ty : ty + hh, tx : tx + ww], plan) for ty in range(3) for tx in range(3)]
    ws = dy.new_zeros((plan.slots, 9, cz, co), dtype=torch.float32)
    for slot, tap, ci0, co0, k0, k1 in _wgrad_work(plan):
        ws[slot, tap, ci0 : ci0 + 64, co0 : co0 + plan.cw] = torch.einsum(
            "kpi,kpo->io", zc[tap][k0:k1, :, ci0 : ci0 + 64], dyc[k0:k1, :, co0 : co0 + plan.cw])
    return ws


@on_input_card
def _wgrad_gemm(zsrc, dy, plan: WgradPlan, *, pad="reflect") -> torch.Tensor:
    """The GEMM into the plan's workspace slots (the plain version for CPU
    tensors)."""
    if dy.device.type == "cpu":
        return _wgrad_gemm_plain(zsrc, dy, plan, pad=pad)
    b, h, w, co = dy.shape
    cz = zsrc.shape[-1]
    ws = torch.empty((plan.slots, 9, cz, co), dtype=torch.float32, device=dy.device)
    err = _load_wgrad().ircolor_wgrad_gemm(
        zsrc.data_ptr(), dy.data_ptr(), ws.data_ptr(), b, h, w, cz, co, int(pad == "reflect"),
        plan.slots, plan.cps, stream_ptr(dy),
    )
    build.check(err, "wgrad GEMM")
    return ws


# --------------------------------------------------------------- blocks ----

BWD_MODES = ("xla", "fused", "fused_wg")


def _block_epilogue(x, raw2, m2, i2):
    y = (raw2.float() - m2[:, None, None, :]) * i2[:, None, None, :]
    return x + y.to(x.dtype)


def _block_forward(x, k1, k2):
    raw1, m1, i1 = conv3x3_reflect_fused(x, k1)
    raw2, m2, i2 = conv3x3_reflect_fused(raw1, k2, m1, i1)
    return _block_epilogue(x, raw2, m2, i2), (raw1, m1, i1, raw2, m2, i2)


def _pad_conv_vjp(z, k, dy, *, need_dz=True):
    """(dz, dk) of ``conv2d(ReflectionPad(1)(z), k)`` at cotangent dy, by
    autograd of the plain conv (cuDNN on the card); dz is None unless
    ``need_dz``."""
    with torch.enable_grad():
        kk = k.detach().requires_grad_()
        zz = z.detach().requires_grad_(need_dz)
        y = _conv_reflect(zz, kk)
        grads = torch.autograd.grad(y, (zz, kk) if need_dz else (kk,), dy)
    return grads if need_dz else (None, grads[0])


def _resblock_bwd_xla(saved, g):
    """The ``"xla"`` backward: closed-form IN backward in plain torch and
    the four conv gradients by autograd of pad + conv."""
    x, k1, k2, raw1, m1, i1, raw2, m2, i2 = saved
    gf = g.float()
    n1 = (raw1.float() - _col(m1)) * _col(i1)
    z1 = torch.relu(n1).to(x.dtype)
    yhat2 = (raw2.float() - _col(m2)) * _col(i2)
    dy2 = instance_norm_vjp(gf, yhat2, i2)
    dz1, dk2 = _pad_conv_vjp(z1, k2, dy2.to(raw2.dtype))
    dn1 = dz1.float() * (n1 > 0)
    dy1 = instance_norm_vjp(dn1, n1, i1)
    dxc, dk1 = _pad_conv_vjp(x, k1, dy1.to(raw1.dtype))
    dx = (gf + dxc.float()).to(x.dtype)
    return dx, dk1.to(k1.dtype), dk2.to(k2.dtype)


def _resblock_bwd_fused(saved, g, *, wgrad_fused):
    """Two fused dgrad launches, then two fused wgrad launches
    (``wgrad_fused``, the dgrads emit no dy) or two stock wgrads of the dy
    the dgrads stored. The same math as ``_resblock_bwd_xla``."""
    x, k1, k2, raw1, m1, i1, raw2, m2, i2 = saved
    n = x.shape[1] * x.shape[2]
    gf = g.float()
    # E[g·ŷ2] from raw moments: (E[g·raw2] − m2·E[g])·i2.
    gm2 = gf.mean(dim=(1, 2))
    gy2 = ((gf * raw2.float()).mean(dim=(1, 2)) - m2 * gm2) * i2
    dn1, dy2, s = conv3x3_dgrad_fused(g, raw2, raw1, k2, m2, i2, gm2, gy2,
                                      mask_stats=(m1, i1), emit_dy=not wgrad_fused)
    gm1 = (s[:, 0] / n).contiguous()
    gy1 = (s[:, 1] / n).contiguous()
    dx, dy1 = conv3x3_dgrad_fused(dn1, raw1, g, k1, m1, i1, gm1, gy1, emit_dy=not wgrad_fused)
    if wgrad_fused:
        dk2 = conv3x3_wgrad_fused(raw1, g, raw2, m2, i2, gm2, gy2, znorm=(m1, i1))
        dk1 = conv3x3_wgrad_fused(x, dn1, raw1, m1, i1, gm1, gy1)
    else:
        z1 = _normalize_relu(raw1, m1, i1).to(x.dtype)
        dk2 = _pad_conv_vjp(z1, k2, dy2, need_dz=False)[1]
        dk1 = _pad_conv_vjp(x, k1, dy1, need_dz=False)[1]
    return dx, dk1.to(k1.dtype), dk2.to(k2.dtype)


class _ResnetBlock(torch.autograd.Function):
    """The JAX package's ``_resblock_vjp``: the forward saves the block input,
    both kernels and the raws with their IN stats; the backward is one of
    ``BWD_MODES``."""

    @staticmethod
    def forward(ctx, x, k1, k2, bwd):
        out, raws = _block_forward(x, k1, k2)
        ctx.save_for_backward(x, k1, k2, *raws)
        ctx.bwd = bwd
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        g = g.contiguous()
        if ctx.bwd == "xla":
            dx, dk1, dk2 = _resblock_bwd_xla(saved, g)
        else:
            dx, dk1, dk2 = _resblock_bwd_fused(saved, g, wgrad_fused=ctx.bwd == "fused_wg")
        return dx, dk1, dk2, None


def resnet_block_pallas(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor, *,
                        bwd: str = "xla") -> torch.Tensor:
    """One ResnetBlock: two fused conv launches + the elementwise epilogue.
    Conv biases are not applied: they are inert through instance norm (and
    get no gradient here). Differentiable in x, k1, k2; ``bwd`` picks the
    backward (``BWD_MODES``)."""
    if bwd not in BWD_MODES:
        raise ValueError(f"bwd must be one of {BWD_MODES}, got {bwd!r}")
    if torch.is_grad_enabled() and (x.requires_grad or k1.requires_grad or k2.requires_grad):
        return _ResnetBlock.apply(x, k1, k2, bwd)
    return _block_forward(x, k1, k2)[0]


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


# ----------------------------------------------------- spatial blocks ----
# The JAX package's shard_map blocks (pallas_resblock.py:1577, :1606) over
# a list of H-shards (``parallel/spatial.py``): each conv runs per shard in
# its ``"separate"`` halo form, its halo rows the neighbour shards' edge
# rows (reflected at the image's edges); the per-shard Σy, Σy² are added
# across shards and the moments taken over the global H·W, so the instance
# norms cover the whole image, as the unsharded block's do.


def _spatial_conv(conv, xs, kwargs):
    """One block conv over the shards, ``conv(x, **kwargs[i])`` in its
    ``"separate"`` halo form: (raw output shards, each shard's (mean, inv)
    of the global image)."""
    halos = exchange_halo_rows(xs, 1, "reflect")
    outs = [conv(x, halo="separate", halo_rows=hr, sums=True, **kw)
            for x, hr, kw in zip(xs, halos, kwargs)]
    n = sum(x.shape[1] for x in xs) * xs[0].shape[2]
    stats = [_moments(s[:, 0], s[:, 1], n) for s in all_sum([o[1] for o in outs])]
    return [o[0] for o in outs], stats


def resnet_block_pallas_spatial(xs, k1: torch.Tensor, k2: torch.Tensor) -> list:
    """``resnet_block_pallas`` (inference) over the H-shards ``xs``: two
    halo-form conv launches per shard and the epilogue; returns the output
    shards."""
    raw1, st1 = _spatial_conv(conv3x3_reflect_fused, xs,
                              [dict(kernel=k1.to(x.device)) for x in xs])
    raw2, st2 = _spatial_conv(conv3x3_reflect_fused, raw1,
                              [dict(kernel=k2.to(x.device), mean=m, inv=i) for x, (m, i) in
                               zip(xs, st1)])
    return [_block_epilogue(x, r, *st) for x, r, st in zip(xs, raw2, st2)]


def resnet_block_pallas_q_spatial(xs, k1: torch.Tensor, k2: torch.Tensor) -> list:
    """``resnet_block_pallas_q`` over the H-shards ``xs``: the per-sample
    amax is the maximum across shards (JAX's pmax), so every shard
    quantizes on the unsharded block's grid."""
    b = xs[0].shape[0]
    kq1, sw1 = quantize_weight_per_channel(k1)
    kq2, sw2 = quantize_weight_per_channel(k2)
    amax = all_max([torch.clamp(x.abs().amax(dim=(1, 2, 3)).float(), min=_AMAX_FLOOR)
                    for x in xs])
    sc1 = (amax[0] / 127.0)[:, None] * sw1[None, :]
    sc2 = ((_QCLIP / 127.0) * sw2[None, :]).expand(b, -1)
    # Each kq on each device once, repacked K-major once (the card's GEMM
    # reads it so) for every shard's call.
    devs = {x.device for x in xs}
    k1s, k2s = ({d: kq.to(d) for d in devs} for kq in (kq1, kq2))
    p1s, p2s = ({d: q_pack(k[d]) if d.type == "cuda" else None for d in devs}
                for k in (k1s, k2s))
    raw1, st1 = _spatial_conv(conv3x3_reflect_fused_q, xs, [
        dict(kq=k1s[x.device], packed=p1s[x.device], sc=sc1.to(x.device).contiguous(),
             qscale=127.0 / a) for x, a in zip(xs, amax)])
    raw2, st2 = _spatial_conv(conv3x3_reflect_fused_q, raw1, [
        dict(kq=k2s[x.device], packed=p2s[x.device], sc=sc2.to(x.device).contiguous(), mean=m,
             inv=i) for x, (m, i) in zip(xs, st1)])
    return [_block_epilogue(x, r, *st) for x, r, st in zip(xs, raw2, st2)]
