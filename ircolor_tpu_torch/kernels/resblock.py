"""Fused reflect-padded 3×3 conv of the resnet blocks (``csrc/resblock.cu``),
its backward (``csrc/resblock_bwd.cu``) and the blocks built from them.

Counterparts of ``ircolor_tpu/ops/pallas_resblock.py``:
``conv3x3_reflect_fused`` (bf16), ``conv3x3_reflect_fused_q`` (int8),
``conv3x3_dgrad_fused``, ``conv3x3_wgrad_fused``, ``resnet_block_pallas``
(differentiable, ``bwd`` = ``"xla"`` | ``"fused"`` | ``"fused_wg"``) and
``resnet_block_pallas_q``. One conv launch reads the unpadded NHWC input
once (reflect halos built on load, the previous IN + ReLU and, for int8,
the quantization applied on load) and writes the raw output once, with the
per-(B, C) sums of the output for its instance norm. The block epilogue
``x + ((raw2 − m2)·i2).to(dtype)`` stays plain torch.

The plain versions compute in float32 (bf16 products are exact there; the
int8 product in float64, exact for integers): on a CUDA device run them
with TF32 off, or they are not the reference.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.kernels import LAUNCHES, build, require, stream_ptr
from ircolor_tpu_torch.kernels.conv_int8 import int_conv_exact
from ircolor_tpu_torch.ops.norm import instance_norm_vjp
from ircolor_tpu_torch.ops.quant import _AMAX_FLOOR, _QCLIP, quantize_weight_per_channel

_EPS = 1e-5
_BN = 128  # output channels per block of the kernel
_KBYTES = 32  # bytes of input channels per K chunk of the kernel

_lib = None
_lib_bwd = None


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


def _load_bwd():
    global _lib_bwd
    if _lib_bwd is None:
        lib = build.load("resblock_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ircolor_conv3x3_dgrad_num_tiles.argtypes = [i, i]
        lib.ircolor_conv3x3_dgrad_num_tiles.restype = i
        lib.ircolor_conv3x3_dgrad.argtypes = [p] * 13 + [i] * 5 + [p]
        lib.ircolor_conv3x3_dgrad.restype = i
        lib.ircolor_conv3x3_wgrad_num_tiles.argtypes = [i, i, i]
        lib.ircolor_conv3x3_wgrad_num_tiles.restype = i
        lib.ircolor_conv3x3_wgrad.argtypes = [p] * 10 + [i] * 7 + [p]
        lib.ircolor_conv3x3_wgrad.restype = i
        _lib_bwd = lib
    return _lib_bwd


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


def conv3x3_reflect_fused_q_plain(x, kq, sc, *, qscale=None, mean=None, inv=None):
    """Plain version of ``conv3x3_reflect_fused_q``: the exact integer conv,
    dequantized in float32."""
    q = _quantize_input(x, qscale, mean, inv)
    y = int_conv_exact(q, kq, "reflect").float() * sc[:, None, None, :]
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


# ------------------------------------------------------------ backward ----

_WG_GROUP_TILES = 128  # 4×16-pixel tiles (8,192 pixels) per wgrad workspace slot


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.float()[:, None, None, :]


def _in_bwd_input(p, comp, m, inv, gm, gy):
    """The dgrad/wgrad operand: dy = inv·((p − gm) − n̂·gy), n̂ = (comp − m)·inv,
    each step rounded in float32 in the kernels' order, then to p's dtype."""
    nhat = (comp.float() - _col(m)) * _col(inv)
    return (_col(inv) * ((p.float() - _col(gm)) - nhat * _col(gy))).to(p.dtype)


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


def _unported_mode(what: str, pad: str, mask_p: bool, aux_missing: bool = False) -> None:
    if pad != "reflect" or mask_p or aux_missing:
        raise NotImplementedError(
            f"{what}: only pad='reflect' with mask_p=False (and an aux operand) is "
            "ported; the enc/dec segment modes wait in ROADMAP.md"
        )


def conv3x3_dgrad_fused_plain(p, comp, aux, kernel_fwd, m, inv, gm, gy, mask_stats=None,
                              *, emit_dy=True):
    """Plain version of ``conv3x3_dgrad_fused``: the IN backward rounded to
    p's dtype, the dgrad conv and fold in float32."""
    dy = _in_bwd_input(p, comp, m, inv, gm, gy)
    acc = _reflect_conv_dgrad(dy.float(), kernel_fwd.to(p.dtype).float())
    a = aux.float()
    dy_out = dy if emit_dy else None
    if mask_stats is None:
        return (acc + a).to(p.dtype), dy_out
    mm, mi = (_col(v) for v in mask_stats)
    accm = torch.where(a > mm, acc, torch.zeros_like(acc))
    stats = torch.stack([accm.sum(dim=(1, 2)), (accm * ((a - mm) * mi)).sum(dim=(1, 2))], dim=1)
    return accm.to(p.dtype), dy_out, stats


def conv3x3_dgrad_fused(p, comp, aux, kernel_fwd, m, inv, gm, gy, mask_stats=None, *,
                        emit_dy=True, pad="reflect", mask_p=False):
    """Fused dgrad of ``conv2d(ReflectionPad(1)(·), kernel_fwd)`` preceded by
    an instance norm, for the block backward::

        dy = inv·((p − gm) − n̂·gy),  n̂ = (comp − m)·inv      # IN backward
        dz = reflect_pad_vjp(conv_full(dy, rot180(k)ᵀ))       # dgrad + fold

    With ``mask_stats=(mm, mi)`` (launch 1) returns ``(dz·(aux > mm), dy,
    stats)``, stats (B, 2, Cin) = Σdz_masked, Σdz_masked·(aux − mm)·mi taken
    from the float32 value; without it (launch 2) ``(dz + aux, dy)``. ``dy``
    (p's dtype) is None when ``emit_dy=False``."""
    _unported_mode("conv3x3_dgrad_fused", pad, mask_p, aux is None)
    if p.device.type == "cpu":
        return conv3x3_dgrad_fused_plain(p, comp, aux, kernel_fwd, m, inv, gm, gy,
                                         mask_stats, emit_dy=emit_dy)
    b, h, w, c = p.shape
    cin = kernel_fwd.shape[2]
    require(p, "p", torch.bfloat16, (None, None, None, None))
    require(comp, "comp", torch.bfloat16, (b, h, w, c))
    require(aux, "aux", torch.bfloat16, (b, h, w, cin))
    if kernel_fwd.shape != (3, 3, cin, c) or kernel_fwd.device != p.device:
        raise ValueError(f"kernel_fwd: expected (3, 3, Cin, {c}) on {p.device}")
    if c % 16 or cin % _BN or h < 4 or w < 4 or b > 65535:
        raise ValueError(
            f"conv3x3_dgrad_fused: unsupported shape p={tuple(p.shape)} Cin={cin} "
            f"(needs C % 16 == 0, Cin % {_BN} == 0, H, W >= 4)"
        )
    for name, v in (("m", m), ("inv", inv), ("gm", gm), ("gy", gy)):
        require(v, name, torch.float32, (b, c))
    mm = mi = None
    if mask_stats is not None:
        mm, mi = mask_stats
        require(mm, "mm", torch.float32, (b, cin))
        require(mi, "mi", torch.float32, (b, cin))
    lib = _load_bwd()
    # rot180 in space, transposed in channels, packed like the forward's.
    kdg = kernel_fwd.to(torch.bfloat16).flip(0, 1).transpose(2, 3)
    wpk = kdg.reshape(9, c // 16, 16, cin).permute(1, 0, 3, 2).contiguous()
    out = torch.empty((b, h, w, cin), dtype=p.dtype, device=p.device)
    dy = torch.empty_like(p) if emit_dy else None
    partial = None
    if mask_stats is not None:
        ntiles = lib.ircolor_conv3x3_dgrad_num_tiles(h, w)
        partial = torch.empty((b, ntiles, 2, cin), dtype=torch.float32, device=p.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.ircolor_conv3x3_dgrad(
        p.data_ptr(), comp.data_ptr(), aux.data_ptr(), wpk.data_ptr(), m.data_ptr(),
        inv.data_ptr(), gm.data_ptr(), gy.data_ptr(), ptr(mm), ptr(mi), out.data_ptr(),
        ptr(dy), ptr(partial), b, h, w, c, cin, stream_ptr(),
    )
    build.check(err, "conv3x3_dgrad_fused")
    LAUNCHES["conv3x3_dgrad_fused"] += 1
    if mask_stats is None:
        return out, dy
    return out, dy, partial.sum(dim=1)  # fixed-order reduce of the per-tile partials


def conv3x3_wgrad_fused_plain(z, p, comp, m, inv, gm, gy, znorm=None):
    """Plain version of ``conv3x3_wgrad_fused``: both operands rounded as
    the kernel rounds them, the contraction in float32."""
    zz = z if znorm is None else _normalize_relu(z, *znorm).to(z.dtype)
    dy = _in_bwd_input(p, comp, m, inv, gm, gy).float()
    _, h, w, cz = z.shape
    zp = F.pad(zz.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
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
    both recomputed on load from the tensors the forward saved."""
    _unported_mode("conv3x3_wgrad_fused", pad, mask_p)
    if z.device.type == "cpu":
        return conv3x3_wgrad_fused_plain(z, p, comp, m, inv, gm, gy, znorm)
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
    for name, v in (("m", m), ("inv", inv), ("gm", gm), ("gy", gy)):
        require(v, name, torch.float32, (b, co))
    zm = zi = None
    if znorm is not None:
        zm, zi = znorm
        require(zm, "zm", torch.float32, (b, cz))
        require(zi, "zi", torch.float32, (b, cz))
    lib = _load_bwd()
    ntiles = lib.ircolor_conv3x3_wgrad_num_tiles(b, h, w)
    groups = -(-ntiles // _WG_GROUP_TILES)
    per_group = -(-ntiles // groups)
    ws = torch.empty((groups, 9, cz, co), dtype=torch.float32, device=z.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.ircolor_conv3x3_wgrad(
        z.data_ptr(), p.data_ptr(), comp.data_ptr(), m.data_ptr(), inv.data_ptr(),
        gm.data_ptr(), gy.data_ptr(), ptr(zm), ptr(zi), ws.data_ptr(),
        b, h, w, cz, co, per_group, groups, stream_ptr(),
    )
    build.check(err, "conv3x3_wgrad_fused")
    LAUNCHES["conv3x3_wgrad_fused"] += 1
    return ws.sum(dim=0).reshape(3, 3, cz, co)  # fixed-order reduce of the slots


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
