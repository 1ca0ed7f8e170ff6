"""int8 3×3 conv of the int8 serving route outside the fused blocks
(``csrc/conv_int8.cu``).

Counterpart of the JAX package's XLA int8 conv: ``lax.conv_general_dilated``
on int8 operands with int32 accumulation inside ``ops/quant.py:conv2d_int8``
and ``conv2d_int8_fixed`` (``QuantConv`` in down1, down2 and the unfused
resnet blocks; the int8 ``ConcatConv3x3`` legs of up1 and up2). Not a Pallas
kernel there. The operands arrive quantized; the kernel computes

    acc[b, y, x, co] = Σ_{dy, dx, ci} xq[b, y+dy−1, x+dx−1, ci] · wq[dy, dx, ci, co]
    out = ((f32(acc) · sc[b, co]) + addend) + bias[co]      (each term optional)

with one pixel of zero or reflect padding built into the index map, and
writes float32 or bf16. The epilogue rounds step by step like the plain
version, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.kernels import LAUNCHES, build, require, stream_ptr

_KC = 32  # input channels (bytes) per K chunk of the kernel
_PADS = ("zero", "reflect")
_OUT_DTYPES = (torch.float32, torch.bfloat16)

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("conv_int8")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ircolor_conv3x3_int8.argtypes = [p] * 6 + [i] * 7 + [p]
        lib.ircolor_conv3x3_int8.restype = i
        _lib = lib
    return _lib


def int_conv_exact(q: torch.Tensor, kq: torch.Tensor, pad: str) -> torch.Tensor:
    """Exact integer conv of integer-valued NHWC ``q`` with an integer HWIO
    ``kq`` (square, odd size k), SAME size with (k−1)/2 pixels of ``pad``
    padding, as float64: one matrix product per tap, exact for integer sums
    below 2^53 whatever the summation order. One image at a time, so the
    float64 copies stay small at serving batch sizes."""
    b, h, w, _ = q.shape
    k = kq.shape[0]
    r = (k - 1) // 2
    mode = "reflect" if pad == "reflect" else "constant"
    kd = kq.double()
    out = torch.zeros((b, h, w, kq.shape[-1]), dtype=torch.float64, device=q.device)
    for i in range(b):
        qp = F.pad(q[i : i + 1].double().permute(0, 3, 1, 2), (r, r, r, r), mode=mode)
        qp = qp[0].permute(1, 2, 0)
        for dy in range(k):
            for dx in range(k):
                out[i] += qp[dy : dy + h, dx : dx + w] @ kd[dy, dx]
    return out


def conv3x3_int8_plain(xq, wq, sc, *, pad="zero", bias=None, addend=None,
                       out_dtype=torch.bfloat16):
    """Plain version: the exact integer sums, then the kernel's epilogue."""
    y = int_conv_exact(xq, wq, pad).float() * sc[:, None, None, :]
    if addend is not None:
        y = addend + y
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def conv3x3_int8(xq, wq, sc, *, pad="zero", bias=None, addend=None, out_dtype=torch.bfloat16):
    """(B, H, W, Cin) int8 ``xq`` ⊛ (3, 3, Cin, Cout) int8 ``wq``, stride 1,
    one pixel of ``pad`` (``"zero"`` | ``"reflect"``) padding; dequantized
    by ``sc`` (B, Cout) float32, then ``+ addend`` (B, H, W, Cout) float32
    and ``+ bias`` (Cout,) float32 where given, in ``out_dtype``."""
    if pad not in _PADS:
        raise ValueError(f"pad must be one of {_PADS}, got {pad!r}")
    if xq.device.type == "cpu":
        return conv3x3_int8_plain(xq, wq, sc, pad=pad, bias=bias, addend=addend,
                                  out_dtype=out_dtype)
    b, h, w, c = xq.shape
    cout = wq.shape[-1]
    require(xq, "xq", torch.int8, (None, None, None, None))
    # wq is packed below, so any layout will do.
    require(wq.contiguous(), "wq", torch.int8, (3, 3, c, None))
    require(sc, "sc", torch.float32, (b, cout))
    if bias is not None:
        require(bias, "bias", torch.float32, (cout,))
    if addend is not None:
        require(addend, "addend", torch.float32, (b, h, w, cout))
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"conv3x3_int8: out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")
    if c % _KC or cout % 64 or h < 2 or w < 2 or b > 65535:
        raise ValueError(
            f"conv3x3_int8 kernel: unsupported shape xq={tuple(xq.shape)} Cout={cout} "
            f"(needs Cin % {_KC} == 0, Cout % 64 == 0, H, W >= 2)"
        )
    wpk = wq.reshape(9, c // _KC, _KC, cout).permute(1, 0, 3, 2).contiguous()
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=xq.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _load().ircolor_conv3x3_int8(
        xq.data_ptr(), wpk.data_ptr(), sc.data_ptr(), ptr(bias), ptr(addend), out.data_ptr(),
        b, h, w, c, cout, int(pad == "reflect"), int(out_dtype == torch.float32), stream_ptr(),
    )
    build.check(err, "conv3x3_int8")
    LAUNCHES["conv3x3_int8"] += 1
    return out
