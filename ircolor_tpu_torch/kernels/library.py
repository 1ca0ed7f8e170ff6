"""The serving kernels as ``torch.library`` custom ops (namespace
``ircolor``), so that a ``torch.export`` graph can hold them
(``export/aot.py``, ``keep_pallas``).

The kernels launch through ctypes on ``data_ptr()``, which the FakeTensors
of an export trace do not have. So each public wrapper, while
``torch.compiler.is_exporting()``, calls its op here instead (``op``), and
otherwise keeps its own device dispatch with no op dispatch in between:
eager calls pay nothing for the ops. Each op has

* a ``"cuda"`` kernel: the public wrapper itself, which on a CUDA tensor
  launches the kernel (and counts it in ``LAUNCHES``) or raises;
* a ``"cpu"`` kernel: the plain version, its outputs contiguous;
* a fake kernel: the outputs' shapes and dtypes, contiguous NHWC;
* no default kernel: a tensor on any other device raises.

Forward only; the ``autograd.Function``s that wrap some of the kernels for
training are not ops. ``PLAIN`` maps each op to its plain version, the
decomposition table of the portable artifact. The forms no exported route
reaches are not registered: the spatial halo forms (rows 1h, 2h), the
backward kernels (rows 5, 6) and the kernels on no route (rows 7-10).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from ircolor_tpu_torch.kernels import blur, conv_int8, head, instance_norm, resblock

_NS = "ircolor"


def op(name: str):
    """The registered op ``ircolor::name`` (its default overload's packet)."""
    return getattr(getattr(torch.ops, _NS), name)


def _contiguous(out):
    if isinstance(out, tuple):
        return tuple(t.contiguous() for t in out)
    return out.contiguous()


def _register(name: str, cuda, plain, fake) -> None:
    """``ircolor::name`` with ``cuda`` on CUDA tensors, ``plain`` (outputs
    made contiguous) on CPU tensors and ``fake`` for FakeTensors; its
    schema is read from ``cuda``'s annotations."""
    custom = torch.library.custom_op(f"{_NS}::{name}", mutates_args=(), device_types="cuda")(cuda)
    custom.register_kernel("cpu")(lambda *args: _contiguous(plain(*args)))
    custom.register_fake(fake)
    PLAIN[op(name).default] = lambda *args: _contiguous(plain(*args))


PLAIN: dict = {}


def _stats_fake(x: Tensor, cout: int):
    b, h, w, _ = x.shape
    return (x.new_empty((b, h, w, cout)), x.new_empty((b, cout), dtype=torch.float32),
            x.new_empty((b, cout), dtype=torch.float32))


# ---- row 2: the bf16 block conv, reflect form --------------------------------

def _conv3x3_reflect_fused(x: Tensor, kernel: Tensor, mean: Optional[Tensor],
                           inv: Optional[Tensor]) -> tuple[Tensor, Tensor, Tensor]:
    return resblock.conv3x3_reflect_fused(x, kernel, mean, inv)


_register("conv3x3_reflect_fused", _conv3x3_reflect_fused,
          lambda x, kernel, mean, inv: resblock.conv3x3_reflect_fused_plain(x, kernel, mean, inv),
          lambda x, kernel, mean, inv: _stats_fake(x, kernel.shape[-1]))


# ---- row 1: the int8 block conv, reflect form --------------------------------

def _conv3x3_reflect_fused_q(x: Tensor, kq: Tensor, sc: Tensor, qscale: Optional[Tensor],
                             mean: Optional[Tensor],
                             inv: Optional[Tensor]) -> tuple[Tensor, Tensor, Tensor]:
    return resblock.conv3x3_reflect_fused_q(x, kq, sc, qscale=qscale, mean=mean, inv=inv)


_register("conv3x3_reflect_fused_q", _conv3x3_reflect_fused_q,
          lambda x, kq, sc, qscale, mean, inv: resblock.conv3x3_reflect_fused_q_plain(
              x, kq, sc, qscale=qscale, mean=mean, inv=inv),
          lambda x, kq, sc, qscale, mean, inv: _stats_fake(x, kq.shape[-1]))


# ---- row 3: the down-stage tail ------------------------------------------------

def _norm_relu_blur_down(x: Tensor, mean: Tensor, inv: Tensor) -> Tensor:
    return blur.norm_relu_blur_down_pallas(x, mean, inv)


def _half_fake(x: Tensor, mean: Tensor, inv: Tensor) -> Tensor:
    b, h, w, c = x.shape
    return x.new_empty((b, h // 2, w // 2, c))


_register("norm_relu_blur_down", _norm_relu_blur_down, blur.norm_relu_blur_down_plain,
          _half_fake)


# ---- rows 4, 4q: the 7×7 head ------------------------------------------------------

def _conv7x7_head(x: Tensor, mean: Tensor, inv: Tensor, kernel: Tensor, quant: bool) -> Tensor:
    return head.conv7x7_head_pallas(x, mean, inv, kernel, quant=quant)


def _head_plain(x, mean, inv, kernel, quant):
    return (head.conv7x7_head_q_plain if quant else head.conv7x7_head_plain)(x, mean, inv, kernel)


_register("conv7x7_head", _conv7x7_head, _head_plain,
          lambda x, mean, inv, kernel, quant: x.new_empty((*x.shape[:3], kernel.shape[-1])))


# ---- rows "—", "— s2": the int8 conv of the int8 route ----------------------------

def _conv3x3_int8(xq: Tensor, wq: Tensor, sc: Tensor, pad: str, stride: int,
                  bias: Optional[Tensor], addend: Optional[Tensor],
                  out_dtype: torch.dtype) -> Tensor:
    return conv_int8.conv3x3_int8(xq, wq, sc, pad=pad, stride=stride, bias=bias, addend=addend,
                                  out_dtype=out_dtype)


def _int8_plain(xq, wq, sc, pad, stride, bias, addend, out_dtype):
    return conv_int8.conv3x3_int8_plain(xq, wq, sc, pad=pad, stride=stride, bias=bias,
                                        addend=addend, out_dtype=out_dtype)


def _int8_fake(xq, wq, sc, pad, stride, bias, addend, out_dtype):
    ho, wo = conv_int8.out_hw(xq.shape[1], xq.shape[2], pad, stride)
    return xq.new_empty((xq.shape[0], ho, wo, wq.shape[-1]), dtype=out_dtype)


_register("conv3x3_int8", _conv3x3_int8, _int8_plain, _int8_fake)


# ---- row 11: the fused instance norm ---------------------------------------------------

def _run_in(x: Tensor, relu: bool) -> Tensor:
    return instance_norm.run_in(x, relu)


def _run_in_res(x: Tensor, r: Tensor) -> Tensor:
    return instance_norm.run_in_res(x, r)


_register("run_in", _run_in, instance_norm.fused_instance_norm_plain,
          lambda x, relu: torch.empty_like(x, memory_format=torch.contiguous_format))
_register("run_in_res", _run_in_res, instance_norm.fused_instance_norm_residual_plain,
          lambda x, r: torch.empty_like(x, memory_format=torch.contiguous_format))
