"""int8 3×3 conv of the int8 serving route outside the fused blocks
(``csrc/conv_fwd.cu``: the forward conv's GEMM on s8 operands with the
q-conv epilogue).

Counterpart of the JAX package's XLA int8 conv: ``lax.conv_general_dilated``
on int8 operands with int32 accumulation inside ``ops/quant.py:conv2d_int8``
and ``conv2d_int8_fixed`` (``QuantConv`` in down1, down2 and the unfused
resnet blocks; the int8 ``ConcatConv3x3`` legs of up1 and up2). Not a Pallas
kernel there. The operands arrive quantized; the kernel computes

    acc[b, y, x, co] = Σ_{dy, dx, ci} Xp[b, s·y+dy, s·x+dx, ci] · wq[dy, dx, ci, co]
    out = ((f32(acc) · sc[b, co]) + addend) + bias[co]      (each term optional)

with Xp the input padded by one pixel of zeros or reflection, or as it
comes (``"valid"``: the caller padded it), stride s 1 or 2, and writes
float32 or bf16. The epilogue rounds step by step like the plain version,
so the two agree bit for bit.

On the card, one or two launches of ``csrc/conv_fwd.cu``: with reflect
padding the int8 form of the operand pass copies ``xq`` reflect-padded by
one pixel; then the TMA + ``wgmma`` GEMM reads that (zero padding: ``xq``
itself, TMA filling the halo with zeros; VALID: ``xq`` as it is) against
the weights repacked K-major and zero-extended to (3, 3, Cout', Cin')
(``resblock._q_weights``), and its q-conv epilogue dequantizes, adds,
masks the channels past Cout and stores. At stride 2 the GEMM reads its
source through TMA boxes with element strides of 2 on W and H (every
other column and row): a stage (64-channel chunk, dx) holds the input
rows of taps dy 0 and 2 (TH + 1 of them) and those of dy 1 (TH), so a
zero or VALID stride-2 conv is one launch with no pass. The plan
(``_plan``) is ``resblock._conv_plan`` on s8 operands.
"""

from __future__ import annotations

import functools

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

_PADS = ("zero", "reflect", "valid")
_STRIDES = (1, 2)
_OUT_DTYPES = (torch.float32, torch.bfloat16)
_CQ = 16  # Cin and Cout granule: a 16-byte TMA row stride, 8-channel epilogue groups
# The padded float64 input that ``int_conv_exact`` copies at once.
_EXACT_CHUNK_BYTES = 1 << 30


def _rb():
    """``kernels/resblock.py`` (the shared conv GEMM's plan, library and
    plain version), imported at first use: it imports ``int_conv_exact``
    from here."""
    from ircolor_tpu_torch.kernels import resblock

    return resblock


def out_hw(h: int, w: int, pad: str, stride: int = 1) -> tuple[int, int]:
    """Output plane of a 3×3 conv with one pixel of ``pad`` (none for
    ``"valid"``) at ``stride``."""
    p = 0 if pad == "valid" else 1
    return (h + 2 * p - 3) // stride + 1, (w + 2 * p - 3) // stride + 1


def int_conv_exact(q: torch.Tensor, kq: torch.Tensor, pad: str, stride: int = 1) -> torch.Tensor:
    """Exact integer conv of integer-valued NHWC ``q`` with an integer HWIO
    ``kq`` (square, odd size k) at ``stride``, over ``q`` padded by (k−1)/2
    pixels of ``pad`` (``"zero"``, ``"reflect"``; ``"valid"``: none), as
    float64: one matrix product per tap, exact for integer sums below 2^53
    whatever the summation order. A chunk of images at a time, as many as
    keep their padded float64 copy within ``_EXACT_CHUNK_BYTES``, so the
    copies stay bounded at serving batch sizes and an exported graph
    (where it stands in for the int8 conv's op, ``kernels/library.py``)
    holds a few chunks, not an image each; no in-place update, which an
    exported graph's decomposition refuses."""
    b, h, w, c = q.shape
    k = kq.shape[0]
    r = 0 if pad == "valid" else (k - 1) // 2
    mode = "reflect" if pad == "reflect" else "constant"
    ho, wo = (h + 2 * r - k) // stride + 1, (w + 2 * r - k) // stride + 1
    kd = kq.double()
    n = max(1, _EXACT_CHUNK_BYTES // ((h + 2 * r) * (w + 2 * r) * c * 8))
    chunks = []
    for i in range(0, b, n):
        qp = F.pad(q[i : i + n].double().permute(0, 3, 1, 2), (r, r, r, r), mode=mode)
        qp = qp.permute(0, 2, 3, 1)
        acc = None
        for dy in range(k):
            for dx in range(k):
                tap = qp[:, dy : dy + stride * (ho - 1) + 1 : stride,
                         dx : dx + stride * (wo - 1) + 1 : stride] @ kd[dy, dx]
                acc = tap if acc is None else acc + tap
        chunks.append(acc)
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks)


def _epilogue(acc, sc, bias, addend, out_dtype):
    """f32(acc) · sc, + addend, + bias, in ``out_dtype``: one rounding a step."""
    y = acc.float() * sc[:, None, None, :]
    if addend is not None:
        y = addend + y
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def conv3x3_int8_plain(xq, wq, sc, *, pad="zero", stride=1, bias=None, addend=None,
                       out_dtype=torch.bfloat16):
    """Plain version: the exact integer sums, then the kernel's epilogue."""
    return _epilogue(int_conv_exact(xq, wq, pad, stride), sc, bias, addend, out_dtype)


def check_shape(b: int, h: int, w: int, c: int, cout: int, pad: str = "zero",
                stride: int = 1) -> None:
    """Raise unless the card's int8 conv takes the shape: Cin and Cout
    multiples of 16 (TMA's 16-byte row strides; the epilogue's groups of 8
    channels), H, W ≥ 2 (reflect padding) and an output of at least one
    pixel, B ≤ 65535."""
    ho, wo = out_hw(h, w, pad, stride)
    if c % _CQ or cout % _CQ or h < 2 or w < 2 or ho < 1 or wo < 1 or b > 65535:
        raise ValueError(
            f"conv3x3_int8 kernel: unsupported shape xq={(b, h, w, c)} Cout={cout} pad={pad} "
            f"stride={stride} (needs Cin % {_CQ} == 0, Cout % {_CQ} == 0, H, W >= 2, "
            "an output pixel, B <= 65535)"
        )


@functools.lru_cache(maxsize=256)
def _plan(b: int, h: int, w: int, c: int, cout: int, pad: str, stride: int = 1):
    """The GEMM's plan for an h × w output, from the shapes alone: K in
    64-channel chunks (Cin rounded up). At stride 1, N = 128 output
    channels a block where Cout' (Cout rounded up to 64) allows it and its
    output blocks fill the 132 SMs' waves as well as N = 64's (waves × N no
    larger), else N = 64. At stride 2, N = 64, the one width the stride-2
    GEMM is built for: its 46 KB stages ring 4 deep and its bf16 tile
    leaves in one TMA store (an N = 128 form measured slower at both b32
    and both b1 sites, ``PERF.md`` §6). Cached: a batch-1 frame asks for the
    same 24 plans again."""
    rb = _rb()
    coutp = -(-cout // 64) * 64
    ntiles = -(-h // rb._CF_TH) * -(-w // rb._CF_TW)

    def cost(bn: int) -> int:
        return -(-b * ntiles * (coutp // bn) // rb._CF_WAVE) * bn

    bn = 128 if stride == 1 and coutp % 128 == 0 and cost(128) <= cost(64) else 64
    return rb._conv_plan(b, h, w, (c,), cout, pad, s8=True, bn=bn, stride=stride)


@on_input_card
def _pad(xq: torch.Tensor) -> torch.Tensor:
    """The reflect pass: ``xq`` reflect-padded by one pixel; on a CPU tensor
    the bf16 operand pass's plain version, which copies any dtype."""
    if xq.device.type == "cpu":
        return _rb()._conv_pass_plain(xq)
    b, h, w, c = xq.shape
    out = torch.empty((b, h + 2, w + 2, c), dtype=torch.int8, device=xq.device)
    err = _rb()._load_fwd().ircolor_conv_q8_pad(xq.data_ptr(), out.data_ptr(), b, h, w, c,
                                                stream_ptr(xq))
    build.check(err, "int8 conv reflect pass")
    return out


@on_input_card
def _gemm(src, kt, sc, plan, bias=None, addend=None, out_dtype=torch.bfloat16):
    """The GEMM with the q-conv epilogue on ``src`` (``xq`` or its
    reflect-padded copy) and the repacked weights ``kt``; on a CPU tensor,
    at stride 1, its plain version: the
    exact sums in the kernel's reads over whole tiles
    (``resblock._conv_acc_plain`` in its K order, the K-major weights read
    back as HWIO), then the epilogue on the pixels and channels that exist.
    ``conv3x3_int8`` never calls it on the CPU: its plain version there is
    ``conv3x3_int8_plain``."""
    rb = _rb()
    if src.device.type == "cpu":
        if plan.stride != 1:
            raise NotImplementedError("the stride-2 GEMM has no CPU emulation here; "
                                      "conv3x3_int8_plain is its plain version")
        acc = rb._conv_acc_plain([src], [kt.transpose(2, 3)], plan)
        return _epilogue(acc[:, : plan.h, : plan.w, : plan.cout], sc, bias, addend, out_dtype)
    b, hi, wi, c = src.shape
    out = torch.empty((b, plan.h, plan.w, plan.cout), dtype=out_dtype, device=src.device)
    err = rb._load_fwd().ircolor_conv_qconv_gemm(
        src.data_ptr(), kt.data_ptr(), sc.data_ptr(), rb._ptr(addend), rb._ptr(bias),
        out.data_ptr(), int(out_dtype == torch.float32), c, b, plan.h, plan.w, plan.cout,
        plan.shift, plan.stride, hi, wi, plan.bn, plan.grid, stream_ptr(src))
    build.check(err, "int8 conv GEMM")
    return out


def _source(xq: torch.Tensor, pad: str) -> torch.Tensor:
    """What the GEMM reads, at either stride: the reflect copy (reflect),
    else ``xq`` itself."""
    return _pad(xq) if pad == "reflect" else xq


def conv3x3_int8(xq, wq, sc, *, pad="zero", stride=1, bias=None, addend=None,
                 out_dtype=torch.bfloat16):
    """(B, H, W, Cin) int8 ``xq`` ⊛ (3, 3, Cin, Cout) int8 ``wq`` at
    ``stride`` (1 | 2), one pixel of ``pad`` (``"zero"`` | ``"reflect"``)
    padding or none (``"valid"``: ``xq`` comes padded); dequantized by
    ``sc`` (B, Cout) float32, then ``+ addend`` (B, Ho, Wo, Cout) float32
    and ``+ bias`` (Cout,) float32 where given, in ``out_dtype``. In an
    export trace the op ``ircolor::conv3x3_int8``."""
    if pad not in _PADS:
        raise ValueError(f"pad must be one of {_PADS}, got {pad!r}")
    if stride not in _STRIDES:
        raise ValueError(f"stride must be one of {_STRIDES}, got {stride!r}")
    if (traced := exported_op("conv3x3_int8")) is not None:
        return traced(xq, wq, sc, pad, stride, bias, addend, out_dtype)
    if xq.device.type == "cpu":
        return conv3x3_int8_plain(xq, wq, sc, pad=pad, stride=stride, bias=bias, addend=addend,
                                  out_dtype=out_dtype)
    b, h, w, c = xq.shape
    cout = wq.shape[-1]
    ho, wo = out_hw(h, w, pad, stride)
    require(xq, "xq", torch.int8, (None, None, None, None))
    # wq is repacked below, so any layout will do.
    require(wq.contiguous(), "wq", torch.int8, (3, 3, c, None))
    require(sc, "sc", torch.float32, (b, cout))
    if bias is not None:
        require(bias, "bias", torch.float32, (cout,))
    if addend is not None:
        require(addend, "addend", torch.float32, (b, ho, wo, cout))
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"conv3x3_int8: out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")
    check_shape(b, h, w, c, cout, pad, stride)
    if any(t.data_ptr() % 16 for t in (xq, addend) if t is not None):
        raise ValueError("conv3x3_int8: xq and addend must start on 16-byte boundaries "
                         "(TMA and the epilogue read them in 16- and 8-byte units)")
    plan = _plan(b, ho, wo, c, cout, pad, stride)
    src = _source(xq, pad)
    out = _gemm(src, _rb()._q_weights(wq, plan), sc, plan, bias, addend, out_dtype)
    LAUNCHES["conv3x3_int8_s2" if stride == 2 else "conv3x3_int8"] += 1
    return out
