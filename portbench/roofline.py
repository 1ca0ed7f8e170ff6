"""The yardstick of the rooflines and of the model-step shares: the published
dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: 989 TFLOP/s bf16,
1,979 TOP/s int8, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of
HBM) and the least time of a kernel call, counted from its shapes: its
operations over the peak for their type or the bytes it must move (each
input read once, each output written once) over the memory rate, whichever
is larger.

The per-row counts are those of the repository's kernel table (rows 1, "-",
5 and 6): the int8 block conv (``kernels/resblock.py:conv3x3_reflect_fused_q``),
the int8 conv (``kernels/conv_int8.py:conv3x3_int8``), the block dgrad and
wgrad (``conv3x3_dgrad_fused``, ``conv3x3_wgrad_fused``).
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes")."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def block_conv_q(b: int, h: int, w: int, c: int, cout: int) -> tuple[float, float, float]:
    """Row 1, one int8 block conv of a (b, h, w, c) bf16 plane: (ops, bytes,
    peak). The bf16 input and output once, the int8 weights, three per-(image,
    channel) float32 vectors (scales and the output's moments)."""
    act_in, act_out = b * h * w * c * 2, b * h * w * cout * 2
    return 2 * b * h * w * 9 * c * cout, act_in + act_out + 9 * c * cout + b * cout * 4 * 3, PEAK_INT8


def conv_int8(b: int, h: int, w: int, cin: int, cout: int, out_bytes: int, stride: int = 1,
              pad: str = "zero", bias: bool = False,
              addend: bool = False) -> tuple[float, float, float]:
    """Row "-", one int8 3x3 conv of an int8 (b, h, w, cin) plane, with one
    pixel of padding or, ``pad="valid"``, none: its int8 input, weights, a
    float32 scale per (image, channel), the output at ``out_bytes`` a value,
    a float32 bias and a float32 addend of the output's shape where given."""
    if pad == "valid":
        ho, wo = (h - 3) // stride + 1, (w - 3) // stride + 1
    else:
        ho, wo = -(-h // stride), -(-w // stride)
    npix_in, npix_out = b * h * w, b * ho * wo
    nbytes = (npix_in * cin + 9 * cin * cout + b * cout * 4 + npix_out * cout * out_bytes
              + (cout * 4 if bias else 0) + (npix_out * cout * 4 if addend else 0))
    return 2 * npix_out * 9 * cin * cout, nbytes, PEAK_INT8


def block_dgrad(b: int, h: int, w: int, c: int) -> tuple[float, float, float]:
    """Row 5, one block dgrad launch on a (b, h, w, c) bf16 plane: four
    bf16 planes (the incoming gradient, the conv's raw output, the aux
    plane, the result), the bf16 weights, eight per-(image, channel) float32
    vectors."""
    act = b * h * w * c * 2
    return 2 * b * h * w * 9 * c * c, 4 * act + 9 * c * c * 2 + b * c * 4 * 8, PEAK_BF16


def block_wgrad(b: int, h: int, w: int, c: int) -> tuple[float, float, float]:
    """Row 6, one block wgrad launch: three bf16 planes, the float32 weight
    gradient, six per-(image, channel) float32 vectors."""
    act = b * h * w * c * 2
    return 2 * b * h * w * 9 * c * c, 3 * act + 9 * c * c * 4 + b * c * 4 * 6, PEAK_BF16
