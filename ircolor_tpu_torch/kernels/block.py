"""VALID 3×3 conv of a pre-padded input with the IN statistics of its
output, optionally normalizing + ReLU-ing the input first (the bf16 conv
of ``csrc/conv_fwd.cu`` in its VALID halo mode).

Counterpart of ``ircolor_tpu/ops/pallas_block.py``: ``conv3x3_stats`` and
``conv3x3_norm_in_stats``. A ResnetBlock composes as

    raw1, m1, i1 = conv3x3_stats(reflect_pad(x), k1)
    raw2, m2, i2 = conv3x3_norm_in_stats(reflect_pad(raw1), k2, m1, i1)
    out = x + (raw2 − m2)·i2

Normalizing the padded raw tensor is exact only because the pad is a
reflection (it commutes with a per-channel map): callers reflect-pad.
"""

from __future__ import annotations

from ircolor_tpu_torch.kernels.conv import conv_valid_f32
from ircolor_tpu_torch.kernels.resblock import _launch_bf16, _moments, _normalize_relu


def conv3x3_stats_plain(x_padded, kernel, mean=None, inv=None):
    """Plain version of both entry points: with ``mean``/``inv`` the input
    is ``max((x − m)·inv, 0)`` in f32, rounded to x's dtype before the taps
    (halo rows and columns too); the conv in f32; (mean, inv) one-pass from
    the f32 output (eps 1e-5); the output rounded once."""
    z = x_padded if mean is None else _normalize_relu(x_padded, mean, inv).to(x_padded.dtype)
    y = conv_valid_f32(z, kernel)
    n = y.shape[1] * y.shape[2]
    m, i = _moments(y.sum(dim=(1, 2)), y.square().sum(dim=(1, 2)), n)
    return y.to(x_padded.dtype), m, i


def _run(name, x_padded, kernel, mean, inv, tile_h):
    c = x_padded.shape[-1]
    if tuple(kernel.shape[:3]) != (3, 3, c):
        raise ValueError(f"kernel {tuple(kernel.shape)}: expected (3, 3, {c}, Cout)")
    h = x_padded.shape[1] - 2
    if h % tile_h:
        raise ValueError(f"H={h} must divide tile_h={tile_h}")
    if x_padded.device.type == "cpu":
        return conv3x3_stats_plain(x_padded, kernel, mean, inv)
    return _launch_bf16(name, "valid", (x_padded,), (kernel,), mean=mean, inv=inv)


def conv3x3_stats(x_padded, kernel, *, tile_h=16):
    """VALID conv of pre-padded input → (raw_out, mean, inv_std) per (B, C)."""
    return _run("conv3x3_stats", x_padded, kernel, None, None, tile_h)


def conv3x3_norm_in_stats(x_padded_raw, kernel, mean, inv, *, tile_h=16):
    """Normalize + ReLU the (pre-padded raw) input on load, conv, emit stats."""
    return _run("conv3x3_norm_in_stats", x_padded_raw, kernel, mean, inv, tile_h)

