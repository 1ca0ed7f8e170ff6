"""The encoder/decoder conv + IN + ReLU segments with the fused backward
(counterpart of ``ircolor_tpu/ops/pallas_encdec.py``).

down1, down2 and up1 are a zero-SAME 3×3 conv (over the concat of the skip
legs for up1), a parameter-free instance norm and a ReLU. With
``pallas_encdec_bwd`` the generator runs them as ``conv_in_relu_fused``: the
forward is the same plain conv + one-pass IN + ReLU (no conv bias: it is
inert through the IN, and gets no gradient, as in the JAX package); the
backward is

* the ReLU-masked cotangent's moments from the saved raw output,
* one dgrad over the full kernel (``resblock.conv3x3_dgrad_fused`` with
  ``pad="zero"``, ``mask_p=True``, no aux), dz split along channels per leg,
* per leg, the fused wgrad (``conv3x3_wgrad_fused``, ``"fused"``) or, for
  a leg whose channels are not 128-aligned (down1's 64), cuDNN's weight
  gradient of the conv from the dy the dgrad stores (``"xla"``, as the JAX
  package leaves it to XLA).

The concat of the decoder's skip legs is never built, in either direction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ircolor_tpu_torch.kernels.resblock import conv3x3_dgrad_fused, conv3x3_wgrad_fused
from ircolor_tpu_torch.ops.norm import instance_norm_stats

# The JAX kernels' dx-concat scratch budget; it gates the route, as there.
_XCAT_BUDGET_BYTES = 12 * 1024 * 1024
WGRAD_MODES = ("fused", "xla")


def seg_tile_h(h: int, w: int, c_dy: int, itemsize: int = 2) -> int | None:
    """The JAX tile height (≤ 32, dividing ``h``) whose (th+2, w, 3·c)
    scratch fits the budget; None where none does (the route is off)."""
    for th in (32, 16, 8, 4):
        if h % th != 0:
            continue
        if (th + 2) * w * 3 * c_dy * itemsize <= _XCAT_BUDGET_BYTES:
            return th
    return None


def _conv_zero(z: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """NHWC ``z`` ⊛ HWIO ``k``, zero-SAME, no bias."""
    return F.conv2d(z.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)


def _widths(zs) -> list[int]:
    return [z.shape[-1] for z in zs]


def _legs(zs, k):
    """(leg, its slice of the HWIO kernel's input channels) pairs."""
    return zip(zs, k.split(_widths(zs), dim=2))


def _seg_primal(zs: tuple, k: torch.Tensor):
    """relu(IN(Σ_leg conv_zero_same(z_leg, k_leg))) and what the backward
    keeps: the raw sum and its one-pass IN moments."""
    raw = None
    for z, kk in _legs(zs, k):
        part = _conv_zero(z, kk)
        raw = part if raw is None else raw + part
    m, inv = instance_norm_stats(raw)
    n32 = (raw.float() - m[:, None, None, :]) * inv[:, None, None, :]
    return torch.relu(n32).to(raw.dtype), raw, m, inv


def _seg_bwd(wgrad_mode: str, zs: tuple, k: torch.Tensor, raw, m, inv, g):
    # Moments of the ReLU-masked cotangent p' = g·[n̂ > 0] against n̂, from
    # the raw moments: gm = E[p'], gy = (E[p'·raw] − m·E[p'])·inv.
    gf, r32 = g.float(), raw.float()
    gmask = torch.where(r32 > m[:, None, None, :], gf, torch.zeros_like(gf))
    gm = gmask.mean(dim=(1, 2))
    gy = ((gmask * r32).mean(dim=(1, 2)) - m * gm) * inv
    dz, dy = conv3x3_dgrad_fused(g, raw, None, k, m, inv, gm, gy,
                                 emit_dy=wgrad_mode == "xla", pad="zero", mask_p=True)
    dzs = dz.split(_widths(zs), dim=-1)
    if wgrad_mode == "fused":
        dk = torch.cat([conv3x3_wgrad_fused(z, g, raw, m, inv, gm, gy, pad="zero", mask_p=True)
                        for z in zs], dim=2)
    else:
        with torch.enable_grad():
            kk = k.detach().requires_grad_()
            y = sum(_conv_zero(z.detach(), kl) for z, kl in _legs(zs, kk))
            (dk,) = torch.autograd.grad(y, kk, dy)
    return dzs, dk.to(k.dtype)


class _ConvInRelu(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward keeps the legs, the kernel, the
    raw conv sum and its IN moments; the backward is ``_seg_bwd``."""

    @staticmethod
    def forward(ctx, wgrad_mode, k, *zs):
        out, raw, m, inv = _seg_primal(zs, k)
        ctx.save_for_backward(k, raw, m, inv, *zs)
        ctx.wgrad_mode = wgrad_mode
        return out

    @staticmethod
    def backward(ctx, g):
        k, raw, m, inv, *zs = ctx.saved_tensors
        zs = tuple(z.contiguous() for z in zs)
        dzs, dk = _seg_bwd(ctx.wgrad_mode, zs, k, raw.contiguous(), m, inv, g.contiguous())
        return (None, dk, *dzs)


def conv_in_relu_fused(wgrad_mode: str, zs: tuple, k: torch.Tensor) -> torch.Tensor:
    """``relu(instance_norm(conv3x3_zero_same(concat(zs), k)))`` with the
    fused backward. ``zs``: 1 NHWC leg (down stages) or 2 (the decoder's
    skip concat); ``k``: the full HWIO (3, 3, ΣC, Cout) kernel in the
    legs' dtype."""
    if wgrad_mode not in WGRAD_MODES:
        raise ValueError(f"wgrad_mode must be one of {WGRAD_MODES}, got {wgrad_mode!r}")
    if torch.is_grad_enabled() and (k.requires_grad or any(z.requires_grad for z in zs)):
        return _ConvInRelu.apply(wgrad_mode, k, *zs)
    return _seg_primal(zs, k)[0]
