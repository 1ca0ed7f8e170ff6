"""The controls' arithmetic: the reference computed one precision below what a
configuration states, by rounding each convolution's input and weight.

  int4  for int8 serving: symmetric, the input per sample and the weight
        per output channel, amax/7, round half to even, clip to +-7
        (the int8 route's scheme at 4 bits), at the conv sites that the
        cell's route runs in int8 (its mix's ``int8_sites``) and nowhere
        else: every other operation stays at the reference's float32
  fp8   for bf16 training: each input and weight scaled by 448 / its amax,
        cast to float8 e4m3 and back (per tensor, as fp8 training scales
        its GEMM operands); the gradient passes the rounding unchanged
"""

from __future__ import annotations

import torch


def _int_grid(t: torch.Tensor, dims: tuple, levels: int) -> torch.Tensor:
    amax = t.abs().amax(dim=dims, keepdim=True).clamp(min=1e-12)
    scale = amax / levels
    return torch.clamp(torch.round(t / scale), -levels, levels) * scale


def int4(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _int_grid(x, (1, 2, 3), 7), _int_grid(w, (1, 2, 3), 7)


def fp8(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    def cast(t):
        v = t.detach()
        scale = 448.0 / v.abs().amax().clamp(min=1e-12)
        q = (v * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
        return t + (q - v)

    return cast(x), cast(w)


CONTROLS = {"int4": int4, "fp8": fp8}
