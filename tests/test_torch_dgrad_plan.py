"""The dgrad's plan, fold lines and GEMM epilogue, on the CPU.

On the card ``conv3x3_dgrad_fused`` is three launches of
``csrc/conv_fwd.cu``: the operand pass (dy), for reflect halos the fold-line
kernel, and the forward conv's GEMM with the dgrad's epilogue. What
surrounds them is Python that these tests reach: ``_dgrad_plan`` (the
GEMM's tiling and N blocks), ``_dgrad_fold_terms`` (which fold-line entry
the epilogue adds to which pixel), and the plain versions of the three
launches, chained as the wrapper chains them. The plain version of the
whole function, ``conv3x3_dgrad_fused_plain``, is held against JAX in
``test_torch_train_kernels.py`` and ``test_torch_encdec.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ircolor_tpu_torch.kernels import resblock
from ircolor_tpu_torch.ops.norm import instance_norm_stats
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TH, TW = resblock._CF_TH, resblock._CF_TW


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(torch.bfloat16)


def _reflect(i: int, n: int) -> int:
    """ReflectionPad(1)'s source of padded coordinate i (−1 … n)."""
    return 1 if i == -1 else (n - 2 if i == n else i)


@pytest.mark.parametrize("b,h,w,c,cout", [
    (8, 128, 160, 256, 256),   # the flagship blocks
    (8, 512, 640, 128, 64),    # down1's segment: N = 64
    (8, 256, 320, 256, 128),   # down2's
    (8, 256, 320, 128, 384),   # up1's
    (2, 13, 21, 64, 128),      # partial tiles both ways
    (1, 4, 4, 128, 256),       # one tile: rows 1 and H−2 adjacent
    (2, 11, 40, 256, 64),      # odd H: H−2 shares an m64 pair with H−3
])
def test_plan_covers_every_pixel_and_channel_once(b, h, w, c, cout, monkeypatch):
    def no_card(*a, **k):
        raise AssertionError("the plan must not depend on the card")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(torch.cuda, "is_available", no_card)
    for pad in ("reflect", "zero"):
        plan = resblock._dgrad_plan(b, h, w, c, cout, pad)
        assert plan == resblock._dgrad_plan(b, h, w, c, cout, pad)
        assert plan.fold == (pad == "reflect")
    cp = plan.conv
    # One leg of dy, zero halos (TMA's zero fill), no operand pass of the
    # conv's own; N = 128 where it divides Cout, else 64.
    assert cp.chunks == (c // resblock._CF_KC,) and cp.shift == 1 and cp.pass_pad is None
    assert cp.bn == (128 if cout % 128 == 0 else 64) and cp.ncob * cp.bn == cout
    assert cp.ntiles == -(-h // TH) * -(-w // TW)  # the partials' rows: 8×32 tiles
    if b * h * w > 100_000:  # the flagship planes: the tiling alone, not every pixel
        return
    cover = np.zeros((b, h, w, cout), dtype=np.int32)
    rows = np.zeros((b, cp.ntiles), dtype=np.int32)
    for _, _, bi, tile, r0, c0, co0 in resblock._conv_blocks(cp):
        cover[bi, r0 : r0 + TH, c0 : c0 + TW, co0 : co0 + cp.bn] += 1
        rows[bi, tile] += 1
    assert (cover == 1).all() and (rows == cp.ncob).all()


@pytest.mark.parametrize("h,w", [(4, 4), (5, 5), (11, 40), (13, 21), (16, 64), (128, 160)])
def test_every_fold_source_is_added_once(h, w):
    """Each halo entry of the transposed conv (rows −1 and H, columns −1 and
    W, the four corners) reaches exactly one output pixel — the one
    ReflectionPad(1) maps it to — and only pixels on rows 1, H−2 or columns
    1, W−2 receive any; a tile that holds none of them receives nothing."""
    seen = {}
    for r in range(h):
        for c in range(w):
            for name, i, j in resblock._dgrad_fold_terms(h, w, r, c):
                # The padded F coordinate of the entry.
                src = (-1 if i == 0 else h, j - 1) if name == "rows" else (i, -1 if j == 0 else w)
                assert (_reflect(src[0], h), _reflect(src[1], w)) == (r, c), (name, i, j)
                assert src not in seen, src
                seen[src] = (r, c)
    halo = {(i, j) for i in range(-1, h + 1) for j in range(-1, w + 1)
            if i in (-1, h) or j in (-1, w)}
    assert set(seen) == halo
    edge = {(r, c) for r in range(h) for c in range(w) if r in (1, h - 2) or c in (1, w - 2)}
    assert set(seen.values()) == edge
    for tr in range(-(-h // TH)):
        for tc in range(-(-w // TW)):
            rs, cs = range(tr * TH, min(h, tr * TH + TH)), range(tc * TW, min(w, tc * TW + TW))
            holds = any(r in (1, h - 2) for r in rs) or any(c in (1, w - 2) for c in cs)
            got = [resblock._dgrad_fold_terms(h, w, r, c) for r in rs for c in cs]
            assert any(got) == holds


def _inputs(b, h, w, c, cin, seed=0):
    rng = np.random.default_rng(seed)
    p, comp = _bf16(rng, b, h, w, c), _bf16(rng, b, h, w, c)
    aux = _bf16(rng, b, h, w, cin)
    k = _bf16(rng, 3, 3, cin, c, scale=0.05)
    m, inv = instance_norm_stats(comp)
    mm, mi = instance_norm_stats(aux)
    gm, gy = (torch.from_numpy(rng.standard_normal((b, c), dtype=np.float32)) * 0.01
              for _ in range(2))
    return p, comp, aux, k, m, inv, gm, gy, (mm, mi)


def _via_plan(p, comp, aux, k, m, inv, gm, gy, mask_stats, *, pad, mask_p):
    """The wrapper's schedule on the plain launches: plan → pass → fold
    lines → GEMM → the per-tile partials summed in order."""
    b, h, w, c = p.shape
    plan = resblock._dgrad_plan(b, h, w, c, k.shape[2], pad)
    dy = resblock._dgrad_pass(p, comp, m, inv, gm, gy, mask_p)
    fold = resblock._dgrad_fold(dy, k) if plan.fold else None
    out, partial = resblock._dgrad_gemm(dy, resblock._dgrad_kernel(k), plan, aux, mask_stats, fold)
    if mask_stats is None:
        assert partial is None
        return out, dy
    assert partial.shape == (b, plan.conv.ntiles, 2, k.shape[2])
    return out, dy, partial.sum(dim=1)


FORMS = {  # (pad, mask_p, aux, mask_stats)
    "reflect mask-stats": ("reflect", False, True, True),
    "reflect residual": ("reflect", False, True, False),
    "zero mask_p no aux": ("zero", True, False, False),
    "zero no aux": ("zero", False, False, False),
}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("b,h,w,c,cin", [
    (2, 8, 32, 64, 128),   # a whole 8×32 tile
    (2, 13, 21, 128, 64),  # partial tiles both ways, N = 64
    (1, 4, 4, 64, 128),    # rows 1 and H−2 adjacent, every corner folds
    (1, 11, 40, 64, 192),  # odd H: H−2 in an m64 pair with H−3; N = 64 × 3
])
def test_k_loop_and_fold_match_dgrad_plain(form, b, h, w, c, cin):
    """The chained plain launches against ``conv3x3_dgrad_fused_plain``:
    dy bit for bit (the pass is the same roundings); dz within 2 bf16 ulps
    at its scale (the same f32 sums in another order, one rounding); the
    stats within 1e-5 relative in f32."""
    pad, mask_p, with_aux, with_stats = FORMS[form]
    p, comp, aux, k, m, inv, gm, gy, ms = _inputs(b, h, w, c, cin, seed=h + w)
    aux = aux if with_aux else None
    ms = ms if with_stats else None
    got = _via_plan(p, comp, aux, k, m, inv, gm, gy, ms, pad=pad, mask_p=mask_p)
    want = resblock.conv3x3_dgrad_fused_plain(p, comp, aux, k, m, inv, gm, gy, ms,
                                              pad=pad, mask_p=mask_p)
    assert torch.equal(got[1], want[1])
    scale = float(want[0].float().abs().max())
    assert float((got[0].float() - want[0].float()).abs().max()) <= 2 * 2.0**-8 * scale
    if with_stats:
        rel = (got[2] - want[2]).abs().max() / want[2].abs().max()
        assert float(rel) <= 1e-5


@pytest.mark.parametrize("h,w", [(4, 4), (7, 9), (12, 20)])
def test_fold_lines_are_the_transposed_convs_halo(h, w):
    """The fold lines' plain version against the halo of the full
    (unpadded) transposed conv in f32: rows −1 and H, columns −1 and W."""
    rng = np.random.default_rng(5)
    dy = _bf16(rng, 2, h, w, 64)
    k = _bf16(rng, 3, 3, 64, 64, scale=0.05)
    rows, cols = resblock._dgrad_fold_plain(dy, k)
    g = F.conv_transpose2d(dy.float().permute(0, 3, 1, 2), k.float().permute(3, 2, 0, 1))
    g = g.permute(0, 2, 3, 1)  # (B, H+2, W+2, Cout): padded coordinates
    assert rows.shape == (2, 2, w + 2, 64) and cols.shape == (2, h, 2, 64)
    torch.testing.assert_close(rows, torch.stack([g[:, 0], g[:, h + 1]], dim=1),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cols, torch.stack([g[:, 1 : h + 1, 0], g[:, 1 : h + 1, w + 1]],
                                                 dim=2), rtol=1e-5, atol=1e-5)


def test_kdg_is_the_rot180_transpose_of_conv_transpose2d():
    """The zero-SAME correlation of dy with kdg (HWIO (3, 3, C, Cin)) is the
    ``conv_transpose2d(dy, k, padding=1)`` that ``_zero_conv_dgrad`` and
    ``_reflect_conv_dgrad`` take, in f32."""
    rng = np.random.default_rng(6)
    dy = _bf16(rng, 2, 9, 13, 64).float()
    k = _bf16(rng, 3, 3, 32, 64, scale=0.05)
    kdg = resblock._dgrad_kernel(k)
    assert kdg.shape == (3, 3, 64, 32) and kdg.dtype == torch.bfloat16 and kdg.is_contiguous()
    for ty in range(3):
        for tx in range(3):
            assert torch.equal(kdg[ty, tx], k[2 - ty, 2 - tx].T)
    x = dy.permute(0, 3, 1, 2)
    got = F.conv2d(x, kdg.float().permute(3, 2, 0, 1), padding=1)
    want = F.conv_transpose2d(x, k.float().permute(3, 2, 0, 1), padding=1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.permute(0, 2, 3, 1),
                               resblock._zero_conv_dgrad(dy, k.float()), rtol=1e-5, atol=1e-5)
