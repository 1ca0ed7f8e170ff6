"""The int8 conv's plan, weight repack, reflect pass and GEMM, on the CPU.

On the card ``conv3x3_int8`` is one or two launches of ``csrc/conv_fwd.cu``:
for reflect padding the int8 operand pass copies the quantized input
reflect-padded, then the forward conv's GEMM on s8 operands runs with the
q-conv epilogue (dequantize, + addend, + bias, f32 or bf16, the channels
past Cout masked). Zero halos need no pass: the GEMM's A boxes start one
pixel up and left and TMA fills what lies outside the input with zeros, as
it fills the channels past Cin of the last 64-channel chunk. What surrounds
the kernel is Python that these tests reach: the plan
(``conv_int8._plan``, ``resblock._conv_plan(..., s8=True, bn=...)``), the
zero-extended K-major weights and the boxes read from them, the pass's
plain version, the GEMM's plain version, and the shape guard. The plain
version of the whole function, ``conv3x3_int8_plain``, is held against JAX
in ``test_torch_quant.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ircolor_tpu_torch.kernels import conv_int8, resblock
from ircolor_tpu_torch.models.generator import ResnetUNetGenerator
from ircolor_tpu_torch.ops import quant as tquant
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TH, TW, KC = resblock._CF_TH, resblock._CF_TW, resblock._CF_KC_S8



def _int8(rng, *shape):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))


def _a_box(src: torch.Tensor, ci0: int, col: int, row: int, b: int) -> torch.Tensor:
    """What TMA copies for an A box at (ci0, col, row, b) of ``src`` (B, H,
    W, C): (TH + 2 rows, TW columns, KC channels), zeros outside ``src``
    (negative coordinates and channels past C included)."""
    box = torch.zeros((TH + 2, TW, KC), dtype=torch.float64)
    _, h, w, c = src.shape
    r0, r1 = max(row, 0), min(row + TH + 2, h)
    c0, c1 = max(col, 0), min(col + TW, w)
    k1 = min(ci0 + KC, c)
    if r0 < r1 and c0 < c1 and ci0 < k1:
        part = src[b, r0:r1, c0:c1, ci0:k1].double()
        box[r0 - row : r1 - row, c0 - col : c1 - col, : k1 - ci0] = part
    return box


@pytest.mark.parametrize("pad,c,cout", [
    ("zero", 96, 32),      # two K chunks, the second half past Cin; N = 64, Cout' = 64
    ("reflect", 32, 128),  # one chunk half past Cin; N = 128 or 64 by the waves
    ("zero", 48, 160),     # Cout' = 192: N = 64, three output-channel blocks
])
def test_plan_boxes_compute_every_output_block(pad, c, cout):
    """Block by block, in the kernel's arithmetic: each stage's A box read at
    (ci0, c0 + dx − shift, r0 − shift, b) of the GEMM's source (the input
    itself for zero halos, its reflect-padded copy otherwise; TMA's zero fill
    outside it and past Cin), each tap's m64 operand at the bf16 tap offsets
    of ``_conv_a_offsets`` (one 64-byte row a pixel), and the B box of the
    zero-extended weights, summed over the plan's stages, give every output
    pixel and channel that exists the exact integer conv. The stage bytes
    are the A box's 20 KB and the B box's 12 KB per 64 output channels."""
    rng = np.random.default_rng(0)
    b, h, w = 2, 9, 37  # partial tiles both ways
    xq, wq = _int8(rng, b, h, w, c), _int8(rng, 3, 3, c, cout)
    plan = conv_int8._plan(b, h, w, c, cout, pad)
    coutp = -(-cout // 64) * 64
    assert plan.shift == int(pad == "zero") and plan.pass_pad == (1 if pad == "reflect" else None)
    assert plan.bn in (64, 128) and coutp % plan.bn == 0 and plan.ncob * plan.bn == coutp
    assert plan.chunks == (-(-c // KC),) and plan.a_box == (KC, TW, TH + 2, 1)
    assert plan.b_box == (KC, plan.bn, 1, 3)
    assert np.prod(plan.a_box) == 20 * 1024 and np.prod(plan.b_box) == plan.bn // 64 * 12 * 1024
    src = conv_int8._pad(xq) if pad == "reflect" else xq
    kt = resblock._q_weights(wq, plan)
    kflat, cinp, coutp = kt.reshape(-1).double(), kt.shape[3], kt.shape[2]
    want = conv_int8.int_conv_exact(xq, wq, pad)
    rows = {key: off // (2 * resblock._CF_KC) for key, off in resblock._conv_a_offsets().items()}
    seen = 0
    for _, _, bi, _, r0, c0, co0 in resblock._conv_blocks(plan):
        acc = torch.zeros((TH * TW, plan.bn), dtype=torch.float64)
        for chunk in range(plan.chunks[0]):
            for dx in range(3):
                a = _a_box(src, chunk * KC, c0 + dx - plan.shift, r0 - plan.shift, bi)
                a = a.reshape(-1, KC)
                bbox = resblock._q_b_box(kflat, cinp, coutp, chunk * KC, co0, dx, plan.bn)
                for (wg, t, dy), start in rows.items():
                    m = slice((4 * wg + 2 * t) * TW, (4 * wg + 2 * t + 2) * TW)
                    acc[m] += a[start : start + 2 * TW] @ bbox[dy].T
        acc = acc.reshape(TH, TW, plan.bn)
        hh, ww, nn = min(TH, h - r0), min(TW, w - c0), min(plan.bn, cout - co0)
        assert torch.equal(acc[:hh, :ww, :nn], want[bi, r0 : r0 + hh, c0 : c0 + ww, co0 : co0 + nn])
        assert not acc[:hh, :ww, nn:].any()  # the zero-extended channels
        seen += hh * ww * nn
    assert seen == b * h * w * cout


@pytest.mark.parametrize("c,cout", [(16, 32), (96, 64), (32, 128), (48, 160), (256, 256)])
def test_zero_extended_weights_land_once_where_the_box_reads_them(c, cout):
    """The repack (3, 3, Cout', Cin'), Cin' = Cin rounded up to 64 and Cout'
    to the plan's N, read through the GEMM's weight map (``_q_b_box``):
    over the plan's stages and output-channel blocks every weight is read
    exactly once, at (dy, n, k) of the box of (ci0, co0, dx), and every
    other entry a box reads is zero."""
    ids = torch.arange(1, 9 * c * cout + 1, dtype=torch.int64).reshape(3, 3, c, cout)
    for bn in (64, 128):
        if -(-cout // 64) * 64 % bn:
            continue
        plan = resblock._conv_plan(1, 8, 32, (c,), cout, "zero", s8=True, bn=bn)
        kt = resblock._q_weights(ids, plan)
        cinp, coutp = plan.chunks[0] * KC, plan.ncob * bn
        assert kt.shape == (3, 3, coutp, cinp) and kt.is_contiguous()
        assert cinp - c < KC and coutp - cout < bn
        seen = torch.zeros(9 * c * cout + 1, dtype=torch.int64)
        for chunk in range(plan.chunks[0]):
            for dx in range(3):
                for cob in range(plan.ncob):
                    ci0, co0 = chunk * KC, cob * bn
                    box = resblock._q_b_box(kt.reshape(-1), cinp, coutp, ci0, co0, dx, bn)
                    want = torch.zeros((3, bn, KC), dtype=torch.int64)
                    part = ids[:, dx, ci0 : ci0 + KC, co0 : co0 + bn].transpose(1, 2)
                    want[:, : part.shape[1], : part.shape[2]] = part
                    assert torch.equal(box, want)
                    seen.index_add_(0, box.reshape(-1), torch.ones(box.numel(), dtype=torch.int64))
        assert bool((seen[1:] == 1).all())


@pytest.mark.parametrize("cout", [32, 64, 128])
@pytest.mark.parametrize("cin", [32, 64, 96])
@pytest.mark.parametrize("pad", ["zero", "reflect"])
def test_gemm_emulation_matches_plain_bit_for_bit(pad, cin, cout):
    """The chained plain launches (the reflect pass where the site has one;
    the GEMM: exact sums in the kernel's K order over whole tiles and
    64-channel chunks, the weights zero-extended and read back as HWIO; the
    q-conv epilogue on the pixels and channels that exist) give
    ``conv3x3_int8_plain`` bit for bit: f32 and bf16 output, with and
    without addend and bias."""
    rng = np.random.default_rng(cin + cout)
    b, h, w = 2, 9, 35
    xq, wq = _int8(rng, b, h, w, cin), _int8(rng, 3, 3, cin, cout)
    sc = torch.from_numpy(rng.random((b, cout), dtype=np.float32) * 1e-4)
    bias = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32))
    addend = torch.from_numpy(rng.standard_normal((b, h, w, cout), dtype=np.float32))
    plan = conv_int8._plan(b, h, w, cin, cout, pad)
    src = conv_int8._pad(xq) if pad == "reflect" else xq
    if pad == "reflect":
        want_pad = F.pad(xq.double().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        assert torch.equal(src.double(), want_pad.permute(0, 2, 3, 1))
    kt = resblock._q_weights(wq, plan)
    forms = (dict(out_dtype=torch.float32), dict(out_dtype=torch.float32, addend=addend),
             dict(bias=bias, addend=addend), dict(bias=bias), {})
    for kw in forms:
        got = conv_int8._gemm(src, kt, sc, plan, **kw)
        want = conv_int8.conv3x3_int8_plain(xq, wq, sc, pad=pad, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want), sorted(kw)


@pytest.mark.parametrize("ngf", [16, 32, 64])
def test_guard_accepts_every_site_of_the_int8_route(ngf, monkeypatch):
    """The generator's batch-1 int8 route (bf16, no fused gate engages at
    16×24) at ngf 16, 32 and 64 calls the int8 conv at down1, down2, the
    block convs, and both legs of up1 and up2; the card's guard takes every
    one of those shapes, and its plan covers them. Cin % 16 ≠ 0 (ngf 8's
    down1) and Cout % 16 ≠ 0 still raise."""
    sites = []
    real = tquant.conv3x3_int8

    def recorded(xq, wq, sc, **kw):
        sites.append((tuple(xq.shape), wq.shape[-1], kw.get("pad", "zero")))
        return real(xq, wq, sc, **kw)

    monkeypatch.setattr(tquant, "conv3x3_int8", recorded)
    gen = ResnetUNetGenerator(ngf=ngf, n_blocks=1, dtype=torch.bfloat16, quant_int8=True,
                              pallas_block=True, pallas_norm_blur=True, pallas_head=True,
                              pallas_norm_blur_min_area=18000, pallas_head_min_area=100000)
    gen.init_weights("normal", 0.02, torch.Generator().manual_seed(0))
    x = torch.rand((1, 16, 24, 1), generator=torch.Generator().manual_seed(1)) * 2 - 1
    with torch.inference_mode():
        assert gen.eval()._quant_convs(x)
        assert bool(torch.isfinite(gen(x).float()).all())
    n = ngf
    assert [(shape[-1], cout, pad) for shape, cout, pad in sites] == [
        (n, 2 * n, "zero"), (2 * n, 4 * n, "zero"), (4 * n, 4 * n, "reflect"),
        (4 * n, 4 * n, "reflect"), (4 * n, 2 * n, "zero"), (2 * n, 2 * n, "zero"),
        (2 * n, n, "zero"), (n, n, "zero")]
    for (b, h, w, c), cout, pad in sites:
        conv_int8.check_shape(b, h, w, c, cout)
        plan = conv_int8._plan(b, h, w, c, cout, pad)
        assert plan.chunks[0] * KC >= c and plan.ncob * plan.bn >= cout
        assert plan.ntr * TH >= h and plan.ntc * TW >= w
    with pytest.raises(ValueError, match="Cin % 16"):
        conv_int8.check_shape(1, 16, 24, 8, 16)
    with pytest.raises(ValueError, match="Cout % 16"):
        conv_int8.check_shape(1, 16, 24, 16, 24)
    with pytest.raises(ValueError, match="H, W >= 2"):
        conv_int8.check_shape(1, 1, 24, 16, 16)
