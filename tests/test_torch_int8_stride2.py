"""The int8 conv at stride 2 and on a pre-padded (VALID) input, on the CPU.

At stride 2 ``conv3x3_int8`` is two launches of ``csrc/conv_fwd.cu`` on the
card: the phase pass writes the four (row, column) parity planes of the
padded input stacked as Q (B, 2(Ho+1), 2(Wo+1), C), then the q-conv GEMM
runs six stages a 64-channel chunk, (dx, row parity): the even box at Q row
r0 serves taps dy = 0 and 2 at buffer rows 0 and 1, the odd box at row r0 +
Ho + 1 serves dy = 1, each at column c0 + (0, Wo + 1, 1)[dx]. VALID at
stride 1 is the GEMM on the input as it comes, shift 0. These tests hold
that arithmetic, in Python, against the exact integer conv and the plain
version against the JAX package's ``conv2d_int8(stride=2)``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ircolor_tpu.ops import quant as jquant
from ircolor_tpu_torch.kernels import conv_int8, resblock
from ircolor_tpu_torch.ops import quant as tquant
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TH, TW, KC = resblock._CF_TH, resblock._CF_TW, resblock._CF_KC_S8


def _int8(rng, *shape):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))


def _a_box(src: torch.Tensor, ci0: int, col: int, row: int, b: int) -> torch.Tensor:
    """What TMA copies for an A box at (ci0, col, row, b) of ``src``: (TH + 2
    rows, TW columns, KC channels), zeros outside ``src``."""
    box = torch.zeros((TH + 2, TW, KC), dtype=torch.float64)
    _, h, w, c = src.shape
    r0, r1 = max(row, 0), min(row + TH + 2, h)
    c0, c1 = max(col, 0), min(col + TW, w)
    k1 = min(ci0 + KC, c)
    if r0 < r1 and c0 < c1 and ci0 < k1:
        box[r0 - row : r1 - row, c0 - col : c1 - col, : k1 - ci0] = src[b, r0:r1, c0:c1, ci0:k1].double()
    return box


@pytest.mark.parametrize("pad,h,w", [("zero", 17, 70), ("zero", 16, 64), ("reflect", 9, 33),
                                     ("valid", 19, 67)])
def test_phase_planes_hold_every_parity(pad, h, w):
    """Q[py·(Ho+1) + u, px·(Wo+1) + v] = Xp[2u + py, 2v + px], Xp the input
    padded as ``pad`` says, zeros past Xp; odd and even planes alike."""
    rng = np.random.default_rng(3)
    xq = _int8(rng, 2, h, w, 16)
    ho, wo = conv_int8.out_hw(h, w, pad, 2)
    q = conv_int8._phases(xq, pad, ho, wo)
    assert q.shape == (2, 2 * (ho + 1), 2 * (wo + 1), 16) and q.dtype == torch.int8
    p = 0 if pad == "valid" else 1
    mode = {"zero": "constant", "reflect": "reflect", "valid": "constant"}[pad]
    xp = torch.nn.functional.pad(xq.double().permute(0, 3, 1, 2), (p, p, p, p), mode=mode)
    xp = xp.permute(0, 2, 3, 1)
    for py in (0, 1):
        for px in (0, 1):
            plane = q[:, py * (ho + 1) : (py + 1) * (ho + 1), px * (wo + 1) : (px + 1) * (wo + 1)]
            for u in range(ho + 1):
                for v in range(wo + 1):
                    r, c = 2 * u + py, 2 * v + px
                    want = xp[:, r, c] if r < xp.shape[1] and c < xp.shape[2] else 0 * xp[:, 0, 0]
                    assert torch.equal(plane[:, u, v].double(), want), (py, px, u, v)


def _stage_blocks(src: torch.Tensor, kt: torch.Tensor, plan):
    """The stride-2 GEMM, block by block, in the kernel's arithmetic: stage
    (chunk, dx, parity) loads the A box at (chunk·64, c0 + (0, Wo+1, 1)[dx],
    r0 + parity·(Ho+1)) of the parity planes ``src``; the even stage's taps
    dy = 0 and 2 read its rows from 4·wg + 2·t + dy // 2, the odd stage's
    dy = 1 from 4·wg + 2·t; the B box is the stride-1 one. Yields (batch
    index, r0, c0, co0, the block's exact sums (TH, TW, bn) as float64, the
    stages it ran)."""
    ho, wo = plan.h, plan.w
    kflat, cinp, coutp = kt.reshape(-1).double(), kt.shape[3], kt.shape[2]
    col_off, row_off = (0, wo + 1, 1), (0, ho + 1)
    for _, _, bi, _, r0, c0, co0 in resblock._conv_blocks(plan):
        acc = torch.zeros((TH * TW, plan.bn), dtype=torch.float64)
        stages = 0
        for chunk in range(plan.chunks[0]):
            for dx in range(3):
                bbox = resblock._q_b_box(kflat, cinp, coutp, chunk * KC, co0, dx, plan.bn)
                for par in (0, 1):
                    stages += 1
                    a = _a_box(src, chunk * KC, c0 + col_off[dx], r0 + row_off[par], bi)
                    a = a.reshape(-1, KC)
                    for dy in ((0, 2) if par == 0 else (1,)):
                        for wg in range(2):
                            for t in range(2):
                                start = (4 * wg + 2 * t + dy // 2) * TW
                                m = slice((4 * wg + 2 * t) * TW, (4 * wg + 2 * t + 2) * TW)
                                acc[m] += a[start : start + 2 * TW] @ bbox[dy].T
        yield bi, r0, c0, co0, acc.reshape(TH, TW, plan.bn), stages


def _stage_sums(src: torch.Tensor, kt: torch.Tensor, plan) -> torch.Tensor:
    """The exact sums of ``_stage_blocks`` on the pixels and channels that
    exist, (B, Ho, Wo, Cout) float64."""
    out = torch.zeros((src.shape[0], plan.h, plan.w, plan.cout), dtype=torch.float64)
    for bi, r0, c0, co0, acc, _ in _stage_blocks(src, kt, plan):
        hh, ww = min(TH, plan.h - r0), min(TW, plan.w - c0)
        nn = min(plan.bn, plan.cout - co0)
        out[bi, r0 : r0 + hh, c0 : c0 + ww, co0 : co0 + nn] = acc[:hh, :ww, :nn]
    return out


@pytest.mark.parametrize("pad,c,cout", [
    ("zero", 64, 128),    # down1's channels at ngf 64 (one chunk, N = 128)
    ("zero", 96, 32),     # two chunks, the second half past Cin; Cout' = 64
    ("reflect", 32, 160), # Cout' = 192: N = 64, three output-channel blocks
    ("valid", 16, 16),
])
def test_stride2_stages_compute_every_output_block(pad, c, cout):
    """Block by block, the stages of ``_stage_blocks`` give every output
    pixel and channel that exists the exact stride-2 integer conv, and the
    channels past Cout zero; six stages a chunk."""
    rng = np.random.default_rng(c + cout)
    b, h, w = 2, 19, 75  # partial tiles both ways, odd planes
    xq, wq = _int8(rng, b, h, w, c), _int8(rng, 3, 3, c, cout)
    ho, wo = conv_int8.out_hw(h, w, pad, 2)
    plan = conv_int8._plan(b, ho, wo, c, cout, pad, 2)
    assert (plan.h, plan.w, plan.stride, plan.shift, plan.pass_pad) == (ho, wo, 2, 0, None)
    src = conv_int8._source(xq, pad, 2, plan)
    kt = resblock._q_weights(wq, plan)
    want = conv_int8.int_conv_exact(xq, wq, pad, 2)
    assert want.shape[1:3] == (ho, wo)
    seen = 0
    for bi, r0, c0, co0, acc, stages in _stage_blocks(src, kt, plan):
        hh, ww, nn = min(TH, ho - r0), min(TW, wo - c0), min(plan.bn, cout - co0)
        assert torch.equal(acc[:hh, :ww, :nn], want[bi, r0 : r0 + hh, c0 : c0 + ww, co0 : co0 + nn])
        assert not acc[:hh, :ww, nn:].any()
        assert stages == 6 * plan.chunks[0]
        seen += hh * ww * nn
    assert seen == b * ho * wo * cout


@pytest.mark.parametrize("stride,pad", [(2, "zero"), (2, "reflect"), (2, "valid"), (1, "valid")])
@pytest.mark.parametrize("cin,cout", [(16, 32), (48, 64), (128, 256)])
def test_gemm_emulation_matches_plain_bit_for_bit(stride, pad, cin, cout):
    """The chained plain launches (the phase pass and the stages' sums of
    ``_stage_blocks`` at stride 2; at VALID stride 1 the GEMM's plain
    version on the input as it comes; the q-conv epilogue) give
    ``conv3x3_int8`` and ``conv3x3_int8_plain`` bit for bit: f32 and bf16
    output, with and without addend and bias."""
    rng = np.random.default_rng(cin * cout + stride)
    b, h, w = 2, 13, 38
    xq, wq = _int8(rng, b, h, w, cin), _int8(rng, 3, 3, cin, cout)
    ho, wo = conv_int8.out_hw(h, w, pad, stride)
    sc = torch.from_numpy(rng.random((b, cout), dtype=np.float32) * 1e-4)
    bias = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32))
    addend = torch.from_numpy(rng.standard_normal((b, ho, wo, cout), dtype=np.float32))
    plan = conv_int8._plan(b, ho, wo, cin, cout, pad, stride)
    src = conv_int8._source(xq, pad, stride, plan)
    if stride == 1:
        assert src is xq and plan.shift == 0
    kt = resblock._q_weights(wq, plan)
    acc = _stage_sums(src, kt, plan) if stride == 2 else None
    for kw in (dict(out_dtype=torch.float32), dict(bias=bias, addend=addend), dict(bias=bias), {}):
        if stride == 2:
            got = conv_int8._epilogue(acc, sc, kw.get("bias"), kw.get("addend"),
                                      kw.get("out_dtype", torch.bfloat16))
        else:
            got = conv_int8._gemm(src, kt, sc, plan, **kw)
        want = conv_int8.conv3x3_int8_plain(xq, wq, sc, pad=pad, stride=stride, **kw)
        assert got.shape == (b, ho, wo, cout)
        assert got.dtype == want.dtype and torch.equal(got, want), sorted(kw)
        assert torch.equal(conv_int8.conv3x3_int8(xq, wq, sc, pad=pad, stride=stride, **kw), want)


@pytest.mark.parametrize("h,w", [(16, 20), (17, 21)])
def test_stride2_plain_matches_jax_bit_for_bit(h, w):
    """``conv2d_int8(stride=2)`` (the plain version on the CPU) against the
    JAX package's ``conv2d_int8(stride=2, padding=1)``: the same
    quantization, the same exact sums and the same epilogue steps, so the
    same bits; also ``conv2d_int8_fixed`` and a VALID conv of a
    replicate-padded input, at both strides."""
    rng = np.random.default_rng(h)
    x = rng.standard_normal((2, h, w, 32)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 32, 48)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    t = torch.from_numpy
    got = tquant.conv2d_int8(t(x), t(k), stride=2, bias=t(bias)).numpy()
    want = np.asarray(jquant.conv2d_int8(jnp.asarray(x), jnp.asarray(k), stride=2,
                                         padding=((1, 1), (1, 1)), bias=jnp.asarray(bias)))
    assert got.shape == want.shape == (2, (h + 1) // 2, (w + 1) // 2, 48)
    np.testing.assert_array_equal(got, want)
    xa = np.abs(x)
    got = tquant.conv2d_int8_fixed(t(xa), t(k), stride=2).numpy()
    want = np.asarray(jquant.conv2d_int8_fixed(jnp.asarray(xa), jnp.asarray(k), stride=2,
                                               padding=((1, 1), (1, 1))))
    np.testing.assert_array_equal(got, want)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    for stride in (1, 2):
        got = tquant.conv2d_int8(t(xp), t(k), pad="valid", stride=stride).numpy()
        want = np.asarray(jquant.conv2d_int8(jnp.asarray(xp), jnp.asarray(k), stride=stride,
                                             padding="VALID"))
        np.testing.assert_array_equal(got, want)


def test_guard_takes_the_stride2_sites():
    """The no_antialias int8 route's down convs at 512×640, ngf 64 (down1
    512×640×64 → 256×320×128, down2 256×320×128 → 128×160×256) and at ngf
    32 pass the card's guard; an input that leaves no output pixel raises,
    as does a stride or a pad the kernel has no form for."""
    for ngf in (32, 64):
        for b, h, w, c, cout in ((1, 512, 640, ngf, 2 * ngf), (32, 256, 320, 2 * ngf, 4 * ngf)):
            conv_int8.check_shape(b, h, w, c, cout, "zero", 2)
            plan = conv_int8._plan(b, h // 2, w // 2, c, cout, "zero", 2)
            assert plan.ntr * TH >= h // 2 and plan.ntc * TW >= w // 2
    with pytest.raises(ValueError, match="output pixel"):
        conv_int8.check_shape(1, 2, 2, 16, 16, "valid", 1)
    xq = torch.zeros((1, 8, 8, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="stride"):
        conv_int8.conv3x3_int8(xq, torch.zeros((3, 3, 16, 16), dtype=torch.int8),
                               torch.ones((1, 16)), stride=3)
    with pytest.raises(ValueError, match="pad"):
        conv_int8.conv3x3_int8(xq, torch.zeros((3, 3, 16, 16), dtype=torch.int8),
                               torch.ones((1, 16)), pad="replicate")
