"""The int8 conv at stride 2 and on a pre-padded (VALID) input, on the CPU.

At stride 2 ``conv3x3_int8`` is one launch of ``csrc/conv_fwd.cu``'s GEMM
on the card for zero and VALID halos (two with reflect halos: the int8
reflect pass first). The GEMM reads its source through TMA boxes with
element strides of 2 on W and H: a stage (64-channel chunk, dx) holds the
TH + 1 source rows 2·r0 − shift + 2u, which serve taps dy = 0 and 2 at
buffer rows 4·wg + 2·t + dy // 2, and the TH rows from the row after,
which serve dy = 1, each box TW columns, every other one from 2·c0 + dx −
shift. VALID at stride 1 is the GEMM on the input as it comes, shift 0.
These tests hold that arithmetic, in Python, against the exact integer
conv and the plain version against the JAX package's
``conv2d_int8(stride=2)``.
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


def _s2_box(src: torch.Tensor, ci0: int, col: int, row: int, b: int, rows: int) -> torch.Tensor:
    """What TMA lands for a strided A box at (ci0, col, row, b) of ``src``
    (element strides 2 on W and H): (``rows``, TW, KC), entry (u, v) =
    src[b, row + 2u, col + 2v, ci0 : ci0 + KC], zeros outside ``src``."""
    _, h, w, c = src.shape
    r = row + 2 * torch.arange(rows)
    q = col + 2 * torch.arange(TW)
    box = torch.zeros((rows, TW, KC), dtype=torch.float64)
    rin, qin = (r >= 0) & (r < h), (q >= 0) & (q < w)
    k1 = min(ci0 + KC, c)
    if rin.any() and qin.any() and ci0 < k1:
        sub = src[b][r[rin]][:, q[qin], ci0:k1].double()
        box[rin.nonzero()[:, 0][:, None], qin.nonzero()[:, 0][None, :], : k1 - ci0] = sub
    return box


def _stage_boxes(src: torch.Tensor, plan, ci0: int, r0: int, c0: int, dx: int, b: int):
    """A stage's two A boxes: the rows of taps dy 0 and 2 (TH + 1), then
    those of dy 1 (TH), as the producer loads them."""
    col, row = 2 * c0 + dx - plan.shift, 2 * r0 - plan.shift
    return (_s2_box(src, ci0, col, row, b, TH + 1), _s2_box(src, ci0, col, row + 1, b, TH))


def _tap_rows(boxes, dy: int, wg: int, t: int) -> torch.Tensor:
    """Sub-tile t of warpgroup wg's A operand for tap dy: two box rows of
    TW pixels, (64, KC), from the box and row offset the consumer's
    descriptor names."""
    row = 4 * wg + 2 * t
    box, first = (boxes[1], row) if dy == 1 else (boxes[0], row + dy // 2)
    return box[first : first + 2].reshape(2 * TW, KC)


def _xp_ext(xq: torch.Tensor, pad: str) -> torch.Tensor:
    """Xp (``xq`` padded by one pixel of ``pad``, or as it is for
    ``"valid"``) followed by enough zero rows and columns for any tile."""
    p = 0 if pad == "valid" else 1
    mode = {"zero": "constant", "reflect": "reflect", "valid": "constant"}[pad]
    xp = torch.nn.functional.pad(xq.double().permute(0, 3, 1, 2), (p, p, p, p), mode=mode)
    xp = xp.permute(0, 2, 3, 1)
    b, h, w, c = xp.shape
    ext = torch.zeros((b, h + 4 * TH, w + 4 * TW, c), dtype=torch.float64)
    ext[:, :h, :w] = xp
    return ext


@pytest.mark.parametrize("pad,h,w", [("zero", 17, 70), ("zero", 16, 64), ("reflect", 9, 33),
                                     ("valid", 19, 67)])
def test_strided_boxes_hold_every_tap(pad, h, w):
    """Every output pixel of every tile (those past the plane too) finds
    Xp[2i + dy, 2j + dx] in its stage's boxes at the tap's row offset, Xp
    the input padded as ``pad`` says and zeros past it: the source is
    ``xq`` itself (zero, VALID) or its reflect copy, with no other pass."""
    rng = np.random.default_rng(3)
    xq = _int8(rng, 2, h, w, 16)
    ho, wo = conv_int8.out_hw(h, w, pad, 2)
    plan = conv_int8._plan(2, ho, wo, 16, 16, pad, 2)
    src = conv_int8._source(xq, pad)
    assert (src is xq) == (pad != "reflect")
    xp = _xp_ext(xq, pad)
    i, j = torch.arange(TH), torch.arange(TW)
    for _, _, bi, _, r0, c0, _ in resblock._conv_blocks(plan):
        for dx in range(3):
            boxes = _stage_boxes(src, plan, 0, r0, c0, dx, bi)
            for dy in range(3):
                want = xp[bi][(2 * (r0 + i) + dy)[:, None], (2 * (c0 + j) + dx)[None, :], :16]
                got = torch.cat([_tap_rows(boxes, dy, wg, t) for wg in range(2) for t in range(2)])
                assert torch.equal(got.reshape(TH, TW, KC)[..., :16], want), (r0, c0, dx, dy)
                assert not got[:, 16:].any()


def _stage_blocks(src: torch.Tensor, kt: torch.Tensor, plan):
    """The stride-2 GEMM, block by block, in the kernel's arithmetic: stage
    (chunk, dx) loads the two strided A boxes of ``_stage_boxes`` and the
    weight box at (chunk·64, co0, dx); tap dy's operand is ``_tap_rows``.
    Yields (batch index, r0, c0, co0, the block's exact sums (TH, TW, bn)
    as float64, the stages it ran)."""
    kflat, cinp, coutp = kt.reshape(-1).double(), kt.shape[3], kt.shape[2]
    for _, _, bi, _, r0, c0, co0 in resblock._conv_blocks(plan):
        acc = torch.zeros((TH * TW, plan.bn), dtype=torch.float64)
        stages = 0
        for chunk in range(plan.chunks[0]):
            for dx in range(3):
                stages += 1
                bbox = resblock._q_b_box(kflat, cinp, coutp, chunk * KC, co0, dx, plan.bn)
                boxes = _stage_boxes(src, plan, chunk * KC, r0, c0, dx, bi)
                for dy in range(3):
                    for wg in range(2):
                        for t in range(2):
                            m = slice((4 * wg + 2 * t) * TW, (4 * wg + 2 * t + 2) * TW)
                            acc[m] += _tap_rows(boxes, dy, wg, t) @ bbox[dy].T
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
    channels past Cout zero; three stages a chunk, (chunk, dx), as at
    stride 1."""
    rng = np.random.default_rng(c + cout)
    b, h, w = 2, 19, 75  # partial tiles both ways, odd planes
    xq, wq = _int8(rng, b, h, w, c), _int8(rng, 3, 3, c, cout)
    ho, wo = conv_int8.out_hw(h, w, pad, 2)
    plan = conv_int8._plan(b, ho, wo, c, cout, pad, 2)
    assert (plan.h, plan.w, plan.stride, plan.shift, plan.pass_pad) == (
        ho, wo, 2, int(pad == "zero"), 1 if pad == "reflect" else None)
    src = conv_int8._source(xq, pad)
    kt = resblock._q_weights(wq, plan)
    want = conv_int8.int_conv_exact(xq, wq, pad, 2)
    assert want.shape[1:3] == (ho, wo)
    seen = 0
    for bi, r0, c0, co0, acc, stages in _stage_blocks(src, kt, plan):
        hh, ww, nn = min(TH, ho - r0), min(TW, wo - c0), min(plan.bn, cout - co0)
        assert torch.equal(acc[:hh, :ww, :nn], want[bi, r0 : r0 + hh, c0 : c0 + ww, co0 : co0 + nn])
        assert not acc[:hh, :ww, nn:].any()
        assert stages == 3 * plan.chunks[0]
        seen += hh * ww * nn
    assert seen == b * ho * wo * cout


@pytest.mark.parametrize("stride,pad", [(2, "zero"), (2, "reflect"), (2, "valid"), (1, "valid")])
@pytest.mark.parametrize("cin,cout", [(16, 32), (48, 64), (128, 256)])
def test_gemm_emulation_matches_plain_bit_for_bit(stride, pad, cin, cout):
    """The chained plain launches (the reflect pass where the pad asks for
    it and the stages' sums of ``_stage_blocks`` at stride 2; at VALID
    stride 1 the GEMM's plain
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
    src = conv_int8._source(xq, pad)
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
