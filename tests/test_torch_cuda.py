"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (the kernels have
no CPU mode). The file imports torch and the port only, so it also runs on
a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import pytest
import torch

from ircolor_tpu_torch.kernels import LAUNCHES, blur, block, conv, encdec, head, resblock
from ircolor_tpu_torch.kernels import instance_norm as tin
from ircolor_tpu_torch.ops.norm import instance_norm_stats


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16(gen, *shape, scale=1.0):
    return (torch.randn(*shape, device="cuda", generator=gen) * scale).to(torch.bfloat16)


@pytest.mark.cuda
# Whole 8×32 bf16 tiles, and partial bf16 and int8 (8×16) tiles.
@pytest.mark.parametrize("hw", [(16, 64), (16, 40), (13, 21)])
def test_block_kernels_match_plain_on_card(cuda, hw):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = _bf16(g, 2, *hw, 256)
    k1, k2 = _bf16(g, 3, 3, 256, 256, scale=0.05), _bf16(g, 3, 3, 256, 256, scale=0.05)
    before = dict(LAUNCHES)
    got = resblock.resnet_block_pallas(x, k1, k2).float()
    got_q = resblock.resnet_block_pallas_q(x, k1, k2).float()
    assert LAUNCHES["conv3x3_reflect_fused"] == before["conv3x3_reflect_fused"] + 2
    assert LAUNCHES["conv3x3_reflect_fused_q"] == before["conv3x3_reflect_fused_q"] + 2
    raw1, m1, i1 = resblock.conv3x3_reflect_fused_plain(x, k1)
    raw2, m2, i2 = resblock.conv3x3_reflect_fused_plain(raw1, k2, m1, i1)
    want = resblock._block_epilogue(x, raw2, m2, i2).float()
    # Both round the same f32 sums (accumulated in another order) to bf16:
    # two bf16 ulps at the output's largest magnitude.
    assert float((got - want).abs().max()) <= 2 * 2.0**-8 * float(want.abs().max())
    # int8 vs float block: the residual dominates; the branch differs by
    # the int8 grid's rounding noise only (bound of the JAX package's
    # test_resnet_block_pallas_q_tracks_float_block).
    assert float((got_q - got).abs().mean()) <= 0.03


@pytest.mark.cuda
def test_blur_and_head_kernels_match_plain_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    xb = _bf16(g, 2, 32, 48, 128)
    mb, ib = instance_norm_stats(xb)
    d = blur.norm_relu_blur_down_pallas(xb, mb, ib).float() - blur.norm_relu_blur_down_plain(xb, mb, ib).float()
    assert float(d.abs().max()) == 0.0  # same additions, same order
    xh = _bf16(g, 2, 20, 70, 64)  # partial 16×128 tiles
    kh = _bf16(g, 7, 7, 64, 3, scale=0.02)
    mh, ih = instance_norm_stats(xh)
    want = head.conv7x7_head_plain(xh, mh, ih, kh).float()
    got = head.conv7x7_head_pallas(xh, mh, ih, kh).float()
    assert float((got - want).abs().max()) <= 2 * 2.0**-8 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 16, 24, 32, 48, 64, 136])
@pytest.mark.parametrize("shape", [
    (2, 16, 244),  # two whole 122-column strips
    (2, 20, 70),   # a partial strip
    (1, 4, 4),     # the minimum plane
    (1, 150, 260), # two row bands and three strips, the last partial
])
def test_head_kernel_matches_plain_on_card(cuda, c, shape):
    """``csrc/head.cu``'s bf16 form against ``conv7x7_head_plain``: channels
    that fill no K step (8, 24, 48), 64-channel units (136), whole and partial
    tiles; one launch a call, and a repeat bit-exact."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = _bf16(g, *shape, c)
    k = _bf16(g, 7, 7, c, 3, scale=0.02)
    m, i = instance_norm_stats(x)
    before = LAUNCHES["conv7x7_head"]
    got = head.conv7x7_head_pallas(x, m, i, k)
    assert LAUNCHES["conv7x7_head"] == before + 1
    want = head.conv7x7_head_plain(x, m, i, k).float()
    assert float((got.float() - want).abs().max()) <= 2 * 2.0**-8 * float(want.abs().max())
    assert torch.equal(head.conv7x7_head_pallas(x, m, i, k), got)


@pytest.mark.cuda
def test_head_takes_the_generators_weight_view_on_card(cuda):
    """The generator hands the head an HWIO view of its OIHW weight (not
    contiguous): both forms take it and match their plain versions."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x = _bf16(g, 2, 20, 70, 64)
    k = _bf16(g, 3, 64, 7, 7, scale=0.02).permute(2, 3, 1, 0)
    assert not k.is_contiguous()
    m, i = instance_norm_stats(x)
    want = head.conv7x7_head_plain(x, m, i, k).float()
    got = head.conv7x7_head_pallas(x, m, i, k).float()
    assert float((got - want).abs().max()) <= 2 * 2.0**-8 * float(want.abs().max())
    assert torch.equal(head.conv7x7_head_pallas(x, m, i, k, quant=True),
                       head.conv7x7_head_q_plain(x, m, i, k))


@pytest.mark.cuda
def test_wrappers_raise_on_unsupported_cuda_input(cuda):
    x = torch.randn(1, 8, 16, 128, device=cuda)  # float32: the kernels are bf16-only
    k = torch.randn(3, 3, 128, 128, device=cuda)
    with pytest.raises(TypeError):
        resblock.conv3x3_reflect_fused(x, k)
    with pytest.raises(ValueError):  # Cout not a multiple of 128
        resblock.conv3x3_reflect_fused(x.to(torch.bfloat16), k[..., :120].to(torch.bfloat16))
    with pytest.raises(ValueError):  # odd width
        xo = torch.randn(1, 8, 15, 128, device=cuda, dtype=torch.bfloat16)
        blur.norm_relu_blur_down_pallas(xo, *instance_norm_stats(xo))
    with pytest.raises(ValueError):  # non-contiguous input
        xt = torch.randn(1, 8, 128, 16, device=cuda, dtype=torch.bfloat16).transpose(2, 3)
        blur.norm_relu_blur_down_pallas(xt, *instance_norm_stats(xt))
    xh = torch.randn(1 * 8 * 16 * 64 + 1, device=cuda).to(torch.bfloat16)[1:].view(1, 8, 16, 64)
    kh = torch.randn(7, 7, 64, 3, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):  # contiguous, 2 bytes past a boundary
        head.conv7x7_head_pallas(xh, *instance_norm_stats(xh), kh)
    with pytest.raises(ValueError, match="C % 8"):
        xc = torch.randn(1, 8, 16, 12, device=cuda).to(torch.bfloat16)
        head.conv7x7_head_pallas(xc, *instance_norm_stats(xc), kh[:, :, :12].contiguous())
    with pytest.raises(ValueError):  # weights on the CPU
        xa = xh.clone()
        head.conv7x7_head_pallas(xa, *instance_norm_stats(xa), kh.cpu())


def _bwd_inputs(g, b, h, w, c):
    f32 = lambda *s, scale=1.0: torch.randn(*s, device="cuda", generator=g) * scale  # noqa: E731
    p, comp, aux, z = (_bf16(g, b, h, w, c) for _ in range(4))
    k = _bf16(g, 3, 3, c, c, scale=0.05)
    m, inv = instance_norm_stats(comp)
    mm, mi = instance_norm_stats(aux)
    return p, comp, aux, z, k, m, inv, f32(b, c, scale=0.01), f32(b, c, scale=0.01), mm, mi


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 8, 16, 256),   # a half 8×32 tile
    (2, 13, 21, 128),  # partial tiles both ways
    (1, 4, 4, 128),    # one tile: rows 1 and H−2 adjacent, every fold corner
    (2, 8, 32, 256),   # a whole 8×32 tile
    (2, 11, 40, 64),   # odd H: H−2 in an m64 pair with H−3; N = 64
])
def test_backward_kernels_match_plain_on_card(cuda, shape):
    """The dgrad (operand pass, fold lines, ``csrc/conv_fwd.cu``'s GEMM) in
    both block forms, and the wgrad where it takes the width (Co % 128):
    full, partial and single tiles, p channels 64, 128 and 256; the dgrad's
    output and stats repeat bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(2)
    p, comp, aux, z, k, m, inv, gm, gy, mm, mi = _bwd_inputs(g, *shape)
    before = dict(LAUNCHES)
    for kw in (dict(mask_stats=(mm, mi)), {}):
        got = resblock.conv3x3_dgrad_fused(p, comp, aux, k, m, inv, gm, gy, **kw)
        want = resblock.conv3x3_dgrad_fused_plain(p, comp, aux, k, m, inv, gm, gy, **kw)
        scale = float(want[0].float().abs().max())
        assert float((got[0].float() - want[0].float()).abs().max()) <= 2 * 2.0**-8 * scale
        assert torch.equal(got[1], want[1])  # dy: the same roundings in the same order
        if kw:
            d = (got[2] - want[2]).abs().max() / want[2].abs().max()
            assert float(d) <= 1e-3
        again = resblock.conv3x3_dgrad_fused(p, comp, aux, k, m, inv, gm, gy, **kw)
        assert torch.equal(got[0], again[0]) and (not kw or torch.equal(got[2], again[2]))
    wgrad = shape[-1] % 128 == 0
    if wgrad:
        for znorm in ((mm, mi), None):
            got = resblock.conv3x3_wgrad_fused(z, p, comp, m, inv, gm, gy, znorm=znorm)
            want = resblock.conv3x3_wgrad_fused_plain(z, p, comp, m, inv, gm, gy, znorm=znorm)
            assert float((got - want).abs().max() / want.abs().max()) <= 1e-3
    assert LAUNCHES["conv3x3_dgrad_fused"] == before["conv3x3_dgrad_fused"] + 4
    assert LAUNCHES["conv3x3_wgrad_fused"] == before["conv3x3_wgrad_fused"] + 2 * wgrad


@pytest.mark.cuda
def test_block_kernel_backward_matches_xla_backward_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = _bf16(g, 2, 16, 24, 128)
    k1, k2 = _bf16(g, 3, 3, 128, 128, scale=0.05), _bf16(g, 3, 3, 128, 128, scale=0.05)
    cot = _bf16(g, 2, 16, 24, 128)
    grads = {}
    for bwd in ("fused_wg", "xla"):
        leaves = [t.clone().requires_grad_() for t in (x, k1, k2)]
        out = resblock.resnet_block_pallas(*leaves, bwd=bwd)
        grads[bwd] = torch.autograd.grad(out, leaves, cot)
    for a, b in zip(grads["fused_wg"], grads["xla"]):
        assert float((a.float() - b.float()).norm() / b.float().norm()) <= 1e-2


@pytest.mark.cuda
def test_backward_wrappers_raise_on_unsupported_cuda_input(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    p, comp, aux, z, k, m, inv, gm, gy, mm, mi = _bwd_inputs(g, 1, 8, 16, 128)
    with pytest.raises(TypeError):  # float32 cotangent: the kernels are bf16-only
        resblock.conv3x3_dgrad_fused(p.float(), comp, aux, k, m, inv, gm, gy)
    with pytest.raises(ValueError):  # non-contiguous input
        pt = p.transpose(1, 2).contiguous().transpose(1, 2)
        resblock.conv3x3_dgrad_fused(pt, comp, aux, k, m, inv, gm, gy)
    with pytest.raises(ValueError):  # output channels not a multiple of 64
        resblock.conv3x3_dgrad_fused(p, comp, aux[..., :32].contiguous(), k[:, :, :32].contiguous(),
                                     m, inv, gm, gy)
    with pytest.raises(ValueError, match="C % 64"):  # p channels not a multiple of 64
        c32 = [t[..., :32].contiguous() for t in (p, comp, k, m, inv, gm, gy)]
        resblock.conv3x3_dgrad_fused(c32[0], c32[1], aux, c32[2], *c32[3:])
    with pytest.raises(TypeError):
        resblock.conv3x3_wgrad_fused(z.float(), p, comp, m, inv, gm, gy)
    with pytest.raises(ValueError):  # Cz not a multiple of 64
        resblock.conv3x3_wgrad_fused(z[..., :32].contiguous(), p, comp, m, inv, gm, gy)
    with pytest.raises(ValueError):
        resblock.conv3x3_wgrad_fused(z.transpose(1, 2).contiguous().transpose(1, 2),
                                     p, comp, m, inv, gm, gy)
    with pytest.raises(ValueError):  # Co not a multiple of 128
        resblock.conv3x3_wgrad_fused(z, p[..., :64].contiguous(), comp[..., :64].contiguous(),
                                     m[:, :64].contiguous(), inv[:, :64].contiguous(),
                                     gm[:, :64].contiguous(), gy[:, :64].contiguous())


_WGRAD_FORMS = (  # (pad, mask_p, znorm)
    ("reflect", False, False), ("reflect", False, True), ("zero", False, False),
    ("zero", True, False),
)


@pytest.mark.cuda
@pytest.mark.parametrize("cz", [64, 128, 256])
@pytest.mark.parametrize("co", [128, 256])
@pytest.mark.parametrize("hw", [(8, 64), (13, 21)])  # whole and partial 2×32 chunks
def test_wgrad_kernel_matches_plain_on_card(cuda, cz, co, hw):
    """``csrc/wgrad.cu`` in all four forms: the transform pass equals its
    plain version bit for bit; the GEMM's slot partials and their sum
    are within 1e-3 of max|dk| of the plain contraction (f32 sums in
    another order); a repeat is bit-exact."""
    g = torch.Generator(device=cuda).manual_seed(18)
    b = 2
    z, p, comp = _bf16(g, b, *hw, cz), _bf16(g, b, *hw, co), _bf16(g, b, *hw, co)
    m, inv = instance_norm_stats(comp)
    zm, zi = instance_norm_stats(z)
    gm, gy = (torch.randn(b, co, device=cuda, generator=g) * 0.01 for _ in range(2))
    plan = resblock._wgrad_plan(b, *hw, cz, co)
    for pad, mask_p, znorm in _WGRAD_FORMS:
        zn = (zm, zi) if znorm else None
        args, kw = (z, p, comp, m, inv, gm, gy, zn), dict(pad=pad, mask_p=mask_p)
        zsrc, dy = resblock._wgrad_transform(*args, **kw)
        zsrc_p, dy_p = resblock._wgrad_transform_plain(*args, **kw)
        assert torch.equal(zsrc, zsrc_p) and torch.equal(dy, dy_p), (pad, mask_p, znorm)
        ws = resblock._wgrad_gemm(zsrc, dy, plan, pad=pad)
        ws_p = resblock._wgrad_gemm_plain(zsrc_p, dy_p, plan, pad=pad)
        assert float((ws - ws_p).abs().max() / ws_p.abs().max()) <= 1e-3, (pad, mask_p, znorm)
        name = "conv3x3_wgrad_fused" + ("_seg" if pad == "zero" else "")
        before = LAUNCHES[name]
        got = resblock.conv3x3_wgrad_fused(*args, **kw)
        assert LAUNCHES[name] == before + 1
        want = resblock.conv3x3_wgrad_fused_plain(*args, **kw)
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-3, (pad, mask_p, znorm)
        assert torch.equal(got, resblock.conv3x3_wgrad_fused(*args, **kw))  # fixed-order sums


# --- the int8 conv and the int8 head (kernel 4q) -----------------------------


def _int8(gen, *shape):
    return torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", ["zero", "reflect"])
@pytest.mark.parametrize("b,hw", [(1, (16, 32)), (2, (13, 21))])  # full and partial 8×32 tiles
def test_conv_int8_matches_plain_bit_for_bit_on_card(cuda, pad, b, hw):
    """Every Cin and Cout of the serving path at ngf 64, 32 and 16, and
    channel counts that fill no 64-channel chunk (Cin 16, 32, 48, 96: A's
    box runs past them into TMA's zero fill; Cout 16, 32, 48: masked); the four
    epilogue forms (f32 legs, + addend + bias in bf16, + bias in bf16). The
    same IEEE steps on exact integer sums: the outputs are equal, and a
    repeat is bit-exact."""
    from ircolor_tpu_torch.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(5)
    for cin in (16, 32, 48, 64, 96, 128, 256):
        for cout in (16, 32, 48, 64, 128, 256):
            xq, wq = _int8(g, b, *hw, cin), _int8(g, 3, 3, cin, cout)
            sc = torch.rand(b, cout, device=cuda, generator=g) * 1e-4
            bias = torch.randn(cout, device=cuda, generator=g)
            addend = torch.randn(b, *hw, cout, device=cuda, generator=g)
            for kw in (dict(out_dtype=torch.float32), dict(bias=bias, addend=addend),
                       dict(bias=bias)):
                before = LAUNCHES["conv3x3_int8"]
                got = conv_int8.conv3x3_int8(xq, wq, sc, pad=pad, **kw)
                assert LAUNCHES["conv3x3_int8"] == before + 1
                want = conv_int8.conv3x3_int8_plain(xq, wq, sc, pad=pad, **kw)
                assert got.dtype == want.dtype and torch.equal(got, want), (cin, cout, kw.keys())
                again = conv_int8.conv3x3_int8(xq, wq, sc, pad=pad, **kw)
                assert torch.equal(got, again), (cin, cout, kw.keys())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout", [
    (1, 512, 640, 64, 128),   # no_antialias down1 at b1, ngf 64
    (1, 256, 320, 128, 256),  # down2
    (1, 512, 640, 32, 64),    # the same at ngf 32
    (1, 256, 320, 64, 128),
    (2, 19, 75, 16, 48),      # odd planes, partial tiles, channels that fill no chunk
    (2, 14, 40, 96, 32),
])
def test_conv_int8_stride2_matches_plain_bit_for_bit_on_card(cuda, b, h, w, cin, cout):
    """The stride-2 form (the GEMM reading the input through strided TMA
    boxes, three stages a chunk, its bf16 tile stored by TMA) against
    ``conv3x3_int8_plain(stride=2)``: zero halos at every site shape,
    reflect and VALID at the small ones, where f32 output with an addend
    (stored from the fragments) also holds; the zero and VALID pads launch
    the GEMM alone (no pass), the reflect pad the int8 reflect pass and the
    GEMM (``torch.profiler``'s kernel names); one launch counted a call (as
    ``conv3x3_int8_s2``); a repeat bit-exact."""
    from torch.profiler import ProfilerActivity, profile

    from ircolor_tpu_torch.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(b * h + cin)
    xq, wq = _int8(g, b, h, w, cin), _int8(g, 3, 3, cin, cout)
    sc = torch.rand(b, cout, device=cuda, generator=g) * 1e-4
    bias = torch.randn(cout, device=cuda, generator=g)
    pads = ("zero",) if h >= 256 else ("zero", "reflect", "valid")
    for pad in pads:
        ho, wo = conv_int8.out_hw(h, w, pad, 2)
        before = dict(LAUNCHES)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = conv_int8.conv3x3_int8(xq, wq, sc, pad=pad, stride=2, bias=bias)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        gemms = [n for n in names if "conv_fwd_gemm_kernel" in n]
        passes = [n for n in names if "operand_pass_kernel" in n]
        assert len(gemms) == 1 and len(passes) == int(pad == "reflect"), (pad, names)
        assert LAUNCHES["conv3x3_int8_s2"] == before["conv3x3_int8_s2"] + 1
        assert LAUNCHES["conv3x3_int8"] == before["conv3x3_int8"]
        want = conv_int8.conv3x3_int8_plain(xq, wq, sc, pad=pad, stride=2, bias=bias)
        assert got.shape == (b, ho, wo, cout) and torch.equal(got, want), pad
        assert torch.equal(conv_int8.conv3x3_int8(xq, wq, sc, pad=pad, stride=2, bias=bias), got)
        if h < 256:
            kw = dict(out_dtype=torch.float32, bias=bias,
                      addend=torch.randn(b, ho, wo, cout, device=cuda, generator=g))
            got = conv_int8.conv3x3_int8(xq, wq, sc, pad=pad, stride=2, **kw)
            want = conv_int8.conv3x3_int8_plain(xq, wq, sc, pad=pad, stride=2, **kw)
            assert got.dtype == torch.float32 and torch.equal(got, want), pad


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(16, 16), (64, 128), (256, 256)])
def test_conv_int8_valid_matches_plain_bit_for_bit_on_card(cuda, cin, cout):
    """VALID at stride 1 (a replicate-padded block input: the GEMM on the
    input as it comes, no pass), f32 and bf16 outputs, partial tiles."""
    from ircolor_tpu_torch.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(cin + cout)
    xq, wq = _int8(g, 2, 15, 43, cin), _int8(g, 3, 3, cin, cout)
    sc = torch.rand(2, cout, device=cuda, generator=g) * 1e-4
    for kw in (dict(out_dtype=torch.float32), dict(bias=torch.randn(cout, device=cuda, generator=g))):
        got = conv_int8.conv3x3_int8(xq, wq, sc, pad="valid", **kw)
        want = conv_int8.conv3x3_int8_plain(xq, wq, sc, pad="valid", **kw)
        assert got.shape == (2, 13, 41, cout) and torch.equal(got, want)


@pytest.mark.cuda
def test_int8_route_ngf32_b1_runs_on_card(cuda):
    """The ngf-32 generator's batch-1 int8 route (up2's Cout is 32, which
    the card's int8 conv once refused) runs through the int8 conv on the
    card, 10 launches for 2 blocks, and matches the same route on the CPU
    within the int8 serving budget: |ΔPSNR| ≤ 0.02 dB and |ΔSSIM| ≤ 0.002
    against a smooth target, a mean uint8 difference of at most 2 levels."""
    from ircolor_tpu_torch.eval.metrics import batched_metrics, quantize_to_uint8_01
    from ircolor_tpu_torch.models.generator import ResnetUNetGenerator

    flags = dict(ngf=32, n_blocks=2, dtype=torch.bfloat16, quant_int8=True, pallas_block=True,
                 pallas_norm_blur=True, pallas_norm_blur_min_area=18000,
                 pallas_norm_blur_min_launch=600000, pallas_head=True,
                 pallas_head_min_area=100000, pallas_head_min_launch=600000)
    gen = ResnetUNetGenerator(**flags)
    gen.init_weights("normal", 0.02, torch.Generator().manual_seed(0))
    gen.eval()
    x = torch.rand((1, 64, 80, 1), generator=torch.Generator().manual_seed(1)) * 2 - 1
    target = torch.nn.functional.interpolate(
        torch.rand((1, 3, 8, 10), generator=torch.Generator().manual_seed(2)), size=(64, 80),
        mode="bilinear").permute(0, 2, 3, 1)
    with torch.inference_mode():
        assert gen._quant_convs(x)
        want = gen(x).float()
        gen.to(cuda)
        before = LAUNCHES["conv3x3_int8"]
        got = gen(x.to(cuda)).float().cpu()
        # down1, down2, 2 × 2 block convs, up1's and up2's two legs each
        assert LAUNCHES["conv3x3_int8"] == before + 10
    preds = [quantize_to_uint8_01((y + 1.0) / 2.0) for y in (got, want)]
    mg, mw = (batched_metrics(p, target) for p in preds)
    assert float((mg["psnr"] - mw["psnr"]).abs().max()) <= 0.02
    assert float((mg["ssim"] - mw["ssim"]).abs().max()) <= 0.002
    assert float((preds[0] - preds[1]).abs().mean()) * 255 <= 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 20, 70, 64), (1, 16, 128, 64),  # partial and whole strips
    (2, 20, 70, 16), (2, 20, 70, 32), (2, 20, 70, 48),  # channels that fill no K step
    (2, 20, 70, 8), (2, 16, 244, 24),  # C % 16 != 0: ngf 8 and 24 (the head gate admits them)
    (2, 16, 244, 32), (1, 4, 4, 64), (1, 150, 260, 96),  # whole strips; 64-channel units
])
def test_head_q_matches_plain_bit_for_bit_on_card(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(6)
    x = _bf16(g, *shape)
    k = _bf16(g, 7, 7, shape[-1], 3, scale=0.02)
    m, i = instance_norm_stats(x)
    before = LAUNCHES["conv7x7_head_q"]
    got = head.conv7x7_head_pallas(x, m, i, k, quant=True)
    assert LAUNCHES["conv7x7_head_q"] == before + 1
    assert torch.equal(got, head.conv7x7_head_q_plain(x, m, i, k))
    assert torch.equal(head.conv7x7_head_pallas(x, m, i, k, quant=True), got)


@pytest.mark.cuda
def test_tail_and_head_backward_through_kernels_on_card(cuda):
    """The backward of the fused tail and head (the JAX custom_vjp) behind
    a kernel forward, against the same backward behind the plain forward:
    the kernel's output carries no autograd graph, the Function's backward
    does not need one. bf16; the forwards differ by bf16 rounding only."""
    g = torch.Generator(device=cuda).manual_seed(7)
    xb, xh = _bf16(g, 2, 32, 48, 128), _bf16(g, 2, 20, 70, 64)
    k = _bf16(g, 7, 7, 64, 3, scale=0.02)
    gb, gh = _bf16(g, 2, 16, 24, 128), _bf16(g, 2, 20, 70, 3)
    grads = {}
    for route in ("kernel", "plain"):
        saved = blur.norm_relu_blur_down_pallas, head.conv7x7_head_pallas
        if route == "plain":
            blur.norm_relu_blur_down_pallas = blur.norm_relu_blur_down_plain
            head.conv7x7_head_pallas = head.conv7x7_head_plain
        try:
            before = dict(LAUNCHES)
            leaves = [t.clone().requires_grad_() for t in (xb, xh, k)]
            db = torch.autograd.grad(blur.norm_relu_blur_down(leaves[0]), leaves[0], gb)
            dh = torch.autograd.grad(head.outc_head(leaves[1], leaves[2]), leaves[1:], gh)
            ran = {n: LAUNCHES[n] - before[n] for n in ("norm_relu_blur_down", "conv7x7_head")}
            assert ran == ({"norm_relu_blur_down": 1, "conv7x7_head": 1} if route == "kernel"
                           else {"norm_relu_blur_down": 0, "conv7x7_head": 0})
        finally:
            blur.norm_relu_blur_down_pallas, head.conv7x7_head_pallas = saved
        grads[route] = (*db, *dh)
    for a, b in zip(grads["kernel"], grads["plain"]):
        assert float((a.float() - b.float()).norm() / b.float().norm()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout", [
    ((32, 128, 160, 256), 256),  # the flagship bottleneck
    ((3, 36, 40, 128), 128),     # partial 8×32 tiles both ways
])
def test_int8_block_conv_forms_match_plain_on_card(cuda, shape, cout):
    """Row 1 (the int8 operand pass, then the s8 GEMM of csrc/conv_fwd.cu),
    conv1 and conv2: the pass and the output bit-identical to the plain
    versions (the same integer sums, one cvt, one multiply, one rounding),
    the IN moments within 1e-5 relative (sums in another order), a repeat
    bit-exact, one launch counted a call."""
    from ircolor_tpu_torch.ops.quant import _QCLIP, quantize_weight_per_channel

    g = torch.Generator(device=cuda).manual_seed(23)
    b, h, w, c = shape
    x = _bf16(g, *shape, scale=2.0)
    kq, sw = quantize_weight_per_channel(_bf16(g, 3, 3, c, cout, scale=0.05))
    amax = x.float().abs().amax(dim=(1, 2, 3))
    m, i = instance_norm_stats(x)
    forms = (
        (((amax / 127.0)[:, None] * sw[None, :]).contiguous(), dict(qscale=(127.0 / amax).contiguous())),
        (((_QCLIP / 127.0) * sw[None, :]).expand(b, -1).contiguous(), dict(mean=m, inv=i)),
    )
    for sc, kw in forms:
        assert torch.equal(resblock._q_pass(x, **kw), resblock._q_pass_plain(x, **kw))
        before = LAUNCHES["conv3x3_reflect_fused_q"]
        got = resblock.conv3x3_reflect_fused_q(x, kq, sc, **kw)
        assert LAUNCHES["conv3x3_reflect_fused_q"] == before + 1
        want = resblock.conv3x3_reflect_fused_q_plain(x, kq, sc, **kw)
        assert torch.equal(got[0], want[0]), list(kw)
        assert float((got[1] - want[1]).abs().max() / want[1].abs().max()) <= 1e-5
        assert float(((got[2] - want[2]) / want[2]).abs().max()) <= 1e-5
        again = resblock.conv3x3_reflect_fused_q(x, kq, sc, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_int8_block_conv_raises_on_unsupported_cuda_input(cuda):
    g = torch.Generator(device=cuda).manual_seed(24)
    x = _bf16(g, 1, 8, 32, 128)
    kq, sc, qs = _int8(g, 3, 3, 128, 128), torch.ones(1, 128, device=cuda), torch.ones(1, device=cuda)
    with pytest.raises(TypeError):  # float32 activations
        resblock.conv3x3_reflect_fused_q(x.float(), kq, sc, qscale=qs)
    with pytest.raises(TypeError):  # weights not int8
        resblock.conv3x3_reflect_fused_q(x, kq.float(), sc, qscale=qs)
    with pytest.raises(ValueError, match="C % 64"):
        resblock.conv3x3_reflect_fused_q(x[..., :96].contiguous(), kq[:, :, :96], sc, qscale=qs)
    with pytest.raises(ValueError):  # Cout not a multiple of 128
        resblock.conv3x3_reflect_fused_q(x, kq[..., :64], sc[:, :64].contiguous(), qscale=qs)
    with pytest.raises(ValueError):  # non-contiguous input
        xt = _bf16(g, 1, 32, 8, 128).transpose(1, 2)
        resblock.conv3x3_reflect_fused_q(xt, kq, sc, qscale=qs)
    mean = torch.zeros(1, 129, device=cuda)[:, 1:]  # contiguous, 4 bytes past a boundary
    with pytest.raises(ValueError, match="16-byte"):
        resblock.conv3x3_reflect_fused_q(x, kq, sc, mean=mean, inv=torch.ones(1, 128, device=cuda))


@pytest.mark.cuda
def test_int8_wrappers_raise_on_unsupported_cuda_input(cuda):
    from ircolor_tpu_torch.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(8)
    xq, wq = _int8(g, 1, 8, 16, 64), _int8(g, 3, 3, 64, 128)
    sc = torch.ones(1, 128, device=cuda)
    with pytest.raises(TypeError):  # bf16 activations: the kernel takes int8
        conv_int8.conv3x3_int8(xq.to(torch.bfloat16), wq, sc)
    with pytest.raises(ValueError, match="Cin % 16"):  # Cin not a multiple of 16
        conv_int8.conv3x3_int8(xq[..., :40].contiguous(), wq[:, :, :40], sc)
    with pytest.raises(ValueError, match="Cout % 16"):  # Cout not a multiple of 16
        conv_int8.conv3x3_int8(xq, wq[..., :72], sc[:, :72].contiguous())
    with pytest.raises(ValueError):  # non-contiguous input
        conv_int8.conv3x3_int8(xq.transpose(1, 2).contiguous().transpose(1, 2), wq, sc)
    with pytest.raises(ValueError, match="16-byte"):  # contiguous, 1 byte past a boundary
        conv_int8.conv3x3_int8(_int8(g, 1 * 8 * 16 * 64 + 1)[1:].view(1, 8, 16, 64), wq, sc)
    with pytest.raises(TypeError):
        conv_int8.conv3x3_int8(xq, wq, sc, out_dtype=torch.float16)
    x = _bf16(g, 1, 16, 32, 64)
    m, i = instance_norm_stats(x)
    with pytest.raises(ValueError, match="C % 8"):  # C % 8 != 0 for the int8 head
        xs = x[..., :52].contiguous()
        head.conv7x7_head_pallas(xs, m[:, :52].contiguous(), i[:, :52].contiguous(),
                                 _bf16(g, 7, 7, 52, 3), quant=True)
    with pytest.raises(TypeError):
        head.conv7x7_head_pallas(x.float(), m, i, _bf16(g, 7, 7, 64, 3), quant=True)
    with pytest.raises(ValueError, match="16-byte"):  # contiguous, 2 bytes past a boundary
        xm = _bf16(g, 1 * 16 * 32 * 64 + 1)[1:].view(1, 16, 32, 64)
        head.conv7x7_head_pallas(xm, m, i, _bf16(g, 7, 7, 64, 3), quant=True)


# --- kernel 11 (fused instance norm) and the enc/dec segment modes -----------


def _in_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """bf16: within one bf16 ulp of the plain value (at least 1e-6, where
    x ≈ mean leaves f32 rounding noise around 0); f32: 1e-5 relative to
    max(|value|, 1). Both take the same steps; the sums run in another
    order."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if got.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0**-126))) - 7).clamp(min=1e-6)
        return bool((d <= ulp).all())
    return bool((d <= 1e-5 * w.abs().clamp(min=1.0)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (16, 64, 64, 256),  # the 256² bottleneck: the plane staged in shared memory
    (2, 13, 7, 40),     # a plane that fills no sweep of the block; C ≠ 16k (last slice short)
    (1, 128, 128, 24),  # a plane over shared memory: read again from device memory
    (2, 9, 11, 12),     # C not a multiple of 8: one element a unit
])
def test_instance_norm_matches_plain_on_card(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(9)
    x = (torch.randn(*shape, device=cuda, generator=g) * 3 + 1).to(dtype)
    r = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    assert tin.pallas_fits(shape, dtype)
    before = dict(LAUNCHES)
    for relu in (False, True):
        got = tin.run_in(x, relu)
        assert _in_close(got, tin.fused_instance_norm_plain(x, relu)), relu
        assert torch.equal(got, tin.run_in(x, relu))  # fixed-order sums: bit-exact repeat
    launched = {"fused_instance_norm": 4}
    if tin.pallas_fits(shape, dtype, True):  # all but the f32 bottleneck
        got = tin.run_in_res(x, r)
        assert _in_close(got, tin.fused_instance_norm_residual_plain(x, r))
        launched["fused_instance_norm_residual"] = 1
    for name in ("fused_instance_norm", "fused_instance_norm_residual"):
        assert LAUNCHES[name] - before[name] == launched.get(name, 0), name


@pytest.mark.cuda
def test_instance_norm_backward_through_kernel_on_card(cuda):
    """The Functions' backward (plain torch from the saved input) behind the
    kernel forward equals the same backward behind the plain forward."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x, r, cot = (_bf16(g, 2, 16, 24, 128) for _ in range(3))
    outs = {}
    for route in ("kernel", "plain"):
        saved = tin.run_in, tin.run_in_res
        if route == "plain":
            tin.run_in, tin.run_in_res = tin.fused_instance_norm_plain, tin.fused_instance_norm_residual_plain
        try:
            leaves = [t.clone().requires_grad_() for t in (x, r)]
            y = tin.fused_instance_norm(leaves[0], True) + tin.fused_instance_norm_residual(*leaves)
            outs[route] = torch.autograd.grad(y, leaves, cot)
        finally:
            tin.run_in, tin.run_in_res = saved
    for a, b in zip(outs["kernel"], outs["plain"]):
        assert float((a.float() - b.float()).norm() / b.float().norm()) <= 1e-2


def _seg_inputs(g, b, h, w, c, cin):
    p, comp = _bf16(g, b, h, w, c), _bf16(g, b, h, w, c)
    z = _bf16(g, b, h, w, cin)
    k = _bf16(g, 3, 3, cin, c, scale=0.05)
    m, inv = instance_norm_stats(comp)
    f32 = lambda *s: torch.randn(*s, device="cuda", generator=g) * 0.01  # noqa: E731
    return p, comp, z, k, m, inv, f32(b, c), f32(b, c)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,c", [(64, 128), (128, 256), (384, 128)])  # down1, down2, up1
@pytest.mark.parametrize("hw", [(16, 32), (13, 21)])  # full and partial 8×32 tiles
def test_segment_kernels_match_plain_on_card(cuda, cin, c, hw):
    """The segment dgrad (zero halos, p masked on load, no aux, dy emitted)
    at the three dz widths, and the zero-pad wgrad with and without the
    mask, each against its plain version at the block rows' bounds."""
    g = torch.Generator(device=cuda).manual_seed(11)
    p, comp, z, k, m, inv, gm, gy = _seg_inputs(g, 2, *hw, c, cin)
    before = dict(LAUNCHES)
    kw = dict(pad="zero", mask_p=True)
    got = resblock.conv3x3_dgrad_fused(p, comp, None, k, m, inv, gm, gy, **kw)
    want = resblock.conv3x3_dgrad_fused_plain(p, comp, None, k, m, inv, gm, gy, **kw)
    scale = float(want[0].float().abs().max())
    assert float((got[0].float() - want[0].float()).abs().max()) <= 2 * 2.0**-8 * scale
    assert torch.equal(got[1], want[1])  # dy: the same roundings in the same order
    for mask_p in (False, True):
        got = resblock.conv3x3_wgrad_fused(z, p, comp, m, inv, gm, gy, pad="zero", mask_p=mask_p)
        want = resblock.conv3x3_wgrad_fused_plain(z, p, comp, m, inv, gm, gy, pad="zero",
                                                  mask_p=mask_p)
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-3, mask_p
    ran = {n: LAUNCHES[n] - before[n] for n in LAUNCHES}
    assert ran["conv3x3_dgrad_fused_seg"] == 1 and ran["conv3x3_wgrad_fused_seg"] == 2
    assert ran["conv3x3_dgrad_fused"] == ran["conv3x3_wgrad_fused"] == 0


@pytest.mark.cuda
def test_segment_backward_through_kernels_on_card(cuda):
    """``conv_in_relu_fused`` in both wgrad modes: the kernel backward
    against the same backward with the dgrad/wgrad on their plain versions,
    relative L2 ≤ 1e-2 (bf16 operands, f32 sums in another order). dz of
    384 (two legs), 128 and 64 (down1's leg: the GEMM's N = 64 form)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    legs = (_bf16(g, 2, 16, 32, 256), _bf16(g, 2, 16, 32, 128))
    k = _bf16(g, 3, 3, 384, 128, scale=0.05)
    cot = _bf16(g, 2, 16, 32, 128)
    leg64, k64 = _bf16(g, 2, 16, 32, 64), _bf16(g, 3, 3, 64, 128, scale=0.05)
    for mode, zs, kk in (("fused", legs, k), ("xla", legs[1:], k[:, :, 256:].contiguous()),
                         ("xla", (leg64,), k64)):
        grads = {}
        for route in ("kernel", "plain"):
            saved = encdec.conv3x3_dgrad_fused, encdec.conv3x3_wgrad_fused
            if route == "plain":
                encdec.conv3x3_dgrad_fused = resblock.conv3x3_dgrad_fused_plain
                encdec.conv3x3_wgrad_fused = resblock.conv3x3_wgrad_fused_plain
            try:
                leaves = [t.clone().requires_grad_() for t in (*zs, kk)]
                out = encdec.conv_in_relu_fused(mode, tuple(leaves[:-1]), leaves[-1])
                grads[route] = torch.autograd.grad(out, leaves, cot)
            finally:
                encdec.conv3x3_dgrad_fused, encdec.conv3x3_wgrad_fused = saved
        for a, b in zip(grads["kernel"], grads["plain"]):
            assert float((a.float() - b.float()).norm() / b.float().norm()) <= 1e-2, mode


@pytest.mark.cuda
def test_new_wrappers_raise_on_unsupported_cuda_input(cuda):
    g = torch.Generator(device=cuda).manual_seed(13)
    x = _bf16(g, 2, 16, 16, 128)
    with pytest.raises(TypeError):  # float16: the kernel takes bf16 or f32
        tin.run_in(x.half())
    with pytest.raises(TypeError):  # residual of another dtype
        tin.run_in_res(x, x.float())
    with pytest.raises(ValueError):  # residual of another shape
        tin.run_in_res(x, x[:1].contiguous())
    with pytest.raises(ValueError):  # non-contiguous input
        tin.run_in(x.transpose(1, 2))
    with pytest.raises(ValueError, match="gate"):  # a plane the gate refuses
        tin.run_in(_bf16(g, 1, 256, 320, 256))
    p, comp, z, k, m, inv, gm, gy = _seg_inputs(g, 1, 8, 16, 128, 64)
    with pytest.raises(ValueError, match="pad"):
        resblock.conv3x3_dgrad_fused(p, comp, None, k, m, inv, gm, gy, pad="same")
    with pytest.raises(ValueError):  # dz width not a multiple of 64
        resblock.conv3x3_dgrad_fused(p, comp, None, k[:, :, :32].contiguous(), m, inv, gm, gy,
                                     pad="zero", mask_p=True)
    with pytest.raises(TypeError):
        resblock.conv3x3_dgrad_fused(p.float(), comp, None, k, m, inv, gm, gy, pad="zero")
    with pytest.raises(ValueError, match="znorm"):
        resblock.conv3x3_wgrad_fused(z, p, comp, m, inv, gm, gy, znorm=(m[:, :64], inv[:, :64]),
                                     pad="zero")


def _close_bf16(got, want, ulps=2):
    """Within ``ulps`` bf16 ulps at the output's largest magnitude: both
    round the same f32 sums, taken in another order."""
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) <= ulps * 2.0**-8 * scale


def _stats_close(got, want):
    """IN (mean, inv) within 1e-3 relative (of the largest |mean|)."""
    merr = (got[1] - want[1]).abs().max() / want[1].abs().max().clamp(min=1e-6)
    ierr = ((got[2] - want[2]) / want[2]).abs().max()
    return float(merr) <= 1e-3 and float(ierr) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("legs,cout,pad", [
    ((128,), 256, "zero"),          # down2
    ((256, 128), 128, "zero"),      # up1, no concat
    ((256,), 256, "reflect"),
    ((64, 64), 128, "reflect"),     # 64-channel legs
    ((64,), 256, "zero"),
    ((256, 128), 256, "reflect"),
    ((128,), 128, "reflect"),
])
# Whole 8×32 tiles; partial rows and columns.
@pytest.mark.parametrize("hw,tile_h", [((16, 32), 16), ((12, 24), 4), ((13, 40), 1)])
def test_sum_fused_matches_plain_on_card(cuda, legs, cout, pad, hw, tile_h):
    g = torch.Generator(device=cuda).manual_seed(14)
    xs = [_bf16(g, 2, *hw, c) for c in legs]
    ks = [_bf16(g, 3, 3, c, cout, scale=0.05) for c in legs]
    before = LAUNCHES["conv3x3_sum_fused"]
    got = resblock.conv3x3_sum_fused(xs, ks, pad=pad, tile_h=tile_h)
    want = resblock.conv3x3_sum_fused_plain(xs, ks, pad=pad)
    assert LAUNCHES["conv3x3_sum_fused"] == before + 1
    assert _close_bf16(got[0], want[0]) and _stats_close(got, want)
    again = resblock.conv3x3_sum_fused(xs, ks, pad=pad, tile_h=tile_h)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # fixed-order sums


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 256])
@pytest.mark.parametrize("hw,tile_h", [((16, 32), 4), ((12, 24), 4), ((13, 21), 1)])
def test_valid_conv_and_block_kernels_match_plain_on_card(cuda, c, hw, tile_h):
    """VALID raw (no pass) and normalized (the no-pad pass), whole and
    partial 8×32 tiles; each bit-exact on repeat."""
    g = torch.Generator(device=cuda).manual_seed(15)
    x = _bf16(g, 2, *hw, c)
    k1, k2 = _bf16(g, 3, 3, c, 256, scale=0.05), _bf16(g, 3, 3, 256, 128, scale=0.05)
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    xp = xp.permute(0, 2, 3, 1).contiguous()
    before = dict(LAUNCHES)
    want = conv.conv3x3_valid_plain(xp, k1)
    forms = [lambda: conv.conv3x3_valid_pallas(xp, k1, tile_h=tile_h)]
    if hw[1] % 8 == 0:  # the v2 contract
        forms.append(lambda: conv.conv3x3_valid_pallas_v2(xp, k1, tile_h=tile_h, mode="preshift"))
    for form in forms:
        got = form()
        assert _close_bf16(got, want)
        assert torch.equal(got, form())  # bit-exact on repeat
    assert LAUNCHES["conv3x3_valid"] == before["conv3x3_valid"] + 2 * len(forms)
    got = block.conv3x3_stats(xp, k1, tile_h=tile_h)
    want = block.conv3x3_stats_plain(xp, k1)
    assert _close_bf16(got[0], want[0]) and _stats_close(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got, block.conv3x3_stats(xp, k1, tile_h=tile_h)))
    raw = torch.nn.functional.pad(want[0].permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    raw = raw.permute(0, 2, 3, 1).contiguous()
    got2 = block.conv3x3_norm_in_stats(raw, k2, want[1], want[2], tile_h=tile_h)
    want2 = block.conv3x3_stats_plain(raw, k2, want[1], want[2])
    assert _close_bf16(got2[0], want2[0]) and _stats_close(got2, want2)
    again = block.conv3x3_norm_in_stats(raw, k2, want[1], want[2], tile_h=tile_h)
    assert all(torch.equal(a, b) for a, b in zip(got2, again))
    assert LAUNCHES["conv3x3_stats"] == before["conv3x3_stats"] + 2
    assert LAUNCHES["conv3x3_norm_in_stats"] == before["conv3x3_norm_in_stats"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("c,cout", [(64, 128), (128, 256), (256, 256), (384, 128)])
@pytest.mark.parametrize("hw", [(8, 32), (13, 21)])  # a whole 8×32 tile, partial tiles
def test_reflect_conv_forms_match_plain_on_card(cuda, c, cout, hw):
    """Row 2 raw (the reflect pass) and normalized on load (the pass with
    the normalize), each bit-exact on repeat."""
    g = torch.Generator(device=cuda).manual_seed(19)
    x = _bf16(g, 2, *hw, c, scale=2.0)
    k = _bf16(g, 3, 3, c, cout, scale=0.05)
    m, i = instance_norm_stats(x)
    for args in ((), (m, i)):
        before = LAUNCHES["conv3x3_reflect_fused"]
        got = resblock.conv3x3_reflect_fused(x, k, *args)
        assert LAUNCHES["conv3x3_reflect_fused"] == before + 1
        want = resblock.conv3x3_reflect_fused_plain(x, k, *args)
        assert _close_bf16(got[0], want[0]) and _stats_close(got, want), len(args)
        again = resblock.conv3x3_reflect_fused(x, k, *args)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 48, 128), (1, 12, 20, 16)])
def test_blur_downsample_matches_plain_on_card(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(16)
    x = _bf16(g, *shape)
    before = LAUNCHES["blur_downsample"]
    got = blur.blur_downsample_pallas(x)
    assert LAUNCHES["blur_downsample"] == before + 1
    assert torch.equal(got, blur.blur_downsample_plain(x))  # same additions, same order
    from ircolor_tpu_torch.ops.blurpool import blur_downsample

    assert _close_bf16(got, blur_downsample(x), ulps=1)


@pytest.mark.cuda
def test_slice5_wrappers_raise_on_unsupported_cuda_input(cuda):
    g = torch.Generator(device=cuda).manual_seed(17)
    x, k = _bf16(g, 1, 16, 16, 128), _bf16(g, 3, 3, 128, 128, scale=0.05)
    xp = _bf16(g, 1, 18, 18, 128)  # pre-padded: H = W = 16
    with pytest.raises(TypeError):  # float32 on the card: the kernels are bf16
        resblock.conv3x3_sum_fused([x.float()], [k])
    with pytest.raises(TypeError):
        conv.conv3x3_valid_pallas(xp.float(), k)
    with pytest.raises(TypeError):
        block.conv3x3_stats(xp.float(), k)
    with pytest.raises(TypeError):
        blur.blur_downsample_pallas(x.float())
    with pytest.raises(ValueError, match="Cout % 128"):
        resblock.conv3x3_sum_fused([x], [k[..., :64].contiguous()])
    with pytest.raises(ValueError, match="at most 2"):
        resblock.conv3x3_sum_fused([x] * 3, [k] * 3)
    with pytest.raises(ValueError, match="C % 64"):
        resblock.conv3x3_sum_fused([x[..., :32].contiguous()], [k[:, :, :32].contiguous()])
    with pytest.raises(ValueError, match="C % 64"):  # one leg of two
        resblock.conv3x3_sum_fused([x, x[..., :96].contiguous()], [k, k[:, :, :96].contiguous()])
    with pytest.raises(ValueError, match="C % 64"):
        block.conv3x3_stats(xp[..., :32].contiguous(), k[:, :, :32].contiguous())
    with pytest.raises(ValueError, match="Cout % 128"):
        conv.conv3x3_valid_pallas(xp, k[..., :64].contiguous())
    with pytest.raises(ValueError, match="C % 8"):
        blur.blur_downsample_pallas(x[..., :4].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_halo_forms_match_plain_and_unsharded_rows_on_card(cuda, n):
    """Rows 1 and 2 in their spatial halo forms on n shards of one card:
    the operand passes bit-identical to their plain versions (separate and
    provided), the int8 conv bit-identical to its plain version, the bf16
    conv within 2 bf16 ulps of it; conv1's raw output on each shard
    bit-identical to the same rows of the unsharded kernel's (the same
    inputs and halo rows, and the GEMM's per-pixel K order does not depend
    on the tile), the summed statistics within 1e-5 relative of the
    unsharded kernel's; one ``*_halo`` launch counted a call."""
    from ircolor_tpu_torch.ops.quant import quantize_weight_per_channel
    from ircolor_tpu_torch.parallel.spatial import all_sum, exchange_halo_rows, shard_h

    g = torch.Generator(device=cuda).manual_seed(31)
    b, h, w, c = 2, 32, 40, 256
    x = _bf16(g, b, h, w, c)
    k = _bf16(g, 3, 3, c, c, scale=0.05)
    kq, sw = quantize_weight_per_channel(k)
    amax = x.float().abs().amax(dim=(1, 2, 3))
    sc = ((amax / 127.0)[:, None] * sw[None, :]).contiguous()
    qkw = dict(qscale=(127.0 / amax).contiguous())
    xs = shard_h(x, [cuda] * n)
    halos = exchange_halo_rows(xs, 1)
    one = resblock.conv3x3_reflect_fused(x, k)
    one_q = resblock.conv3x3_reflect_fused_q(x, kq, sc, **qkw)
    outs, outs_q, sums, sums_q = [], [], [], []
    for i, (xi, hr) in enumerate(zip(xs, halos)):
        slab = torch.cat([hr[0], xi, hr[1]], dim=1).contiguous()
        for form, kw in (("separate", dict(halo_rows=hr)), ("provided", {})):
            src = xi if form == "separate" else slab
            assert torch.equal(resblock._conv_pass(src, halo=form, **kw),
                               resblock._conv_pass_plain(src, halo=form, **kw))
            assert torch.equal(resblock._q_pass(src, halo=form, **qkw, **kw),
                               resblock._q_pass_plain(src, halo=form, **qkw, **kw))
        before = dict(LAUNCHES)
        got = resblock.conv3x3_reflect_fused(xi, k, halo="separate", halo_rows=hr, sums=True)
        got_q = resblock.conv3x3_reflect_fused_q(xi, kq, sc, halo="separate", halo_rows=hr,
                                                 sums=True, **qkw)
        assert LAUNCHES["conv3x3_reflect_fused_halo"] == before["conv3x3_reflect_fused_halo"] + 1
        assert LAUNCHES["conv3x3_reflect_fused_q_halo"] == \
            before["conv3x3_reflect_fused_q_halo"] + 1
        want = resblock.conv3x3_reflect_fused_plain(xi, k, halo="separate", halo_rows=hr)
        scale = float(want[0].float().abs().max())
        assert float((got[0].float() - want[0].float()).abs().max()) <= 2 * 2.0**-8 * scale
        want_q = resblock.conv3x3_reflect_fused_q_plain(xi, kq, sc, halo="separate",
                                                        halo_rows=hr, **qkw)
        assert torch.equal(got_q[0], want_q[0])
        rows = slice(i * (h // n), (i + 1) * (h // n))
        assert torch.equal(got[0], one[0][:, rows]) and torch.equal(got_q[0], one_q[0][:, rows])
        outs.append(got[0])
        sums.append(got[1])
        sums_q.append(got_q[1])
    for s, ref in ((all_sum(sums)[0], one), (all_sum(sums_q)[0], one_q)):
        m, inv = resblock._moments(s[:, 0], s[:, 1], h * w)
        assert float((m - ref[1]).abs().max() / ref[1].abs().max()) <= 1e-5
        assert float(((inv - ref[2]) / ref[2]).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,n", [(2, 32, 64, 2), (2, 52, 40, 4), (1, 24, 37, 4)])
def test_int8_halo_one_call_matches_the_two_launch_path_on_card(cuda, b, h, w, n):
    """Row 1h's one C call, which quantizes its input on the A load: at
    whole and partial tiles (13-row shards, W % 32 != 0; 6-row shards, odd
    W), conv1 and conv2, ``separate`` and ``provided`` (the slab read in
    place), output and in-order sums bit-identical to the operand pass and
    GEMM launched apart; conv1's and conv2's rows to the unsharded
    kernel's; shard 1 with its own first row as its top halo row differs
    from them; the reflect form of the one call bit-identical to row 1's
    two launches; a repeat bit-exact."""
    from ircolor_tpu_torch.ops.quant import _QCLIP, quantize_weight_per_channel
    from ircolor_tpu_torch.parallel.spatial import exchange_halo_rows, shard_h

    g = torch.Generator(device=cuda).manual_seed(37)
    c = 128
    x = _bf16(g, b, h, w, c, scale=2.0)
    kq, sw = quantize_weight_per_channel(_bf16(g, 3, 3, c, c, scale=0.05))
    amax = x.float().abs().amax(dim=(1, 2, 3))
    m, i = instance_norm_stats(x)
    forms = ((((amax / 127.0)[:, None] * sw[None, :]).contiguous(),
              dict(qscale=(127.0 / amax).contiguous())),
             (((_QCLIP / 127.0) * sw[None, :]).expand(b, -1).contiguous(), dict(mean=m, inv=i)))
    xs = shard_h(x, [cuda] * n)
    halos = exchange_halo_rows(xs, 1)
    hl = h // n
    for sc, kw in forms:
        one = resblock.conv3x3_reflect_fused_q(x, kq, sc, **kw)
        plan = resblock._conv_plan(b, h, w, (c,), c, "reflect", s8=True)
        fused = resblock._q_fused(x, resblock.q_pack(kq), sc, plan, **kw)
        assert torch.equal(fused[0], one[0])
        for k, (xi, hr) in enumerate(zip(xs, halos)):
            plan = resblock._conv_plan(b, hl, w, (c,), c, "reflect", s8=True)
            got = resblock.conv3x3_reflect_fused_q(xi, kq, sc, **kw, halo="separate",
                                                   halo_rows=hr, sums=True)
            slab = torch.cat([hr[0], xi, hr[1]], dim=1).contiguous()
            prov = resblock.conv3x3_reflect_fused_q(slab, kq, sc, **kw, halo="provided",
                                                    sums=True)
            out2, part2 = resblock._q_gemm(resblock._q_pass(xi, **kw, halo="separate",
                                                            halo_rows=hr),
                                           resblock._q_weights(kq, plan), sc, plan)
            assert torch.equal(got[0], out2) and torch.equal(got[0], prov[0])
            assert torch.equal(got[1], resblock._tile_sum_plain(part2))
            assert torch.equal(got[1], prov[1])
            assert torch.equal(got[0], one[0][:, k * hl : (k + 1) * hl])
            again = resblock.conv3x3_reflect_fused_q(xi, kq, sc, **kw, halo="separate",
                                                     halo_rows=hr, sums=True)
            assert all(torch.equal(p, q) for p, q in zip(got, again))
            if k == 1:
                bad = resblock.conv3x3_reflect_fused_q(
                    xi, kq, sc, **kw, halo="separate", halo_rows=(xi[:, :1].contiguous(), hr[1]))
                assert not torch.equal(bad[0], one[0][:, hl : 2 * hl])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_halo_form_at_n64_matches_n128_and_plain_on_card(cuda, n):
    """Row 2's halo form where the plan runs N = 64 (b4 shards of 64 / n
    rows; unsharded, N = 128): the GEMM at N = 64 bit-identical to N = 128
    on the same operands (output and per-tile sums); the one C call
    bit-identical to the pass and the GEMM launched apart, its sums to
    their tile partials added in order; within 2 bf16
    ulps of the plain version, provided = separate, and conv1's rows
    bit-identical to the unsharded (N = 128) kernel's."""
    from ircolor_tpu_torch.parallel.spatial import exchange_halo_rows, shard_h

    g = torch.Generator(device=cuda).manual_seed(41)
    b, h, w, c = 4, 64, 40, 256
    x = _bf16(g, b, h, w, c)
    k = _bf16(g, 3, 3, c, c, scale=0.05)
    m, i = instance_norm_stats(x)
    assert resblock._conv_plan(b, h, w, (c,), c, "reflect").bn == 128
    one = resblock.conv3x3_reflect_fused(x, k)
    xs = shard_h(x, [cuda] * n)
    for j, (xi, hr) in enumerate(zip(xs, exchange_halo_rows(xs, 1))):
        for kw in ({}, dict(mean=m, inv=i)):
            plan = resblock._conv_plan(b, h // n, w, (c,), c, "reflect", norm=bool(kw))
            assert plan.bn == 64
            zp = resblock._conv_pass(xi, **kw, halo="separate", halo_rows=hr)
            got = resblock._conv_gemm([zp], [k], plan, True)
            n128 = resblock._conv_gemm([zp], [k], resblock._conv_plan(
                b, h // n, w, (c,), c, "reflect", norm=bool(kw), bn=128), True)
            assert torch.equal(got[0], n128[0]) and torch.equal(got[1], n128[1])
            out, s = resblock.conv3x3_reflect_fused(xi, k, **kw, halo="separate", halo_rows=hr,
                                                    sums=True)
            assert torch.equal(out, got[0]) and torch.equal(s, resblock._tile_sum_plain(got[1]))
            slab = torch.cat([hr[0], xi, hr[1]], dim=1).contiguous()
            prov = resblock.conv3x3_reflect_fused(slab, k, **kw, halo="provided", sums=True)
            assert torch.equal(prov[0], out) and torch.equal(prov[1], s)
            want = resblock.conv3x3_reflect_fused_plain(xi, k, **kw, halo="separate",
                                                        halo_rows=hr)
            assert _close_bf16(out, want[0])
            if not kw:
                assert torch.equal(out, one[0][:, j * (h // n) : (j + 1) * (h // n)])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_spatial_blocks_match_unsharded_on_card(cuda, n):
    """``resnet_block_pallas(_q)_spatial`` on n shards of one card against
    the unsharded kernel blocks: the float block within 2 bf16 ulps of the
    output's largest magnitude (the statistics summed in another order move
    a normalize by an ulp here and there), the int8 block within the same
    and ≤ 1e-3 of its values differing; 2n halo-form launches a block."""
    from ircolor_tpu_torch.parallel.spatial import gather_h, shard_h

    g = torch.Generator(device=cuda).manual_seed(37)
    x = _bf16(g, 4, 64, 40, 256)
    k1, k2 = _bf16(g, 3, 3, 256, 256, scale=0.05), _bf16(g, 3, 3, 256, 256, scale=0.05)
    xs = shard_h(x, [cuda] * n)
    for spatial_blk, one_blk, name in (
            (resblock.resnet_block_pallas_spatial, resblock.resnet_block_pallas,
             "conv3x3_reflect_fused_halo"),
            (resblock.resnet_block_pallas_q_spatial, resblock.resnet_block_pallas_q,
             "conv3x3_reflect_fused_q_halo")):
        before = LAUNCHES[name]
        got = gather_h(spatial_blk(xs, k1, k2)).float()
        assert LAUNCHES[name] == before + 2 * n
        want = one_blk(x, k1, k2).float()
        d = (got - want).abs()
        assert float(d.max()) <= 2 * 2.0**-8 * float(want.abs().max()), name
        assert float((d > 2.0**-8 * want.abs()).float().mean()) <= 1e-3, name


@pytest.mark.cuda
def test_halo_forms_raise_on_unsupported_cuda_input(cuda):
    x = torch.zeros(1, 8, 32, 256, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(3, 3, 256, 256, dtype=torch.bfloat16, device=cuda)
    rows = (x[:, :1].contiguous(), x[:, -1:].contiguous())
    with pytest.raises(ValueError):  # halo rows of another width
        resblock.conv3x3_reflect_fused(x, k, halo="separate",
                                       halo_rows=(rows[0][:, :, :16], rows[1][:, :, :16]))
    with pytest.raises(TypeError):  # halo rows of another dtype
        resblock._conv_pass(x, halo="separate", halo_rows=tuple(r.float() for r in rows))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_spatial_generator_across_cards_matches_one_card(cuda, n, quant):
    """The spatial mesh's default placement, shard i on cuda:i (a node with
    n cards or more), against every shard on cuda:0, with the same weights
    and input (b2 at 512×640, ngf 64, 2 blocks: the fused blocks' per-shard
    gate holds): each kernel launches on its shard's own card and stream
    (``on_input_card``), so the outputs are bit-identical, the halo forms
    launch 2·n times a block, and the caller's current card is unchanged.
    A launcher called with another card current raises."""
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards for shards on distinct cards")
    from ircolor_tpu_torch.config import Config
    from ircolor_tpu_torch.eval.runner import spatial_generator
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel
    from ircolor_tpu_torch.parallel.spatial import gather_h, shard_h

    cfg = Config(img_height=512, img_width=640, compute_dtype="bf16", ngf=64, n_blocks=2,
                 test_batch_size=2, quant_int8=quant, sp_devices=n)
    model = IRColorizationModel(cfg, "cuda:0")
    x = torch.rand((2, 512, 640, 1), generator=torch.Generator().manual_seed(41)) * 2 - 1
    name = "conv3x3_reflect_fused_q_halo" if quant else "conv3x3_reflect_fused_halo"
    outs = []
    for dev in ("cuda:0", None):
        g = spatial_generator(cfg, model.module, dev)
        want = [torch.device("cuda", i if dev is None else 0) for i in range(n)]
        assert g.spatial_mesh == want
        before = LAUNCHES[name]
        with torch.inference_mode():
            ys = g(shard_h(x, g.spatial_mesh))
        assert [y.device for y in ys] == want
        assert LAUNCHES[name] == before + 2 * 2 * n
        assert torch.cuda.current_device() == 0
        outs.append(gather_h(ys).cpu())
    assert torch.equal(outs[0], outs[1])
    xs = torch.zeros(1, 8, 32, 256, dtype=torch.bfloat16, device="cuda:1")
    with torch.cuda.device(0), pytest.raises(RuntimeError, match="on_input_card"):
        resblock._conv_pass.__wrapped__(xs)
    assert resblock._conv_pass(xs).device == xs.device


@pytest.mark.cuda
def test_int8_export_artifact_launches_the_kernels_on_card(cuda, tmp_path):
    """A gate-open bf16 int8 ``keep_pallas`` artifact (64×64 b2, ngf 32,
    ``quant_head`` + ``quant_fixed_u2``: the int8 block convs, the down2
    tail, the int8 up2 conv's two legs and the int8 head), saved and
    loaded: bit-identical to the eager step, and one call launches what
    the eager forward launches."""
    from ircolor_tpu_torch.config import Config
    from ircolor_tpu_torch.eval.runner import make_infer_fn
    from ircolor_tpu_torch.export import aot
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    cfg = Config(img_size=64, ngf=32, n_blocks=1, compute_dtype="bf16", quant_int8=True,
                 quant_head=True, quant_fixed_u2=True)
    model = IRColorizationModel(cfg, cuda)
    path = str(tmp_path / "g.pt2")
    aot.save_exported(path, aot.export_inference(model.module, 64, 64, batch_size=2,
                                                 keep_pallas=True))
    served = aot.load_exported(path)
    g = torch.Generator(device=cuda).manual_seed(5)
    ir = torch.rand(2, 64, 64, 1, device=cuda, generator=g) * 2 - 1
    with torch.inference_mode():
        before = dict(LAUNCHES)
        want, _ = make_infer_fn(model.module)(ir, torch.zeros(2, 64, 64, 3, device=cuda))
        eager = {k: v - before[k] for k, v in LAUNCHES.items()}
        before = dict(LAUNCHES)
        got = served(ir)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in LAUNCHES.items()}
    assert launched == eager
    assert {k: v for k, v in launched.items() if v} == {
        "conv3x3_reflect_fused_q": 2, "norm_relu_blur_down": 1, "conv3x3_int8": 2,
        "conv7x7_head_q": 1}
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_data_parallel_test_mode_on_card(cuda, quant):
    """``make_infer_fn`` over a data mesh of two entries on one card (two
    chunks of 2, one replica) against the unsharded b4 step: each chunk
    launches what the unsharded step launches on those 2 images (the gates
    read the chunk's batch), and the outputs agree within the serving
    budget (|dPSNR| ≤ 0.02 dB, |dSSIM| ≤ 0.002, uint8 mean |d| ≤ 2)."""
    from ircolor_tpu_torch.config import Config
    from ircolor_tpu_torch.eval.runner import make_infer_fn
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel
    from ircolor_tpu_torch.parallel.mesh import make_data_mesh

    cfg = Config(img_size=64, ngf=32, n_blocks=1, compute_dtype="bf16", quant_int8=quant,
                 dp_devices=2)
    model = IRColorizationModel(cfg, cuda)
    one = make_infer_fn(model.module)
    dp = make_infer_fn(model.module, make_data_mesh(2, device="cuda:0"))
    g = torch.Generator(device=cuda).manual_seed(7)
    ir = torch.randint(0, 65536, (4, 64, 64, 1), device=cuda, generator=g).to(torch.uint16)
    gt = torch.randint(0, 256, (4, 64, 64, 3), device=cuda, generator=g).to(torch.uint8)
    before = dict(LAUNCHES)
    one(ir[:2], gt[:2])
    half = {k: v - before[k] for k, v in LAUNCHES.items()}
    before = dict(LAUNCHES)
    pred, m = dp(ir, gt)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in LAUNCHES.items()} == {k: 2 * v for k, v in half.items()}
    assert sum(half.values()) > 0
    want_pred, want_m = one(ir, gt)
    d = (pred.int() - want_pred.int()).abs().float()
    assert float(d.mean()) <= 2.0
    assert float((m["psnr"] - want_m["psnr"]).abs().max()) <= 0.02
    assert float((m["ssim"] - want_m["ssim"]).abs().max()) <= 0.002


@pytest.mark.cuda
def test_data_parallel_training_ranks_on_card(cuda):
    """Two ranks spawned on one card over gloo (global b4, 2 steps), bf16,
    under ``dp_mode="shard_map"`` and the default ``"gspmd"``: the
    parameters bit-identical across the ranks after each step, the block
    conv, dgrad and wgrad kernels launched on each rank (2 each a step: one
    block), the losses the same on both ranks and finite. Against one
    process at b4, step 1's conv weight gradients of G and D: in f32 (no
    kernel, no TF32: the reduction alone) within 1e-4 relative L2; in bf16,
    a net's worst leaf within the worst distance of the one-process bf16
    gradients of that net from the f32 ones. At this size bf16 itself is that coarse: on an H100 the
    one-process bf16 gradients lie 1.3e-1 to 1.75e-1 from the f32 ones at
    their worst leaf, and the two ranks' bf16 sums, taken in another
    order, 5e-2 to 1.0e-1 from the process's (3 seeds, these smooth frames
    and uniform noise), while in f32 the ranks read at most 1.6e-6 on these
    frames. A sum where the mean belongs reads 1 either way."""
    import math

    import numpy as np

    from ircolor_tpu_torch.config import Config
    from ircolor_tpu_torch.parallel.launch import spawn
    from ircolor_tpu_torch.tools.dp_steps import one_process_steps, run_rank_each
    from ircolor_tpu_torch.tools.flagship import synthetic_batches

    cfg = Config(img_size=64, ngf=32, n_blocks=1, compute_dtype="bf16", batch_size=4,
                 lambda_perc=0.0, dp_devices=2, dp_mode="shard_map", seed=3)
    f32 = cfg.replace(compute_dtype="f32")
    batches = [{"ir": ir, "rgb": gt} for ir, gt in synthetic_batches(2, 4, (64, 64))]
    cases = [(cfg, batches), (cfg.replace(dp_mode=Config().dp_mode), batches), (f32, batches[:1])]
    per_rank = spawn(run_rank_each, [torch.device("cuda", 0)] * 2, (cases,), timeout_s=300)
    for outs in per_rank:
        for out in outs[:2]:
            assert out["equal"] == [True, True]
            assert {k: v for k, v in out["launches"].items() if v} == {
                "conv3x3_reflect_fused": 4, "conv3x3_dgrad_fused": 4, "conv3x3_wgrad_fused": 4}
        assert outs[2]["equal"] == [True]
    for i in range(3):
        assert per_rank[0][i]["losses"] == per_rank[1][i]["losses"]
        assert all(math.isfinite(v) for step in per_rank[0][i]["losses"] for v in step.values())

    one = {c.compute_dtype: one_process_steps(c.replace(dp_devices=1), cuda, batches[:1])
           for c in (cfg, f32)}

    def rel(a, b, key):
        want = b["first"]["grads"][key]
        return float(np.linalg.norm(a["first"]["grads"][key] - want) / np.linalg.norm(want))

    keys = [k for k, v in one["f32"]["first"]["grads"].items()
            if k.endswith(".weight") and v is not None and np.linalg.norm(v) > 0]
    assert any(k.startswith("g.") for k in keys) and any(k.startswith("d.") for k in keys)
    for key in keys:
        assert rel(per_rank[0][2], one["f32"], key) <= 1e-4, key
    for net in ("g.", "d."):
        got = max(rel(per_rank[0][0], one["bf16"], k) for k in keys if k.startswith(net))
        floor = max(rel(one["bf16"], one["f32"], k) for k in keys if k.startswith(net))
        assert got <= floor, (net, got, floor)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_data_parallel_test_mode_on_two_cards(cuda, quant):
    """``make_infer_fn`` over the first two cards (a replica on each, the
    second chunk copied there and its output back) against the unsharded
    b4 step on cuda:0, within the serving budget. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from ircolor_tpu_torch.config import Config
    from ircolor_tpu_torch.eval.runner import make_infer_fn
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel
    from ircolor_tpu_torch.parallel.mesh import make_data_mesh

    cfg = Config(img_size=64, ngf=32, n_blocks=1, compute_dtype="bf16", quant_int8=quant,
                 dp_devices=2)
    model = IRColorizationModel(cfg, "cuda:0")
    mesh = make_data_mesh(2)
    assert mesh == [torch.device("cuda", 0), torch.device("cuda", 1)]
    g = torch.Generator(device="cuda:0").manual_seed(7)
    ir = torch.randint(0, 65536, (4, 64, 64, 1), device="cuda:0", generator=g).to(torch.uint16)
    gt = torch.randint(0, 256, (4, 64, 64, 3), device="cuda:0", generator=g).to(torch.uint8)
    pred, m = make_infer_fn(model.module, mesh)(ir, gt)
    want_pred, want_m = make_infer_fn(model.module)(ir, gt)
    assert pred.device == want_pred.device and pred.shape == want_pred.shape
    d = (pred.int() - want_pred.int()).abs().float()
    assert float(d.mean()) <= 2.0
    assert float((m["psnr"] - want_m["psnr"]).abs().max()) <= 0.02
    assert float((m["ssim"] - want_m["ssim"]).abs().max()) <= 0.002
