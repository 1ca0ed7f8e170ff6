"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (the kernels have
no CPU mode). The file imports torch and the port only, so it also runs on
a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import pytest
import torch

from ircolor_tpu_torch.kernels import LAUNCHES, blur, head, resblock
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
@pytest.mark.parametrize("hw", [(16, 40), (13, 21)])  # full and partial 8×16 tiles
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


def _bwd_inputs(g, b, h, w, c):
    f32 = lambda *s, scale=1.0: torch.randn(*s, device="cuda", generator=g) * scale  # noqa: E731
    p, comp, aux, z = (_bf16(g, b, h, w, c) for _ in range(4))
    k = _bf16(g, 3, 3, c, c, scale=0.05)
    m, inv = instance_norm_stats(comp)
    mm, mi = instance_norm_stats(aux)
    return p, comp, aux, z, k, m, inv, f32(b, c, scale=0.01), f32(b, c, scale=0.01), mm, mi


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 16, 256), (2, 13, 21, 128), (1, 4, 4, 128)])
def test_backward_kernels_match_plain_on_card(cuda, shape):
    """Full tiles, partial tiles (H, W not multiples of 8×16) and a 4×4
    plane whose one tile holds rows 1 and H−2 and every fold corner."""
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
    for znorm in ((mm, mi), None):
        got = resblock.conv3x3_wgrad_fused(z, p, comp, m, inv, gm, gy, znorm=znorm)
        want = resblock.conv3x3_wgrad_fused_plain(z, p, comp, m, inv, gm, gy, znorm=znorm)
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-3
    assert LAUNCHES["conv3x3_dgrad_fused"] == before["conv3x3_dgrad_fused"] + 2
    assert LAUNCHES["conv3x3_wgrad_fused"] == before["conv3x3_wgrad_fused"] + 2


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
    with pytest.raises(ValueError):  # output channels not a multiple of 128
        resblock.conv3x3_dgrad_fused(p, comp, aux[..., :64].contiguous(), k[:, :, :64].contiguous(),
                                     m, inv, gm, gy)
    with pytest.raises(TypeError):
        resblock.conv3x3_wgrad_fused(z.float(), p, comp, m, inv, gm, gy)
    with pytest.raises(ValueError):  # Cz not a multiple of 64
        resblock.conv3x3_wgrad_fused(z[..., :32].contiguous(), p, comp, m, inv, gm, gy)
    with pytest.raises(ValueError):
        resblock.conv3x3_wgrad_fused(z.transpose(1, 2).contiguous().transpose(1, 2),
                                     p, comp, m, inv, gm, gy)


# --- the int8 conv and the int8 head (kernel 4q) -----------------------------


def _int8(gen, *shape):
    return torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", ["zero", "reflect"])
@pytest.mark.parametrize("b,hw", [(1, (16, 32)), (2, (13, 21))])  # full and partial 8×16 tiles
def test_conv_int8_matches_plain_bit_for_bit_on_card(cuda, pad, b, hw):
    """Every Cin and Cout of the serving path; the four epilogue forms
    (f32 legs, + addend + bias in bf16, + bias in bf16). The same IEEE
    steps on exact integer sums: the outputs are equal."""
    from ircolor_tpu_torch.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(5)
    for cin in (64, 128, 256):
        for cout in (64, 128, 256):
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 20, 70, 64), (1, 16, 128, 64)])
def test_head_q_matches_plain_bit_for_bit_on_card(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(6)
    x = _bf16(g, *shape)
    k = _bf16(g, 7, 7, shape[-1], 3, scale=0.02)
    m, i = instance_norm_stats(x)
    before = LAUNCHES["conv7x7_head_q"]
    got = head.conv7x7_head_pallas(x, m, i, k, quant=True)
    assert LAUNCHES["conv7x7_head_q"] == before + 1
    assert torch.equal(got, head.conv7x7_head_q_plain(x, m, i, k))


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
def test_int8_wrappers_raise_on_unsupported_cuda_input(cuda):
    from ircolor_tpu_torch.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(8)
    xq, wq = _int8(g, 1, 8, 16, 64), _int8(g, 3, 3, 64, 128)
    sc = torch.ones(1, 128, device=cuda)
    with pytest.raises(TypeError):  # bf16 activations: the kernel takes int8
        conv_int8.conv3x3_int8(xq.to(torch.bfloat16), wq, sc)
    with pytest.raises(ValueError):  # Cin not a multiple of 32
        conv_int8.conv3x3_int8(xq[..., :48].contiguous(), wq[:, :, :48], sc)
    with pytest.raises(ValueError):  # Cout not a multiple of 64
        conv_int8.conv3x3_int8(xq, wq[..., :96], sc[:, :96].contiguous())
    with pytest.raises(ValueError):  # non-contiguous input
        conv_int8.conv3x3_int8(xq.transpose(1, 2).contiguous().transpose(1, 2), wq, sc)
    with pytest.raises(TypeError):
        conv_int8.conv3x3_int8(xq, wq, sc, out_dtype=torch.float16)
    x = _bf16(g, 1, 16, 32, 64)
    m, i = instance_norm_stats(x)
    with pytest.raises(ValueError):  # C % 16 != 0 for the int8 head
        xs = x[..., :56].contiguous()
        head.conv7x7_head_pallas(xs, m[:, :56].contiguous(), i[:, :56].contiguous(),
                                 _bf16(g, 7, 7, 56, 3), quant=True)
    with pytest.raises(TypeError):
        head.conv7x7_head_pallas(x.float(), m, i, _bf16(g, 7, 7, 64, 3), quant=True)
