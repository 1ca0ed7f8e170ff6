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
