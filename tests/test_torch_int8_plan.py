"""The int8 block conv's plan, operand pass, weight repack and GEMM, on the CPU.

On the card ``conv3x3_reflect_fused_q`` is one C call of
``csrc/conv_fwd.cu`` whose GEMM quantizes its input on the A load
(``tests/test_torch_q_halo_plan.py``); its reference there, and its path
before, is two launches: the operand pass in its int8 form (the
quantized, reflect-padded input) and the forward conv's GEMM on s8 operands
with the q-stats epilogue, bit for bit the same. What surrounds those is
Python that these tests reach: the
plan (``_conv_plan(..., s8=True)``), the pass's plain version, the K-major
weight repack and the box the GEMM reads from it, and the plain version of
the GEMM, which the bf16 conv shares: exact sums in the kernel's K order. The plain version
of the whole function, ``conv3x3_reflect_fused_q_plain``, is held against
JAX in ``test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ircolor_tpu_torch.kernels import resblock
from ircolor_tpu_torch.models.generator import ResnetBlock
from ircolor_tpu_torch.ops.norm import instance_norm_stats
from ircolor_tpu_torch.ops.quant import _QCLIP, quantize_weight_per_channel
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TH, TW, KC = resblock._CF_TH, resblock._CF_TW, resblock._CF_KC_S8


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(torch.bfloat16)


def _reflect_pad(q: torch.Tensor) -> torch.Tensor:
    """ReflectionPad(1) of NHWC ``q`` by ``F.pad`` (float64: exact for int8)."""
    p = F.pad(q.double().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return p.permute(0, 2, 3, 1)


# Values on the .5 ties of the conv1 grid (qscale 1: q = rint(x)) and past
# both clamps: rint takes ties to even, as torch.round and the kernel's
# __float2int_rn do.
_TIES = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5, 128.0, 300.0, -126.5, -127.5, -300.0, 0.0]
_TIES_Q = [0, 2, 2, 0, -2, -2, 126, 127, 127, 127, -126, -127, -127, 0]


@pytest.mark.parametrize("shape", [(2, 5, 7, 64), (1, 2, 2, 128), (2, 13, 21, 128)])
@pytest.mark.parametrize("form", ["conv1", "conv2"])
def test_q_pass_plain_is_quantize_then_reflect_pad(shape, form):
    """Bit for bit: the pass is ``_quantize_input`` as int8, then
    ReflectionPad(1); ties to even and both clamps included."""
    rng = np.random.default_rng(5)
    x = _bf16(rng, *shape, scale=40.0)
    flat = x.view(-1)
    flat[: len(_TIES)] = torch.tensor(_TIES, dtype=torch.bfloat16)
    if form == "conv1":  # image 0 on the grid of _TIES, the others their own scale
        kw = dict(qscale=torch.linspace(1.0, 0.5, shape[0]))
    else:
        mean, inv = instance_norm_stats(x)
        # Past the upper clamp: z·127/6 > 127 where z > 6.
        kw = dict(mean=mean, inv=inv * 4.0)
    got = resblock._q_pass(x, **kw)
    assert got.dtype == torch.int8 and got.shape == (shape[0], shape[1] + 2, shape[2] + 2, shape[3])
    want = _reflect_pad(resblock._quantize_input(x, kw.get("qscale"), kw.get("mean"), kw.get("inv")))
    assert torch.equal(got.double(), want)
    q = got[:, 1:-1, 1:-1].reshape(-1)
    if form == "conv1":
        assert q[: len(_TIES)].tolist() == _TIES_Q
    else:
        assert int(q.min()) == 0 and int(q.max()) == 127  # ReLU'd, and clamped at 127


@pytest.mark.parametrize("c,cout", [(64, 128), (128, 256), (256, 128)])
def test_weight_repack_puts_each_weight_once_where_the_box_reads_it(c, cout):
    """The K-major repack (3, 3, Cout, C) read through the GEMM's weight map
    (``_q_b_box``): every stage's box holds kq[dy, dx, ci0 + k, co0 + n] at
    (dy, n, k), and over the plan's stages and output-channel blocks every
    (dy, dx, ci, co) is read exactly once."""
    ids = torch.arange(9 * c * cout, dtype=torch.int64).reshape(3, 3, c, cout)
    plan = resblock._conv_plan(1, 16, 32, (c,), cout, "reflect", s8=True)
    kt = resblock._q_weights(ids, plan)
    assert kt.shape == (3, 3, cout, c) and kt.is_contiguous()
    assert plan.b_box == (KC, resblock._BN, 1, 3) and plan.bn == resblock._BN
    kflat = kt.reshape(-1)
    seen = torch.zeros(9 * c * cout, dtype=torch.int64)
    for chunk in range(plan.chunks[0]):
        for dx in range(3):
            for cob in range(plan.ncob):
                ci0, co0 = chunk * KC, cob * plan.bn
                box = resblock._q_b_box(kflat, c, cout, ci0, co0, dx, plan.bn)
                want = ids[:, dx, ci0 : ci0 + KC, co0 : co0 + plan.bn].transpose(1, 2)
                assert torch.equal(box, want)
                seen.index_add_(0, box.reshape(-1), torch.ones(box.numel(), dtype=torch.int64))
    assert bool((seen == 1).all())


def test_int8_plan_has_the_bf16_stage_bytes():
    """An int8 stage is 64 channels a 64-byte row: A's box has the bf16
    box's bytes (so its tap offsets are the bf16 ones), B's is 24 KB at N
    128, and the K loop runs C / 64 chunks."""
    bf = resblock._conv_plan(2, 13, 37, (256,), 256, "reflect", bn=128)  # the int8 plan's N
    q8 = resblock._conv_plan(2, 13, 37, (256,), 256, "reflect", s8=True)
    assert q8.a_box == (KC, TW, TH + 2, 1) and KC * 1 == bf.a_box[0] * 2  # bytes a pixel row
    assert q8.chunks == (256 // KC,) and bf.chunks == (256 // resblock._CF_KC,)
    assert np.prod(q8.b_box) == 3 * 128 * 64 == 24 * 1024
    assert np.prod(q8.a_box) == 20 * 1024
    assert (q8.ntiles, q8.ncob, q8.blocks, q8.grid, q8.pass_pad) == (
        bf.ntiles, bf.ncob, bf.blocks, bf.grid, bf.pass_pad)


def _forms(rng, x, kq, sw):
    """conv1's and conv2's (sc, kwargs), as ``resnet_block_pallas_q`` makes
    them."""
    b = x.shape[0]
    amax = x.float().abs().amax(dim=(1, 2, 3)).clamp(min=1e-12)
    sc1 = ((amax / 127.0)[:, None] * sw[None, :]).contiguous()
    mean, inv = instance_norm_stats(x)
    sc2 = ((_QCLIP / 127.0) * sw[None, :]).expand(b, -1).contiguous()
    return (("conv1", sc1, dict(qscale=127.0 / amax)), ("conv2", sc2, dict(mean=mean, inv=inv)))


@pytest.mark.parametrize("b,h,w,c,cout", [
    (2, 13, 37, 128, 128),   # H % 8 != 0 and W % 32 != 0: partial tiles both ways
    (1, 12, 40, 256, 256),   # two output-channel blocks, four K chunks
    (1, 9, 33, 64, 128),     # one K chunk
])
def test_gemm_emulation_matches_plain(b, h, w, c, cout):
    """The chained plain launches (pass → GEMM: exact sums in the kernel's
    K order over the K-major weights, cvt to f32, × sc) give the plain
    version's output bit for bit, and its IN moments (the per-tile sums,
    summed over tiles) within 1e-6 relative."""
    rng = np.random.default_rng(6)
    x = _bf16(rng, b, h, w, c, scale=2.0)
    kq, sw = quantize_weight_per_channel(_bf16(rng, 3, 3, c, cout, scale=0.05).float())
    plan = resblock._conv_plan(b, h, w, (c,), cout, "reflect", s8=True)
    assert plan.ntiles == -(-h // TH) * -(-w // TW)
    for form, sc, kw in _forms(rng, x, kq, sw):
        kt = resblock._q_weights(kq, plan)
        out, partial = resblock._q_gemm(resblock._q_pass(x, **kw), kt, sc, plan)
        assert partial.shape == (b, plan.ntiles, 2, cout)
        s = partial.sum(dim=1)
        mean, inv = resblock._moments(s[:, 0], s[:, 1], h * w)
        want, wm, wi = resblock.conv3x3_reflect_fused_q_plain(x, kq, sc, **kw)
        assert out.dtype == torch.bfloat16 and torch.equal(out, want), form
        assert float((mean - wm).abs().max() / wm.abs().max()) <= 1e-6, form
        assert float(((inv - wi) / wi).abs().max()) <= 1e-6, form


def test_every_int8_gate_shape_is_accepted():
    """Every plane the generator's int8 block gate admits (H by the tile
    heights, W % 8, C % 128, the int8 area floor and the b2–7 band) passes
    the wrapper's shape check, and its plan covers it: 64×64 planes and
    partial tiles (H % 8 != 0, W % 32 != 0) included."""
    block = ResnetBlock(128, dtype=torch.bfloat16, pallas_block=True, quant_int8=True).eval()
    admitted = set()
    for c in (128, 256, 384):
        block.dim = c
        for b in (1, 2, 7, 8, 32):
            for h in [*range(4, 136, 4), 256, 512]:
                for w in [*range(8, 176, 8), 320, 640]:
                    if not block.fused(torch.empty((b, h, w, c), device="meta")):
                        continue
                    resblock._check_q_shape(b, h, w, c, c)
                    plan = resblock._conv_plan(b, h, w, (c,), c, "reflect", s8=True)
                    assert plan.chunks == (c // KC,) and plan.ncob * plan.bn == c
                    assert plan.ntr * TH >= h and plan.ntc * TW >= w
                    admitted.add((b, h, w, c))
    assert (2, 64, 64, 128) in admitted and (32, 128, 160, 256) in admitted
    assert any(h % TH and w % TW for _, h, w, _ in admitted)
    with pytest.raises(ValueError, match="C % 64"):
        resblock._check_q_shape(1, 16, 16, 96, 128)
    with pytest.raises(ValueError, match="B <= 65535"):
        resblock._check_q_shape(65536, 16, 16, 128, 128)
