"""The bf16 forward conv's plan, operand pass and GEMM, on the CPU.

``csrc/conv_fwd.cu`` runs only on the card; what surrounds it is Python
that these tests reach: the tiling of ``_conv_plan`` and its pick of N (128
or 64 output channels a block), the operand pass's plain version, and a
plain version of the GEMM that runs the kernel's K loop (leg → 64-channel
chunk → dx buffer → dy) with its per-tile moments; ``_conv_fwd``, the one
C call that enqueues the pass and the GEMM, runs them on CPU tensors.
The plain versions of the public functions are held against JAX in
``test_torch_kernels.py``, ``test_torch_sum_fused.py``,
``test_torch_pallas_block.py`` and ``test_torch_pallas_conv.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ircolor_tpu_torch.kernels import block, resblock
from ircolor_tpu_torch.ops.norm import instance_norm_stats
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TH, TW = resblock._CF_TH, resblock._CF_TW


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(torch.bfloat16)


@pytest.mark.parametrize("halo", ["reflect", "zero", "valid"])
@pytest.mark.parametrize("b,h,w,legs,cout", [
    (2, 13, 21, (64,), 128),          # partial tiles both ways
    (1, 128, 160, (256,), 256),       # the flagship bottleneck
    (3, 9, 70, (256, 128), 128),      # two legs, a partial column tile
    (1, 256, 320, (128,), 256),       # down2
    (4, 32, 160, (256,), 256),        # a b4 halo shard at S = 4: N = 64
])
def test_plan_covers_every_pixel_and_channel_once(b, h, w, legs, cout, halo, monkeypatch):
    def no_card(*a, **k):
        raise AssertionError("the plan must not depend on the card")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(torch.cuda, "is_available", no_card)
    plan = resblock._conv_plan(b, h, w, legs, cout, halo)
    assert plan == resblock._conv_plan(b, h, w, legs, cout, halo)
    kc = resblock._CF_KC
    assert plan.shift == (halo == "zero") and plan.chunks == tuple(c // kc for c in legs)
    assert plan.pass_pad == (1 if halo == "reflect" else None)
    assert resblock._conv_plan(b, h, w, legs, cout, halo, norm=True).pass_pad == (
        0 if halo == "valid" else plan.pass_pad)
    cover = np.zeros((b, h, w, cout), dtype=np.int32)
    rows = np.zeros((b, plan.ntiles), dtype=np.int32)
    assert plan.grid == min(plan.blocks, resblock._CF_WAVE)
    for x, blk, bi, tile, r0, c0, co0 in resblock._conv_blocks(plan):
        assert 0 <= x < plan.grid and 0 <= blk < plan.blocks and r0 < h and c0 < w
        cover[bi, r0 : r0 + TH, c0 : c0 + TW, co0 : co0 + plan.bn] += 1
        rows[bi, tile] += 1
    assert (cover == 1).all()  # every pixel and output channel once
    # Each (image, tile) row of the partial is written by its ncob blocks,
    # every output channel once.
    assert (rows == plan.ncob).all() and plan.ncob * plan.bn == cout
    if (b, h) == (4, 32):
        assert plan.bn == 64
    assert plan.ntiles == -(-h // TH) * -(-w // TW)
    # The A box covers the tile and its halo, one 2·KC-byte row a pixel;
    # every tap's m64 starts on a swizzle atom (8 rows) and stays inside
    # the box.
    assert plan.a_box == (kc, TW, TH + 2, 1) and plan.b_box == (64, kc, 1, 3)
    row = 2 * kc
    for (wg, t, dy), off in resblock._conv_a_offsets().items():
        assert off % 1024 == 0 and off % (8 * row) == 0 and off + 64 * row <= TW * (TH + 2) * row
        assert off // row == (TH // resblock._CF_WG * wg + 2 * t + dy) * TW


@pytest.mark.parametrize("shape", [(2, 13, 21, 64), (1, 4, 40, 128), (2, 2, 2, 64)])
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("pad", [1, 0])
def test_pass_plain_is_normalize_then_reflect_pad(shape, norm, pad):
    """Bit for bit: the pass is ``_normalize_relu(...).to(bf16)`` (or x),
    then ReflectionPad(1) (``pad`` 1) or nothing (``pad`` 0)."""
    rng = np.random.default_rng(1)
    x = _bf16(rng, *shape, scale=3.0)
    mean, inv = instance_norm_stats(x) if norm else (None, None)
    got = resblock._conv_pass(x, mean, inv, pad=pad)
    z = resblock._normalize_relu(x, mean, inv).to(torch.bfloat16) if norm else x
    if pad:
        z = F.pad(z.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        z = z.permute(0, 2, 3, 1).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == z.shape
    assert torch.equal(got, z)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _via_plan(halo, legs, kernels, mean=None, inv=None, stats=True):
    """The wrapper's schedule on the plain parts: plan → pass → GEMM →
    the moments of the per-tile partials, summed in order."""
    b, hi, wi = legs[0].shape[:3]
    h, w = (hi - 2, wi - 2) if halo == "valid" else (hi, wi)
    plan = resblock._conv_plan(b, h, w, tuple(x.shape[-1] for x in legs), kernels[0].shape[-1],
                               halo, norm=mean is not None)
    srcs = legs
    if plan.pass_pad is not None:
        srcs = [resblock._conv_pass(x, mean, inv, pad=plan.pass_pad) for x in legs]
    out, partial = resblock._conv_gemm(srcs, kernels, plan, stats)
    if not stats:
        return out, None
    assert partial.shape == (b, plan.ntiles, 2, plan.cout)
    s = partial.sum(dim=1)
    return out, resblock._moments(s[:, 0], s[:, 1], h * w)


def _stats_rel(got, want):
    return max(_rel(got[0], want[0]), float(((got[1] - want[1]) / want[1]).abs().max()))


@pytest.mark.parametrize("legs,cout,pad", [
    ((64,), 128, "zero"),
    ((128, 64), 256, "zero"),     # two legs (up1's concat-free form)
    ((64, 64), 128, "reflect"),   # a reflect pass on each leg
])
@pytest.mark.parametrize("hw", [(8, 32), (13, 21)])  # a whole tile, partial tiles
def test_k_loop_matches_sum_fused_plain(legs, cout, pad, hw):
    rng = np.random.default_rng(2)
    xs = [_bf16(rng, 2, *hw, c) for c in legs]
    ks = [_bf16(rng, 3, 3, c, cout, scale=0.05) for c in legs]
    out, stats = _via_plan(pad, xs, ks)
    want = resblock.conv3x3_sum_fused_plain(xs, ks, pad=pad)
    # Both round f32 sums taken in another order: within 1e-5 of the
    # output's scale in f32, and two bf16 ulps after the one rounding.
    assert _rel(out, want[0]) <= 2 * 2.0**-8
    assert _stats_rel(stats, want[1:]) <= 1e-5


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("hw", [(8, 32), (12, 24)])
def test_k_loop_matches_reflect_fused_and_valid_stats_plain(norm, hw):
    rng = np.random.default_rng(3)
    x = _bf16(rng, 2, *hw, 128, scale=2.0)
    k = _bf16(rng, 3, 3, 128, 128, scale=0.05)
    mean, inv = instance_norm_stats(x) if norm else (None, None)
    out, stats = _via_plan("reflect", [x], [k], mean, inv)
    want = resblock.conv3x3_reflect_fused_plain(x, k, mean, inv)
    assert _rel(out, want[0]) <= 2 * 2.0**-8 and _stats_rel(stats, want[1:]) <= 1e-5
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1).contiguous()
    out, stats = _via_plan("valid", [xp], [k], mean, inv)
    want = block.conv3x3_stats_plain(xp, k, mean, inv)
    assert _rel(out, want[0]) <= 2 * 2.0**-8 and _stats_rel(stats, want[1:]) <= 1e-5
    out, _ = _via_plan("valid", [xp], [k], stats=False)
    assert _rel(out, block.conv3x3_stats_plain(xp, k)[0]) <= 2 * 2.0**-8


def test_k_loop_f32_sums_match_the_f32_conv():
    """Before the one rounding: the K loop's f32 output against the f32
    conv within 1e-5 relative, two legs, partial tiles."""
    rng = np.random.default_rng(4)
    xs = [_bf16(rng, 1, 11, 37, 128), _bf16(rng, 1, 11, 37, 64)]
    ks = [_bf16(rng, 3, 3, 128, 128, scale=0.05), _bf16(rng, 3, 3, 64, 128, scale=0.05)]
    plan = resblock._conv_plan(1, 11, 37, (128, 64), 128, "zero")
    _, partial = resblock._conv_gemm_plain(xs, ks, plan)
    x = torch.cat([t.float() for t in xs], dim=-1).permute(0, 3, 1, 2)
    k = torch.cat([t.float() for t in ks], dim=2).permute(3, 2, 0, 1)
    y = F.conv2d(x, k, padding=1).permute(0, 2, 3, 1)
    s1 = partial[:, :, 0].sum(dim=1)
    assert _rel(s1, y.sum(dim=(1, 2))) <= 1e-5
    assert _rel(partial[:, :, 1].sum(dim=1), y.square().sum(dim=(1, 2))) <= 1e-5


# (B, H, W, Cout) of the forward conv's launches on the product routes and
# in phase 2c, and the N the plan gives them: N = 64 where the output
# blocks' rounds of the 132-block wave cost at least 15% less than at 128.
_N_PICKS = [
    ((4, 32, 160, 256), 64),     # 2h: a b4 shard at S = 4 (160 → 320 blocks)
    ((4, 64, 160, 256), 64),     # 2h: a b4 shard at S = 2 (320 → 640)
    ((2, 128, 160, 256), 64),    # row 2 in the b2 band
    ((4, 128, 160, 256), 128),   # row 2 unsharded at b4 (a tie)
    ((32, 128, 160, 256), 128),  # row 2 at b32 serving, rows 9 and 10 (a tie)
    ((8, 128, 160, 256), 128),   # row 2 in b8 training (a tie)
    ((32, 256, 320, 256), 128),  # row 7's down2 launch at b32 (0.3% less at 64)
    ((32, 256, 320, 128), 128),  # row 7's up1 launch (a tie)
    ((5, 64, 160, 256), 128),    # 400 → 800 blocks: 4 → 7 rounds, 12.5% less: under the margin
]


@pytest.mark.parametrize("shape,bn", _N_PICKS)
def test_plan_picks_n64_only_where_the_waves_cost_less(shape, bn):
    b, h, w, cout = shape
    for halo, legs in (("reflect", (256,)), ("zero", (128,)), ("valid", (256,))):
        plan = resblock._conv_plan(b, h, w, legs, cout, halo)
        assert plan.bn == bn and plan.ncob * plan.bn == cout, (shape, halo)
        assert plan.b_box == (64, resblock._CF_KC, 1, 3)
    # The int8 block conv's plans stay at N = 128 (its q-stats policy runs
    # N = 128 only), and the dgrad's at its own pick.
    assert resblock._conv_plan(b, h, w, (256,), cout, "reflect", s8=True).bn == 128
    assert resblock._dgrad_plan(b, h, w, 256, cout, "reflect").conv.bn == 128


def test_plan_is_cached_and_takes_legs_as_a_tuple():
    plan = resblock._conv_plan(4, 32, 160, (256,), 256, "reflect")
    assert resblock._conv_plan(4, 32, 160, (256,), 256, "reflect") is plan
    with pytest.raises(TypeError):  # a list is not hashable: the cache refuses it
        resblock._conv_plan(4, 32, 160, [256], 256, "reflect")


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("halo", ["separate", "provided"])
def test_one_call_schedule_matches_the_plain_halo_form(halo, norm):
    """``_conv_fwd`` (the pass and the GEMM of one C call) on CPU tensors,
    at a halo shard's N = 64 plan: the output within 2 bf16 ulps and the
    per-tile sums, summed, within 1e-5 of the plain halo form's ``sums``."""
    rng = np.random.default_rng(5)
    x = _bf16(rng, 2, 8, 40, 128)
    rows = (_bf16(rng, 2, 1, 40, 128), _bf16(rng, 2, 1, 40, 128))
    k = _bf16(rng, 3, 3, 128, 128, scale=0.05)
    mean, inv = instance_norm_stats(x) if norm else (None, None)
    plan = resblock._conv_plan(2, 8, 40, (128,), 128, "reflect", norm=norm)
    assert plan.bn == 64
    src, hr = (x, rows) if halo == "separate" else (torch.cat([rows[0], x, rows[1]], dim=1), None)
    out, sums = resblock._conv_fwd((src,), (k,), plan, mean, inv, halo=halo, halo_rows=hr)
    want = resblock.conv3x3_reflect_fused_plain(x, k, mean, inv, halo="separate",
                                                halo_rows=rows, sums=True)
    assert _rel(out, want[0]) <= 2 * 2.0**-8
    assert sums.shape == (2, 2, 128) and _rel(sums, want[1]) <= 1e-5


def test_tile_sum_adds_the_tiles_in_order():
    """The tile-sum kernel's plain version: tile 0, + tile 1, + tile 2, …,
    each one f32 addition (so a sum in another order may differ)."""
    rng = np.random.default_rng(7)
    partial = torch.from_numpy(rng.standard_normal((2, 5, 2, 8), dtype=np.float32) * 1e3)
    want = partial[:, 0]
    for t in range(1, 5):
        want = want + partial[:, t]
    assert torch.equal(resblock._tile_sum_plain(partial), want)
    assert torch.equal(resblock._tile_sum_plain(partial[:, :1]), partial[:, 0])


def test_sums_are_the_f32_output_sums():
    """``sums=True`` returns (out, (B, 2, Cout) Σy, Σy²), the values of the
    f32 output's sums as before the kernels returned them without a copy;
    without it, the moments of those sums."""
    rng = np.random.default_rng(6)
    x = _bf16(rng, 2, 6, 20, 64)
    rows = (_bf16(rng, 2, 1, 20, 64), _bf16(rng, 2, 1, 20, 64))
    k = _bf16(rng, 3, 3, 64, 128, scale=0.05)
    slab = torch.cat([rows[0], x, rows[1]], dim=1).float().permute(0, 3, 1, 2)
    y = F.conv2d(F.pad(slab, (1, 1, 0, 0), mode="reflect"), k.float().permute(3, 2, 0, 1))
    y = y.permute(0, 2, 3, 1)
    out, s = resblock.conv3x3_reflect_fused(x, k, halo="separate", halo_rows=rows, sums=True)
    assert torch.equal(out, y.to(torch.bfloat16)) and s.shape == (2, 2, 128)
    assert torch.equal(s[:, 0], y.sum(dim=(1, 2)))
    assert torch.equal(s[:, 1], y.square().sum(dim=(1, 2)))
    _, m, i = resblock.conv3x3_reflect_fused(x, k, halo="separate", halo_rows=rows)
    want_m, want_i = resblock._moments(s[:, 0], s[:, 1], 6 * 20)
    assert torch.equal(m, want_m) and torch.equal(i, want_i)
