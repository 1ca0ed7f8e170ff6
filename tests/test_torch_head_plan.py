"""The fused 7×7 head's launch plan, B index table and decomposition, on the CPU.

On the card ``conv7x7_head_pallas`` is one launch of ``csrc/head.cu`` (bf16
form, row 4; s8 form, row 4q): a block stages 122 + 6 reflect-extended
columns of each input row, multiplies them by B_dy = k[dy] with N = (dx, co)
(21 of 24 columns) for the 7 vertical taps, sums each output row's taps in
registers and shift-sums the 7 horizontal taps in its epilogue. What
surrounds the kernel is Python that these tests reach: the plan
(``_head_plan``, ``check_shape``), the B index table (``_head_index``, read
through ``_head_weights``) and, here, a plain emulation of the decomposition
held against the plain versions, which ``test_torch_kernels.py`` and
``test_torch_head_q.py`` hold against JAX.
"""

import numpy as np
import pytest
import torch

from ircolor_tpu_torch.kernels import head
from ircolor_tpu_torch.ops.norm import instance_norm_stats
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TW = head._TW


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(torch.bfloat16)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 20, 70, 64),     # partial column strip and row band
    (1, 4, 4, 16),       # the minimum plane
    (3, 300, 245, 32),   # three strips, the last of one column
    (32, 512, 640, 64),  # the flagship
])
def test_plan_covers_every_output_pixel_once(shape, quant):
    b, h, w, c = shape
    plan = head._head_plan(b, h, w, c, quant)
    assert plan.grid == (-(-w // TW), -(-h // plan.th), b)
    seen = np.zeros((b, h, w), dtype=np.int32)
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            rows = slice(by * plan.th, min(by * plan.th + plan.th, h))
            cols = slice(bx * TW, min(bx * TW + TW, w))
            assert rows.start < rows.stop and cols.start < cols.stop  # no empty block
            seen[:, rows, cols] += 1
    assert (seen == 1).all()
    assert plan.nchunk * plan.kc >= c > (plan.nchunk - 1) * plan.kc
    assert plan.smem <= head._SMEM_LIMIT


def test_plan_picks_the_fewest_waves_times_rows():
    """The flagship: 6 strips × 4 bands of 128 rows × 32 images = 768
    blocks, 6 waves of 132 × 134 input rows (64-row bands: 12 × 70)."""
    plan = head._head_plan(32, 512, 640, 64, False)
    assert (plan.th, plan.grid, plan.kst, plan.nchunk) == (128, (6, 4, 32), 4, 1)
    q = head._head_plan(32, 512, 640, 64, True)
    assert (q.th, q.kst, q.kc, q.nchunk) == (128, 2, 64, 1)
    # 4 raw and 4 prepared units of 4 K steps × (128 × 32 + 32) bytes (s8:
    # prepared 2 × (128 × 32 + 64)), staging 2 × 24 × 132 × 4, the stats.
    assert plan.smem == 4 * 4 * 4128 + 4 * 4 * 4128 + 25344 + 512
    assert q.smem == 4 * 4 * 4128 + 4 * 2 * 4160 + 25344 + 512
    assert head._head_plan(1, 4, 4, 8, False)[1:5] == (1, 16, 1, 128)
    # K steps a unit: 1, 2 or 4 (C = 40, 48 run 64-channel units), then
    # 64-channel units past 64 channels.
    assert [head._head_plan(1, 16, 16, c, False).kst for c in (8, 16, 24, 32, 40, 48, 64)] == [1, 1, 2, 2, 4, 4, 4]
    assert [head._head_plan(1, 16, 16, c, True).kst for c in (16, 32, 48, 64)] == [1, 1, 2, 2]
    assert head._head_plan(1, 16, 16, 200, False)[1:4] == (4, 64, 4)


def _expected_index(c, kst, nchunk, quant):
    """The mma.sync B fragment, from the PTX layout: lane = 4g + t holds
    column g of its n8 tile; bf16 m16n8k16 rows 2t, 2t+1 (register 0) and
    2t+8, 2t+9 (register 1); s8 m16n8k32 rows 4t..4t+3 and 4t+16..4t+19."""
    kstep, ne = (32, 8) if quant else (16, 4)
    want = np.full((nchunk, 7, kst, 3, 32, ne), -1, dtype=np.int64)
    for ck in range(nchunk):
        for ks in range(kst):
            for nt in range(3):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    n = 8 * nt + g
                    for e in range(ne):
                        reg, j = divmod(e, ne // 2)
                        k = (4 * t + j + 16 * reg) if quant else (2 * t + j + 8 * reg)
                        ch = ck * kst * kstep + ks * kstep + k
                        if n < 21 and ch < c:
                            dx, co = divmod(n, 3)
                            want[ck, :, ks, nt, lane, e] = ((np.arange(7) * 7 + dx) * c + ch) * 3 + co
    return want


@pytest.mark.parametrize("quant,c", [
    *((False, c) for c in (8, 16, 24, 32, 48, 64, 72)),
    *((True, c) for c in (16, 32, 48, 64, 96)),
])
def test_weights_put_each_tap_once_where_the_fragment_reads_it(quant, c):
    """``_head_weights`` of a kernel of distinct ids 1..N: each (dy, dx, c,
    co) exactly once, at the element of the lane and register that the
    ``mma.sync`` B fragment reads it from; zeros in columns 21–23 and in the
    channels past C."""
    plan = head._head_plan(2, 16, 40, c, quant)
    ids = torch.arange(1, 7 * 7 * c * 3 + 1, dtype=torch.int64).reshape(7, 7, c, 3)
    got = head._head_weights(ids, plan)
    want = _expected_index(c, plan.kst, plan.nchunk, quant)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), np.where(want >= 0, want + 1, 0))
    vals = got[got > 0]
    assert vals.numel() == ids.numel() and torch.equal(vals.sort().values, ids.reshape(-1))
    assert int((got[:, :, :, 2, 20:] != 0).sum()) == 0  # lanes 20–31 of tile 2: columns 21–23


def _reflect(i: torch.Tensor, n: int) -> torch.Tensor:
    """csrc/common.cuh:reflect_index."""
    i = i.abs()
    i = torch.where(i >= n, 2 * n - 2 - i, i)
    return i.clamp(0, n - 1)


def _emulate(x, mean, inv, kernel, quant):
    """The kernel's decomposition in plain torch: per 122-column strip, the
    window's reflect-extended rows times B_dy rebuilt from the fragments of
    ``_head_weights``; output row r sums the 7 dy taps, then the shift-sum
    over dx. Exact (float64) in the int8 form, f32 in the float form."""
    b, h, w, c = x.shape
    plan = head._head_plan(b, h, w, c, quant)
    kstep, ne = (32, 8) if quant else (16, 4)
    if quant:
        z = torch.clamp(torch.round(head._normalize_relu(x, mean, inv) * (127.0 / 6.0)), max=127.0)
        kq, sc = head._quantize_head_weight(kernel)
        frags, dt = head._head_weights(kq, plan).double(), torch.float64
        z = z.double()
    else:
        z = head._normalize_relu(x, mean, inv).to(torch.bfloat16).float()
        frags, dt = head._head_weights(kernel.to(torch.bfloat16), plan).float(), torch.float32
    cpad = plan.nchunk * plan.kc
    bmat = torch.zeros((7, cpad, 24), dtype=dt)  # B_dy, K = channels by N = (dx, co)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for e in range(ne):
            reg, j = divmod(e, ne // 2)
            k = (4 * t + j + 16 * reg) if quant else (2 * t + j + 8 * reg)
            for ck in range(plan.nchunk):
                for ks in range(plan.kst):
                    for nt in range(3):
                        bmat[:, ck * plan.kc + ks * kstep + k, 8 * nt + g] = frags[ck, :, ks, nt, lane, e]
    zp = torch.zeros((b, h, w, cpad), dtype=dt)
    zp[..., :c] = z
    rows = _reflect(torch.arange(-3, h + 3), h)
    out = torch.empty((b, h, w, 3), dtype=dt)
    for c0 in range(0, w, TW):
        a = zp[:, rows][:, :, _reflect(torch.arange(c0 - 3, c0 + TW + 3), w)]  # (b, h+6, 134, K)
        p = torch.einsum("bipk,dkn->bdipn", a, bmat)
        q = sum(p[:, dy, dy : dy + h] for dy in range(7))  # (b, h, 134, 24)
        cols = min(TW, w - c0)
        for co in range(3):
            s = q[:, :, 0:cols, co]
            for dx in range(1, 7):
                s = s + q[:, :, dx : dx + cols, 3 * dx + co]
            out[:, :, c0 : c0 + cols, co] = s
    if quant:
        return (out.float() * sc).to(torch.bfloat16)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(2, 9, 20), (1, 4, 4), (1, 6, 130)])
@pytest.mark.parametrize("quant,c", [
    *((False, c) for c in (8, 16, 24, 32, 48, 64)),
    *((True, c) for c in (16, 32, 48, 64)),
])
def test_emulation_matches_plain(shape, quant, c):
    """The per-row GEMMs over the taps and the dx shift-sum equal
    ``conv7x7_head_plain`` within 2 bf16 ulps at the output's scale (f32
    sums in another order) and ``conv7x7_head_q_plain`` bit for bit (exact
    integer sums before the cvt), at partial strips, two strips and the
    minimum plane."""
    rng = np.random.default_rng(11)
    x = _bf16(rng, *shape, c)
    k = _bf16(rng, 7, 7, c, 3, scale=0.05)
    mean, inv = instance_norm_stats(x)
    got = _emulate(x, mean, inv, k, quant)
    if quant:
        assert torch.equal(got, head.conv7x7_head_q_plain(x, mean, inv, k))
    else:
        want = head.conv7x7_head_plain(x, mean, inv, k).float()
        assert float((got.float() - want).abs().max()) <= 2 * 2.0**-8 * float(want.abs().max())


def test_every_head_gate_shape_is_accepted():
    """Every plane the generator's head gate (``head_supported``, copied
    from JAX) admits at ngf 8–64 passes the card's guard in the float form,
    and in the int8 form where C % 16 == 0; C = 8 and 24 included."""
    admitted = set()
    for c in range(8, 72, 8):
        for h in [*range(4, 72, 4), 128, 256, 512]:
            for w in [*range(8, 264, 8), 512, 640]:
                if not head.head_supported((1, h, w, c)):
                    continue
                for b in (1, 2, 32):
                    plan = head.check_shape(b, h, w, c, (7, 7, c, 3), False)
                    assert plan.grid[0] * TW >= w and plan.grid[1] * plan.th >= h
                    if c % 16 == 0:
                        head.check_shape(b, h, w, c, (7, 7, c, 3), True)
                admitted.add((h, w, c))
    for c in (8, 24):
        for w in (128, 256, 512, 640):
            assert (256, w, c) in admitted
    assert (512, 640, 64) in admitted


def test_card_guard_refusals():
    with pytest.raises(ValueError, match="C % 8"):
        head.check_shape(1, 16, 16, 12, (7, 7, 12, 3), False)
    with pytest.raises(ValueError, match="C % 16"):
        head.check_shape(1, 16, 16, 24, (7, 7, 24, 3), True)
    with pytest.raises(ValueError, match="H, W >= 4"):
        head.check_shape(1, 3, 16, 16, (7, 7, 16, 3), False)
    with pytest.raises(ValueError, match="B <= 65535"):
        head.check_shape(65536, 16, 16, 16, (7, 7, 16, 3), False)
    with pytest.raises(ValueError, match="kernel="):
        head.check_shape(1, 16, 16, 16, (7, 7, 16, 4), False)
