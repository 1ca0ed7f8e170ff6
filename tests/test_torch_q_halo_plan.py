"""The int8 block conv's quantize-on-load producer, on the CPU.

On the card ``conv3x3_reflect_fused_q`` (each halo form) is one C call of
``csrc/conv_fwd.cu``: the s8 GEMM's producer warps stage the bf16 input
by TMA, quantize it once into an s8 tile and copy its shifted columns into
each stage's A buffer, where the two-launch path's operand pass wrote an
int8 slab for the GEMM's TMA boxes. What the producer writes for a (tile, chunk) has a
plain version, ``_q_load_plain``, in the kernel's row and column maps;
these tests hold it bit for bit against the slices of the pass's plain
version that the two-launch GEMM reads, at every tile of a shard, and
check the producers' unit walks and A's byte layout.
"""

import numpy as np
import pytest
import torch

from ircolor_tpu_torch.kernels import resblock
from ircolor_tpu_torch.ops.norm import instance_norm_stats
from ircolor_tpu_torch.parallel.spatial import exchange_halo_rows, shard_h
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TH, TW, KC = resblock._CF_TH, resblock._CF_TW, resblock._CF_KC_S8


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(torch.bfloat16)


def _pass_slice(zq, b, r0, c0, ci0):
    """The two-launch GEMM's three dx boxes of the pass's slab ``zq`` (B, H
    + 2, W + 2, C) at (tile r0, c0, chunk ci0): (3, TH + 2, TW, 64), TMA's
    zero fill past the slab."""
    bsz, hp, wp, c = zq.shape
    pad = torch.zeros((bsz, hp + TH + 2, wp + TW + 2, c), dtype=zq.dtype)
    pad[:, :hp, :wp] = zq
    return torch.stack([pad[b, r0 : r0 + TH + 2, c0 + dx : c0 + dx + TW, ci0 : ci0 + KC]
                        for dx in range(3)])


def _forms(x):
    b = x.shape[0]
    mean, inv = instance_norm_stats(x)
    qscale = 127.0 / x.float().abs().amax(dim=(1, 2, 3)).clamp(min=1e-12)
    return {"conv1": dict(qscale=qscale[:b].contiguous()),
            # inv × 4: values past conv2's upper clamp (z > 6) occur
            "conv2": dict(mean=mean, inv=inv * 4.0)}


@pytest.mark.parametrize("h,w,n", [
    (16, 64, 2),   # whole tiles
    (26, 40, 2),   # H % 8 != 0 (13-row shards) and W % 32 != 0
    (12, 37, 4),   # 3-row shards: one tile row holds rows -1 and H; W % 32 != 0
])
@pytest.mark.parametrize("form", ["conv1", "conv2"])
@pytest.mark.parametrize("halo", ["separate", "provided", "reflect"])
def test_producer_tiles_match_the_pass_slices(h, w, n, form, halo):
    """At every tile of every shard (first and last tile rows and columns
    included) and every chunk, the producer's three dx buffers are the
    slices of ``_q_pass_plain`` that the two-launch GEMM reads, bit for bit:
    the halo rows from top / bot (``separate``; ``provided``: the slab's
    edge rows, read in place) or reflected (``reflect``: the unsharded
    image), columns reflected, values past the plane zero."""
    rng = np.random.default_rng(18)
    x = _bf16(rng, 2, h, w, 2 * KC, scale=3.0)
    kw = _forms(x)[form]
    if halo == "reflect":
        cases = [(x, None)]
    else:
        xs = shard_h(x, [torch.device("cpu")] * n)
        cases = list(zip(xs, exchange_halo_rows(xs, 1)))
    for xi, hr in cases:
        hl = xi.shape[1]
        zq = resblock._q_pass_plain(xi, **kw, halo="reflect" if hr is None else "separate",
                                    halo_rows=hr)
        src, call = xi, dict(halo=halo, halo_rows=hr)
        if halo == "provided":
            src = torch.cat([hr[0], xi, hr[1]], dim=1)
            call = dict(halo="provided")
        for b in range(xi.shape[0]):
            for r0 in range(0, hl, TH):
                for c0 in range(0, w, TW):
                    for ci0 in range(0, xi.shape[-1], KC):
                        got = resblock._q_load_plain(src, b, r0, c0, ci0, **kw, **call)
                        want = _pass_slice(zq, b, r0, c0, ci0)
                        assert torch.equal(got, want), (b, r0, c0, ci0)


def test_producer_walks_cover_the_tile_and_every_a_byte_once():
    """The 256 producer threads quantize a chunk's (TH + 2) × (TW + 2)
    pixels × 4 channel groups once into the s8 tile, each thread in one
    channel group (its parameters held for the chunk); each stage's copy
    then writes every 16-byte unit of the A buffer once, from the tile pixel
    dx columns right of it, at distinct swizzled offsets inside its pixel's
    64-byte row; the tile pixel a copy reads is the quantized box pixel
    that the pass's slab puts there."""
    quant = torch.zeros(TH + 2, TW + 2, 4, dtype=torch.int64)
    copied = torch.zeros(TH + 2, TW, 4, dtype=torch.int64)
    offsets = set()
    for kind, t, u, p, cq, *src in resblock._q_load_walk():
        assert cq == t % 4
        if kind == "q":
            quant[p // (TW + 2), p % (TW + 2), cq] += 1
            continue
        i, col = p // TW, p % TW
        copied[i, col, cq] += 1
        assert src[0] == i * (TW + 2) + col  # dx = 0; dx adds dx to the tile pixel
        off = resblock._q_a_offset(0, p, cq)
        assert off // 64 == p and off % 16 == 0
        offsets.add(off)
    assert bool((quant == 1).all()) and bool((copied == 1).all())
    assert len(offsets) == (TH + 2) * TW * 4 == resblock._QL_COPY
    assert resblock._QL_UNITS == (TH + 2) * (TW + 2) * 4


def test_fused_call_on_cpu_is_the_two_launch_path():
    """``_q_fused`` on CPU tensors (the plain pass, GEMM and in-order tile
    sum) gives the two-launch path's output bit for bit and its sums in
    order, and the public call's halo form matches it."""
    rng = np.random.default_rng(19)
    x = _bf16(rng, 2, 13, 40, 128, scale=2.0)
    k = _bf16(rng, 3, 3, 128, 128, scale=0.05).float()
    from ircolor_tpu_torch.ops.quant import quantize_weight_per_channel

    kq, sw = quantize_weight_per_channel(k)
    sc = sw[None, :].expand(2, -1).contiguous()
    hr = (x[:, :1].contiguous(), x[:, -1:].contiguous())
    plan = resblock._conv_plan(2, 13, 40, (128,), 128, "reflect", s8=True)
    for form, kw in _forms(x).items():
        out, s = resblock._q_fused(x, resblock.q_pack(kq), sc, plan, **kw, halo="separate",
                                   halo_rows=hr)
        zq = resblock._q_pass(x, **kw, halo="separate", halo_rows=hr)
        two, partial = resblock._q_gemm(zq, resblock._q_weights(kq, plan), sc, plan)
        assert torch.equal(out, two), form
        assert torch.equal(s, resblock._tile_sum_plain(partial)), form
        want = resblock.conv3x3_reflect_fused_q_plain(x, kq, sc, **kw, halo="separate",
                                                      halo_rows=hr, sums=True)
        assert torch.equal(out, want[0]), form
        assert float((s - want[1]).abs().max() / want[1].abs().max()) <= 1e-5, form
    assert torch.equal(resblock.q_pack(kq), resblock._q_weights(kq, plan))


def _rint_clamp(v: np.ndarray, lo: float, nan_zero: bool) -> np.ndarray:
    """csrc/conv_fwd.cu's ``rint_clamp`` in float32 numpy, step for step:
    clamp, add 1.5·2^23 (round to nearest even), the int8 in the sum's low
    byte; NaN → 0 where ``nan_zero``."""
    c = np.minimum(np.maximum(v, np.float32(lo)), np.float32(127.0)).astype(np.float32)
    s = (c + np.float32(12582912.0)).astype(np.float32).view(np.uint32)
    if nan_zero:
        s = np.where(np.isnan(v), np.uint32(0), s)
    return (s & 0xFF).astype(np.uint8).view(np.int8)


@pytest.mark.parametrize("lo", [-127.0, 0.0])
def test_rint_clamp_is_cvt_rni_then_clamp(lo):
    """The producer's quantize rounds on the FP32 pipe: its low byte equals
    clamp(rint(v), lo, 127) as int8 (the pass's cvt.rni, then its clamps) on
    the .5 ties, both clamps, signed zeros, infinities and a sweep of random
    values at every scale the grids see; conv1's NaN gives 0, as cvt.rni
    does (conv2 never rounds a NaN: its ReLU maps NaN to 0)."""
    rng = np.random.default_rng(20)
    ties = np.arange(-300, 300, dtype=np.float32) + np.float32(0.5)
    special = np.array([0.0, -0.0, 126.5, 127.5, -126.5, -127.5, 1e30, -1e30, np.inf, -np.inf,
                        1e-30, -1e-30, 0.49999997, -0.49999997], dtype=np.float32)
    sweep = (rng.standard_normal(100_000) * np.float32(60.0)).astype(np.float32)
    v = np.concatenate([ties, special, sweep])
    if lo == 0.0:
        v = np.maximum(v, np.float32(0.0))  # conv2 rounds relu'd values
    want = np.clip(np.rint(v), lo, 127.0).astype(np.int8)
    assert np.array_equal(_rint_clamp(v, lo, lo < 0), want)
    assert _rint_clamp(np.array([np.nan], dtype=np.float32), -127.0, True)[0] == 0


def test_plain_version_takes_the_kernel_calls_keywords():
    """``chip_smoke.py`` (phases 4 and 8b) swaps the int8 block conv for its
    plain version inside the spatial block, which passes ``packed``: the
    plain version takes every keyword the kernel call takes."""
    import inspect

    kernel = inspect.signature(resblock.conv3x3_reflect_fused_q).parameters
    plain = inspect.signature(resblock.conv3x3_reflect_fused_q_plain).parameters
    assert list(kernel) == list(plain)
    assert all(kernel[k].default == plain[k].default for k in kernel)
