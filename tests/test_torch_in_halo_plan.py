"""Row 11h (kernel 11 on H-shards) on the CPU: its launch plan in plain
Python (the form by where the shards are, the cluster size, the channel
slice, each cluster CTA's staged bytes against a block's 227 KB of shared
memory, the shard table) and its plain merge, through
``run_in_spatial_plain``, against the JAX package's kernel 11 (interpret
mode) on the gathered plane."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ircolor_tpu.ops import pallas_kernels as jk

from ircolor_tpu_torch.kernels import instance_norm as tin
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

_CPU, _CARD0, _CARD1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)
_SMEM = 232448  # a block's dynamic shared memory on the H100: 227 KB
_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _split(h: int, s: int) -> tuple:
    """H rows over s shards, the first h % s a row taller."""
    return tuple(h // s + (i < h % s) for i in range(s))


@pytest.mark.parametrize("devices,per_shard,form", [
    ((_CARD0,) * 2, False, "cluster"),
    ((_CARD0,) * 8, False, "cluster"),
    ((_CARD0,) * 9, False, "per_shard"),       # S > 8: over the portable cluster size
    ((_CARD0, _CARD1), False, "per_shard"),   # shards on two cards
    ((_CARD0,) * 2, True, "per_shard"),       # the private switch the card tests use
    ((_CPU,) * 4, False, "plain"),
    ((_CPU,) * 4, True, "plain"),
], ids=["one-card-s2", "one-card-s8", "one-card-s9", "two-cards", "per-shard-asked", "cpu",
        "cpu-per-shard-asked"])
def test_form_and_cluster_size_by_device_layout(devices, per_shard, form):
    plan = tin.halo_plan((4,) * len(devices), 8, 16, torch.bfloat16, devices, per_shard)
    assert plan.form == form
    assert plan.cluster == (len(devices) if form == "cluster" else 0)
    assert plan.smem == 0 if form != "cluster" else plan.smem > 0


def test_shards_on_the_cpu_and_a_card_raise():
    with pytest.raises(ValueError, match="every shard"):
        tin.halo_form((_CPU, _CARD0))


def _admitted_planes():
    """(H, W, C, dtype) that ``pallas_fits`` admits: the 256² bottleneck,
    and for each C and W the tallest plane under the gate (its edge)."""
    planes = [(64, 64, 256, torch.bfloat16), (64, 64, 256, torch.float32)]
    for dtype in (torch.bfloat16, torch.float32):
        for c in (8, 12, 24, 40, 64, 128, 256, 512):
            for w in (7, 64, 128, 160):
                h = 1
                while tin.pallas_fits((1, 2 * h, w, c), dtype):
                    h *= 2
                lo, hi = h, 2 * h  # fits at lo, not at hi
                while hi - lo > 1:
                    mid = (lo + hi) // 2
                    lo, hi = (mid, hi) if tin.pallas_fits((1, mid, w, c), dtype) else (lo, mid)
                planes.append((lo, w, c, dtype))
    return planes


@pytest.mark.parametrize("s", range(2, 9))
def test_cluster_ctas_stage_what_fits_shared_memory(s):
    """Every (S, plane) the gate admits: a 64-byte channel slice where C
    holds one and the tallest shard's 64-byte slice plane fits beside the
    head in 227 KB, else 32 bytes, the same in the per-shard form; each CTA
    stages its shard's slice plane (h·W·slice bytes) where it fits, else
    nothing (it reads x again); the launch asks for the head and the
    largest stage, never more than 227 KB."""
    for h, w, c, dtype in _admitted_planes():
        assert tin.pallas_fits((1, h, w, c), dtype)
        heights = _split(h, s)
        plan = tin.halo_plan(heights, w, c, dtype, (_CARD0,) * s)
        wide = (tin._shard_head_bytes(dtype, 64) + max(heights) * w * 64 <= _SMEM
                and c * dtype.itemsize >= 64)
        assert plan.slice_bytes == (64 if wide else 32)
        assert tin.halo_plan(heights, w, c, dtype, (_CARD0,) * s, True).slice_bytes == (
            plan.slice_bytes)
        head = tin._shard_head_bytes(dtype, plan.slice_bytes)
        assert plan.form == "cluster" and plan.cluster == s
        assert plan.smem == head + plan.stage_cap <= _SMEM
        assert plan.stage_cap == max(plan.staged)
        for rows, staged in zip(heights, plan.staged):
            need = rows * w * plan.slice_bytes
            assert staged == (need if head + need <= _SMEM else 0), (h, w, c, dtype, s)


def test_cluster_stage_at_the_planes_the_design_names():
    """S = 2: 128 KB a CTA (64-byte slices) on the 16×64×64×256 bottleneck,
    64 KB at S = 4; 160 KB (32-byte slices) on the largest plane the gate
    admits where C is a multiple of 128 (80×128); a C = 64 bf16 plane at
    the gate's edge needs 320 KB a CTA even at 32 bytes: unstaged."""
    two = (_CARD0,) * 2
    plan = tin.halo_plan((32, 32), 64, 256, torch.bfloat16, two)
    assert plan.slice_bytes == 64 and plan.staged == (128 * 1024,) * 2
    plan = tin.halo_plan((16,) * 4, 64, 256, torch.bfloat16, (_CARD0,) * 4)
    assert plan.slice_bytes == 64 and plan.staged == (64 * 1024,) * 4
    assert tin.pallas_fits((1, 80, 128, 256), torch.bfloat16)
    assert not tin.pallas_fits((1, 81, 128, 256), torch.bfloat16)
    plan = tin.halo_plan((40, 40), 128, 256, torch.bfloat16, two)
    assert plan.slice_bytes == 32 and plan.staged == (160 * 1024,) * 2
    assert tin.pallas_fits((1, 160, 128, 64), torch.bfloat16)
    plan = tin.halo_plan((80, 80), 128, 64, torch.bfloat16, two)
    assert plan.staged == (0, 0) and plan.smem == tin._shard_head_bytes(torch.bfloat16, 32)


def test_shard_table_starts_and_rows_with_an_empty_shard():
    plan = tin.halo_plan((5, 0, 9, 2), 7, 40, torch.bfloat16, (_CARD0,) * 4)
    assert plan.starts == (0, 5, 5, 14) and plan.rows == (5, 0, 9, 2)
    assert plan.slice_bytes == 64
    assert plan.staged == (5 * 7 * 64, 0, 9 * 7 * 64, 2 * 7 * 64)
    assert plan.stage_cap == 9 * 7 * 64
    assert tin.halo_plan((5, 0, 9, 2), 7, 12, torch.bfloat16, (_CARD0,) * 4).slice_bytes == 32
    assert tin.halo_plan((5, 0, 9, 2), 7, 40, torch.bfloat16, (_CARD0, _CARD1) * 2).starts == (
        0, 5, 5, 14)


def test_merge_takes_the_kernels_steps_one_rounding_each():
    """``merge_shard_stats`` against the kernels' ``merge_parts`` steps
    replayed in numpy float32, bit for bit: mean = (Σ nᵢ·meanᵢ) / n, M2 = Σ
    (M2ᵢ + nᵢ·(meanᵢ − mean)²), inv = 1 / sqrt(M2 / n + 1e-5); the empty
    shard adds nothing."""
    rng = np.random.RandomState(5)
    ns = (13 * 10, 0, 8 * 10, 10 * 10)
    means = [rng.randn(2, 24).astype(np.float32) * 3 for _ in ns]
    m2s = [(rng.rand(2, 24).astype(np.float32) + 0.5) * n for n in ns]
    mean, inv = tin.merge_shard_stats([(n, torch.from_numpy(m), torch.from_numpy(q))
                                       for n, m, q in zip(ns, means, m2s)])
    f = np.float32
    s = np.zeros((2, 24), f)
    for n, m in zip(ns, means):
        if n:
            s = s + m * f(n)
    mu = s / f(sum(ns))
    q = np.zeros((2, 24), f)
    for n, m, m2 in zip(ns, means, m2s):
        if n:
            d = m - mu
            q = q + (m2 + (d * d) * f(n))
    want_inv = f(1) / np.sqrt(q / f(sum(ns)) + f(1e-5))
    assert mean.dtype == inv.dtype == torch.float32
    np.testing.assert_array_equal(mean.numpy(), mu)
    np.testing.assert_array_equal(inv.numpy(), want_inv)


def _close(got: torch.Tensor, want, dtype: str) -> None:
    """f32: 1e-5 relative to max(|value|, 1); bf16: one bf16 ulp of the JAX
    value (at least 1e-6, where x ≈ mean leaves f32 noise around 0)."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "f32":
        assert float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1.0))) <= 1e-5
        return
    ulp = np.maximum(2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0**-126))) - 7), 1e-6)
    assert np.all(np.abs(g - w) <= ulp), float(np.max(np.abs(g - w) / ulp))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", [24, 12])
@pytest.mark.parametrize("heights", [(8, 8), (13, 1, 8, 10), (5, 0, 9, 2)],
                         ids=["equal", "unequal", "empty"])
def test_plain_merge_matches_jax_kernel_11_on_the_plane(heights, c, dtype):
    jd, td = _DTYPES[dtype]
    rng = np.random.RandomState(sum(heights) + c)
    x = (rng.randn(2, sum(heights), 10, c) * 3 + 1).astype(np.float32)
    r = rng.randn(*x.shape).astype(np.float32)
    jx, jr = jnp.asarray(x).astype(jd), jnp.asarray(r).astype(jd)
    tx, tr = torch.from_numpy(x).to(td), torch.from_numpy(r).to(td)
    xs, rs = list(tx.split(list(heights), 1)), list(tr.split(list(heights), 1))
    for relu in (False, True):
        got = torch.cat(tin.run_in_spatial_plain(xs, relu), 1)
        _close(got, jk.fused_instance_norm(jx, relu, True), dtype)
    got = torch.cat(tin.run_in_spatial_plain(xs, residuals=rs), 1)
    _close(got, jk.fused_instance_norm_residual(jx, jr, True), dtype)
