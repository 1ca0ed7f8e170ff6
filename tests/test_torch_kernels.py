"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels run
in interpret mode, as their own tests run them. Inputs are made with numpy
from a seed and fed to both, in float32. The kernels themselves are held
against the plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.ops import pallas_blur, pallas_head, pallas_resblock
from ircolor_tpu.ops.norm import instance_norm_stats as jax_in_stats

from ircolor_tpu_torch.kernels import LAUNCHES, blur, conv_int8, head, resblock
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _stats_np(raw):
    m = raw.mean(axis=(1, 2))
    v = (raw * raw).mean(axis=(1, 2)) - m * m
    return m.astype(np.float32), (1.0 / np.sqrt(v + 1e-5)).astype(np.float32)


# --- #2 conv3x3_reflect_fused (bf16 kernel; f32 here) ---------------------


@pytest.mark.parametrize("tile_h", [4, 8, 16])
def test_conv3x3_reflect_matches_jax(tile_h):
    """H=16 with JAX tiles 4/8/16 covers its interior, two-tile and
    single-tile halo branches; bounds as tests/test_pallas_resblock.py."""
    rng = np.random.RandomState(0)
    b, h, w, c = 2, 16, 24, 8
    x = rng.randn(b, h, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, 12) * 0.1).astype(np.float32)
    want, wm, wi = pallas_resblock.conv3x3_reflect_fused(
        jnp.asarray(x), jnp.asarray(k), tile_h=tile_h, interpret=True
    )
    got, gm, gi = resblock.conv3x3_reflect_fused(t(x), t(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-4)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-3, rtol=1e-4)


def test_conv3x3_reflect_norm_on_load_matches_jax():
    rng = np.random.RandomState(1)
    b, h, w, c = 1, 8, 16, 8
    raw_prev = rng.randn(b, h, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, c) * 0.1).astype(np.float32)
    m, inv = _stats_np(raw_prev)
    want, wm, wi = pallas_resblock.conv3x3_reflect_fused(
        jnp.asarray(raw_prev), jnp.asarray(k), jnp.asarray(m), jnp.asarray(inv),
        tile_h=4, interpret=True,
    )
    got, gm, gi = resblock.conv3x3_reflect_fused(t(raw_prev), t(k), t(m), t(inv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-4)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-3, rtol=1e-4)


def test_resnet_block_matches_jax():
    rng = np.random.RandomState(2)
    b, h, w, c = 2, 16, 16, 8
    x = rng.randn(b, h, w, c).astype(np.float32)
    k1 = (rng.randn(3, 3, c, c) * 0.1).astype(np.float32)
    k2 = (rng.randn(3, 3, c, c) * 0.1).astype(np.float32)
    want = pallas_resblock.resnet_block_pallas(
        jnp.asarray(x), jnp.asarray(k1), jnp.asarray(k2), tile_h=8, interpret=True
    )
    got = resblock.resnet_block_pallas(t(x), t(k1), t(k2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# --- #1 conv3x3_reflect_fused_q (int8) ------------------------------------


def _int8_block_bound(got, want, x, k1, k2):
    """(max difference in quant steps, fraction of elements differing). A
    step is one int8 input step of conv2 through the channel's largest
    weight, carried through the block's final instance norm:
    sc2·127·i2 = 6·sw2[co]·i2[b, co]. Elements 'differ' when they are more
    than 1e-5 apart."""
    from ircolor_tpu_torch.ops.quant import _QCLIP, quantize_weight_per_channel

    xt = t(x)
    kq1, sw1 = quantize_weight_per_channel(t(k1))
    kq2, sw2 = quantize_weight_per_channel(t(k2))
    amax = xt.abs().amax(dim=(1, 2, 3))
    sc1 = (amax / 127.0)[:, None] * sw1[None, :]
    raw1, m1, i1 = resblock.conv3x3_reflect_fused_q(xt, kq1, sc1, qscale=127.0 / amax)
    sc2 = ((_QCLIP / 127.0) * sw2[None, :]).expand(x.shape[0], -1)
    _, _, i2 = resblock.conv3x3_reflect_fused_q(raw1, kq2, sc2, mean=m1, inv=i1)
    step = (sc2 * 127.0 * i2).numpy()[:, None, None, :]
    d = np.abs(got - want)
    return float((d / step).max()), float((d > 1e-5).mean())


@pytest.mark.parametrize("tile_h", [4, 16])
def test_resnet_block_q_matches_jax(tile_h):
    rng = np.random.RandomState(3)
    b, h, w, c = 2, 16, 24, 8
    x = rng.randn(b, h, w, c).astype(np.float32)
    k1 = (rng.randn(3, 3, c, c) * 0.1).astype(np.float32)
    k2 = (rng.randn(3, 3, c, c) * 0.1).astype(np.float32)
    want = np.asarray(pallas_resblock.resnet_block_pallas_q(
        jnp.asarray(x), jnp.asarray(k1), jnp.asarray(k2), tile_h=tile_h, interpret=True
    ))
    got = resblock.resnet_block_pallas_q(t(x), t(k1), t(k2)).numpy()
    steps, frac = _int8_block_bound(got, want, x, k1, k2)
    assert steps <= 2.5, steps
    assert frac <= 1e-3, frac


def test_resnet_block_q_tracks_float64_moments():
    """Non-negative block input with |mean| ≫ std (what the generator's
    bottleneck sees): the port's int8 block, with its one-pass f32 moments,
    stays within 1e-5 of the same block with float64 two-pass moments."""
    rng = np.random.RandomState(0)
    c = 256
    x = np.abs(rng.randn(2, 8, 16, c)).astype(np.float32)
    k1 = (rng.randn(3, 3, c, c) * 0.02).astype(np.float32)
    k2 = (rng.randn(3, 3, c, c) * 0.02).astype(np.float32)
    got = resblock.resnet_block_pallas_q(t(x), t(k1), t(k2)).numpy()

    def conv_q_f64_moments(x, kq, sc, *, qscale=None, mean=None, inv=None):
        q = resblock._quantize_input(x, qscale, mean, inv)
        y = conv_int8.int_conv_exact(q, kq, "reflect").float() * sc[:, None, None, :]
        y64 = y.double()
        m = y64.mean(dim=(1, 2))
        v = (y64 - m[:, None, None, :]).square().mean(dim=(1, 2))
        return y, m.float(), torch.rsqrt(v + 1e-5).float()

    saved = resblock.conv3x3_reflect_fused_q
    resblock.conv3x3_reflect_fused_q = conv_q_f64_moments
    try:
        want = resblock.resnet_block_pallas_q(t(x), t(k1), t(k2)).numpy()
    finally:
        resblock.conv3x3_reflect_fused_q = saved
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_conv3x3_q_both_forms_match_jax():
    """conv1 (per-sample 127/amax on load) and conv2 (normalize + ReLU +
    fixed 127/6 grid on load) against the JAX int8 kernel: the integer
    products are exact on both sides, so the outputs agree to f32 rounding."""
    from ircolor_tpu.ops.quant import quantize_weight_per_channel as jax_qw

    from ircolor_tpu_torch.ops.quant import quantize_weight_per_channel

    rng = np.random.RandomState(4)
    b, h, w, c = 2, 8, 16, 32
    x = rng.randn(b, h, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, c) * 0.1).astype(np.float32)
    kq_j, sw_j = jax_qw(jnp.asarray(k))
    kq, sw = quantize_weight_per_channel(t(k))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(kq_j))
    np.testing.assert_allclose(sw.numpy(), np.asarray(sw_j), rtol=1e-7)
    amax = np.abs(x).max(axis=(1, 2, 3)).astype(np.float32)
    qs = (127.0 / amax).astype(np.float32)
    sc1 = ((amax / 127.0)[:, None] * sw.numpy()[None, :]).astype(np.float32)
    m, inv = _stats_np(x)
    sc2 = np.broadcast_to(6.0 / 127.0 * sw.numpy()[None, :], (b, c)).astype(np.float32)
    for sc, kw_j, kw in (
        (sc1, dict(qscale=jnp.asarray(qs)), dict(qscale=t(qs))),
        (sc2, dict(mean=jnp.asarray(m), inv=jnp.asarray(inv)), dict(mean=t(m), inv=t(inv))),
    ):
        want, wm, wi = pallas_resblock.conv3x3_reflect_fused_q(
            jnp.asarray(x), kq_j, jnp.asarray(sc), tile_h=4, interpret=True, **kw_j
        )
        got, gm, gi = resblock.conv3x3_reflect_fused_q(t(x), kq, t(sc), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-5)
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=1e-4)


# --- #3 norm_relu_blur_down -----------------------------------------------


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 32, 40, 16), (2, 8, 64, 8)])
def test_norm_relu_blur_down_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    m, inv = (np.asarray(a) for a in jax_in_stats(jnp.asarray(x)))
    want = pallas_blur.norm_relu_blur_down_pallas(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(inv), interpret=True
    )
    got = blur.norm_relu_blur_down_pallas(t(x), t(m), t(inv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # The composed op computes its own stats.
    np.testing.assert_allclose(
        blur.norm_relu_blur_down(t(x)).numpy(), np.asarray(want), atol=1e-4
    )


# --- #4 conv7x7 head --------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 16, 64, 8), (1, 16, 80, 8), (1, 8, 32, 16)])
def test_conv7x7_head_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    b, h, w, c = shape
    x = (rng.rand(*shape) * 2 - 1).astype(np.float32)
    k = (rng.rand(7, 7, c, 3) * 0.2 - 0.1).astype(np.float32)
    m, inv = (np.asarray(a) for a in jax_in_stats(jnp.asarray(x)))
    # The JAX references traced once under jax.jit (eager interpret mode
    # dispatches every op of every grid step).
    want = jax.jit(functools.partial(pallas_head.conv7x7_head_pallas, interpret=True))(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(inv), jnp.asarray(k)
    )
    got = head.conv7x7_head_pallas(t(x), t(m), t(inv), t(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(
        head.outc_head(t(x), t(k)).numpy(),
        np.asarray(jax.jit(functools.partial(pallas_head.outc_head, interpret=True))(
            jnp.asarray(x), jnp.asarray(k))),
        atol=1e-4,
    )


@pytest.mark.parametrize("shape", [(1, 512, 640, 64), (2, 32, 64, 64), (1, 64, 48, 64)])
def test_routing_gates_match_jax(shape):
    """The copied gates answer as the JAX ones do."""
    assert head.head_supported(shape) == pallas_head.head_supported(shape)
    for c in (64, 128, 256):
        s = (*shape[:3], c)
        assert blur.norm_blur_supported(s) == pallas_blur.norm_blur_supported(s)


def test_cpu_tensors_run_the_plain_versions():
    """A CPU tensor never reaches a kernel: no launch is counted."""
    before = dict(LAUNCHES)
    x = torch.randn(1, 8, 16, 128)
    k = torch.randn(3, 3, 128, 128) * 0.05
    resblock.resnet_block_pallas(x, k, k)
    resblock.resnet_block_pallas_q(x, k, k)
    blur.norm_relu_blur_down(x)
    head.outc_head(x[..., :64], torch.randn(7, 7, 64, 3) * 0.02)
    assert LAUNCHES == before
