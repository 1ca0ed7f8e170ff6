"""The port's VALID conv with IN statistics (TPU kernel 9,
``kernels.block``) against the JAX package's on the CPU: the JAX Pallas
kernel in interpret mode (traced under ``jax.jit``), the port's entry points
on their plain version (CPU tensors), on the same numpy inputs; and the
ResnetBlock they compose, against JAX's composition and the port's own
fused block."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.ops.padding import reflect_pad2d as jpad
from ircolor_tpu.ops.pallas_block import conv3x3_norm_in_stats, conv3x3_stats

from ircolor_tpu_torch.kernels import block, resblock
from ircolor_tpu_torch.ops.padding import reflect_pad2d
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

B, H, W, C = 2, 16, 20, 8  # tests/test_pallas_block.py's shape


@functools.lru_cache(maxsize=1)
def _case():
    rng = np.random.RandomState(0)
    x = rng.randn(B, H, W, C).astype(np.float32)
    k1 = (rng.randn(3, 3, C, C) * 0.1).astype(np.float32)
    k2 = (rng.randn(3, 3, C, C) * 0.1).astype(np.float32)

    @jax.jit
    def jblock(x, k1, k2):
        raw1, m1, i1 = conv3x3_stats(jpad(x, 1), k1, tile_h=8, interpret=True)
        raw2, m2, i2 = conv3x3_norm_in_stats(jpad(raw1, 1), k2, m1, i1, tile_h=8, interpret=True)
        return (raw1, m1, i1), (raw2, m2, i2), x + (raw2 - m2[:, None, None, :]) * i2[:, None, None, :]

    want = jax.tree.map(np.array, jblock(x, k1, k2))  # writable copies
    return (x, k1, k2), want


def _port_block(x, k1, k2):
    raw1, m1, i1 = block.conv3x3_stats(reflect_pad2d(x, 1), k1, tile_h=8)
    raw2, m2, i2 = block.conv3x3_norm_in_stats(reflect_pad2d(raw1, 1), k2, m1, i1, tile_h=8)
    return (raw1, m1, i1), (raw2, m2, i2), resblock._block_epilogue(x, raw2, m2, i2)


@pytest.mark.parametrize("stage", ["stats", "norm_in_stats"])
def test_stats_entry_points_match_jax(stage):
    """Each entry point on the same input as JAX's (norm_in_stats on JAX's
    raw1 and stats): raw and mean at atol 1e-4, inv at 1e-3 relative. The
    normalize on load covers the reflect-padded halo too."""
    (x, k1, k2), (s1, s2, _) = _case()
    if stage == "stats":
        got = block.conv3x3_stats(reflect_pad2d(torch.from_numpy(x), 1), torch.from_numpy(k1),
                                  tile_h=8)
        want = s1
    else:
        raw1, m1, i1 = (torch.from_numpy(a) for a in s1)
        got = block.conv3x3_norm_in_stats(reflect_pad2d(raw1, 1), torch.from_numpy(k2), m1, i1,
                                          tile_h=8)
        want = s2
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-3)


def test_composed_block_matches_jax_and_the_fused_block():
    """``x + (raw2 − m2)·i2`` from the two entry points: within 1e-3 of the
    JAX composition (tests/test_pallas_block.py's bound) and of the port's
    ``resnet_block_pallas`` on its plain route (reflect halos in the index
    map instead of a padded tensor)."""
    (x, k1, k2), (_, _, want) = _case()
    tx, tk1, tk2 = (torch.from_numpy(a) for a in (x, k1, k2))
    got = _port_block(tx, tk1, tk2)[2]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    fused = resblock.resnet_block_pallas(tx, tk1, tk2)
    np.testing.assert_allclose(got.numpy(), fused.numpy(), atol=1e-3)


def test_refuses_what_jax_refuses():
    x, k = torch.zeros(1, 14, 18, 8), torch.zeros(3, 3, 8, 8)  # H = 12
    with pytest.raises(AssertionError):
        conv3x3_stats(jnp.zeros((1, 14, 18, 8)), jnp.zeros((3, 3, 8, 8)), tile_h=8, interpret=True)
    with pytest.raises(ValueError, match="tile_h"):
        block.conv3x3_stats(x, k, tile_h=8)
    with pytest.raises(ValueError, match="tile_h"):
        block.conv3x3_norm_in_stats(x, k, torch.zeros(1, 8), torch.ones(1, 8), tile_h=8)
