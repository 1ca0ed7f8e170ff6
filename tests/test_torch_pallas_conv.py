"""The port's implicit-GEMM VALID conv (TPU kernel 10, ``kernels.conv``)
against the JAX package's on the CPU: the JAX Pallas kernels in interpret
mode (traced under ``jax.jit``), the port's entry points on their plain
version (CPU tensors), on the same numpy inputs; and the JAX asserts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.ops import pallas_conv as jc

from ircolor_tpu_torch.kernels import conv as tc
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# (entry, x_padded shape, kernel shape, tile_h, seed): tests/test_pallas_conv.py's
# cases — v1, v2 in both modes, and W + 2 not a multiple of 8 (v1).
_CASES = {
    "v1": ("v1", (2, 18, 22, 8), (3, 3, 8, 16), 8, 0),
    "v2-preshift": ("preshift", (2, 18, 18, 8), (3, 3, 8, 16), 8, 2),
    "v2-dxcat": ("dxcat", (2, 18, 18, 8), (3, 3, 8, 16), 8, 2),
    "v1-unaligned-width": ("v1", (1, 10, 13, 8), (3, 3, 8, 8), 4, 1),
}


def _call(mod, entry, x, k, tile_h, **kw):
    if entry == "v1":
        return mod.conv3x3_valid_pallas(x, k, tile_h=tile_h, **kw)
    return mod.conv3x3_valid_pallas_v2(x, k, tile_h=tile_h, mode=entry, **kw)


@pytest.mark.parametrize("case", list(_CASES))
def test_valid_conv_matches_jax(case):
    """Each entry point against its own JAX counterpart, atol 1e-4 (the JAX
    test's bound), and against the plain f32 VALID conv."""
    entry, xs, ks, tile_h, seed = _CASES[case]
    x, k = _rand(xs, seed), _rand(ks, seed + 10, 0.1)
    jfn = jax.jit(lambda a, b: _call(jc, entry, a, b, tile_h, interpret=True))
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(k)))
    got = _call(tc, entry, torch.from_numpy(x), torch.from_numpy(k), tile_h)
    assert got.shape == want.shape == (xs[0], xs[1] - 2, xs[2] - 2, ks[-1])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), tc.conv3x3_valid_plain(torch.from_numpy(x), torch.from_numpy(k)).numpy(),
        atol=0)


# Inputs each JAX entry point refuses with an assert: a kernel whose C is
# not the input's, H not a multiple of tile_h, (v2) W not 8-aligned, an
# unknown mode.
_REFUSED = {
    "kernel-c": ("v1", (1, 10, 18, 8), (3, 3, 4, 8), 8),
    "tile-h": ("v1", (1, 14, 18, 8), (3, 3, 8, 8), 8),
    "v2-tile-h": ("dxcat", (1, 14, 18, 8), (3, 3, 8, 8), 8),
    "v2-width": ("preshift", (1, 10, 14, 8), (3, 3, 8, 8), 8),
    "v2-mode": ("bogus", (1, 10, 18, 8), (3, 3, 8, 8), 8),
}


@pytest.mark.parametrize("case", list(_REFUSED))
def test_valid_conv_refuses_what_jax_refuses(case):
    entry, xs, ks, tile_h = _REFUSED[case]
    with pytest.raises(AssertionError):
        _call(jc, entry, jnp.zeros(xs), jnp.zeros(ks), tile_h, interpret=True)
    with pytest.raises(ValueError):
        _call(tc, entry, torch.zeros(xs), torch.zeros(ks), tile_h)
