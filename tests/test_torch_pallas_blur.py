"""The port's blur-pool kernel (TPU kernel 8, ``kernels.blur.
blur_downsample_pallas``) against the JAX package's on the CPU: the JAX
Pallas kernel in interpret mode (traced under ``jax.jit``), the port's
entry point on its plain version (CPU tensors), on the same numpy inputs."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.ops import pallas_blur as jb

from ircolor_tpu_torch.kernels import LAUNCHES
from ircolor_tpu_torch.kernels import blur as tb
from ircolor_tpu_torch.ops.blurpool import blur_downsample
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

_jax_blur = jax.jit(functools.partial(jb.blur_downsample_pallas, interpret=True))


@pytest.mark.parametrize("shape, dtype", [
    ((2, 64, 64, 8), "f32"), ((1, 32, 40, 3), "f32"), ((2, 8, 16, 5), "f32"),
    ((1, 128, 160, 16), "f32"), ((2, 16, 24, 8), "bf16"),
])
def test_blur_downsample_matches_jax(shape, dtype):
    """The JAX test's four shapes at its bound (atol 2e-6, f32), and a bf16
    case within one bf16 ulp of the JAX value: both round the same f32 sum.
    The port's own depthwise-conv blur-pool agrees as well (another order of
    the same sums)."""
    a = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32) * 2 - 1
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(_jax_blur(jnp.asarray(a).astype(jd)).astype(jnp.float32))
    x = torch.from_numpy(a).to(td)
    before = dict(LAUNCHES)
    got = tb.blur_downsample_pallas(x)
    assert LAUNCHES == before  # a CPU tensor: the plain version, no launch
    assert got.dtype == td and got.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    g, conv = got.float().numpy(), blur_downsample(x.float()).numpy()
    if dtype == "f32":
        np.testing.assert_allclose(g, want, atol=2e-6)
        np.testing.assert_allclose(g, conv, atol=2e-6)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
    assert np.all(np.abs(g - want) <= ulp)
    assert np.all(np.abs(g - conv) <= ulp)


@pytest.mark.parametrize("shape", [(1, 2, 8, 3), (1, 7, 8, 3), (1, 8, 7, 3)])
def test_blur_downsample_refuses_what_jax_refuses(shape):
    """H/2 too small to tile, odd H, odd W: ``supported`` is the JAX one,
    and both entry points refuse the shape."""
    assert not tb.supported(shape) and not jb.supported(shape)
    with pytest.raises(AssertionError):
        jb.blur_downsample_pallas(jnp.zeros(shape), interpret=True)
    with pytest.raises(ValueError, match="unsupported shape"):
        tb.blur_downsample_pallas(torch.zeros(shape))
