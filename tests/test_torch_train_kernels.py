"""The port's resnet-block backward against the JAX package's, in float32 on
the CPU: the JAX Pallas kernels in interpret mode, the port's kernel entry
points on their plain versions (CPU tensors), on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.ops import pallas_resblock as jr

from ircolor_tpu_torch.kernels import LAUNCHES
from ircolor_tpu_torch.kernels import resblock as tr
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _inputs(seed, b, h, w, c):
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return dict(
        p=arr(b, h, w, c), comp=arr(b, h, w, c), aux=arr(b, h, w, c), z=arr(b, h, w, c),
        k=arr(3, 3, c, c, scale=0.2), m=arr(b, c, scale=0.1), inv=np.abs(arr(b, c)) + 0.5,
        gm=arr(b, c, scale=0.1), gy=arr(b, c, scale=0.1), mm=arr(b, c, scale=0.1),
        mi=np.abs(arr(b, c)) + 0.5,
    )


def _both(d, *names):
    return [jnp.asarray(d[n]) for n in names], [torch.from_numpy(d[n]) for n in names]


_DGRAD_ARGS = ("p", "comp", "aux", "k", "m", "inv", "gm", "gy")


# H 4..16 covers a tile holding rows 1 and H−2 together (H = 4) and the
# fold corners; W 16/24. Bounds of tests/test_pallas_resblock.py.
@pytest.mark.parametrize("hw", [(4, 16), (8, 24), (12, 16), (16, 24)])
@pytest.mark.parametrize("form", ["mask_stats", "residual"])
def test_dgrad_matches_jax(hw, form):
    d = _inputs(hw[0], 2, *hw, 8)
    (jargs, targs) = _both(d, *_DGRAD_ARGS)
    (jms, tms) = _both(d, "mm", "mi")
    kw = dict(mask_stats=tuple(jms)) if form == "mask_stats" else {}
    want = jr.conv3x3_dgrad_fused(*jargs, **kw, tile_h=4, interpret=True)
    before = dict(LAUNCHES)
    got = tr.conv3x3_dgrad_fused(*targs, **({"mask_stats": tuple(tms)} if kw else {}))
    assert LAUNCHES == before  # CPU tensors: the plain version, no launch
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    if form == "mask_stats":
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-3)
    no_dy = tr.conv3x3_dgrad_fused(*targs, emit_dy=False, **({"mask_stats": tuple(tms)} if kw else {}))
    assert no_dy[1] is None
    torch.testing.assert_close(no_dy[0], got[0], rtol=0, atol=0)


@pytest.mark.parametrize("znorm", [False, True])
@pytest.mark.parametrize("hw", [(8, 16), (12, 24)])
def test_wgrad_matches_jax(hw, znorm):
    d = _inputs(10 + hw[0], 2, *hw, 8)
    for key in ("p", "comp"):  # keep |dk| near 1 so atol 1e-4 is a relative bound too
        d[key] = d[key] * np.float32(0.25)
    (jargs, targs) = _both(d, "z", "p", "comp", "m", "inv", "gm", "gy")
    (jzn, tzn) = _both(d, "mm", "mi")
    want = jr.conv3x3_wgrad_fused(*jargs, znorm=tuple(jzn) if znorm else None,
                                  tile_h=4, interpret=True)
    got = tr.conv3x3_wgrad_fused(*targs, znorm=tuple(tzn) if znorm else None)
    assert got.shape == (3, 3, 8, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.fixture(scope="module")
def block_case():
    """x, k1, k2 and an output cotangent, with jax.grad of the JAX block on
    its fused_wg route (interpret mode)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 16, 8).astype(np.float32)
    k1 = (rng.randn(3, 3, 8, 8) * 0.2).astype(np.float32)
    k2 = (rng.randn(3, 3, 8, 8) * 0.2).astype(np.float32)
    cot = rng.randn(2, 8, 16, 8).astype(np.float32)

    def loss(x, k1, k2):
        out = jr.resnet_block_pallas(x, k1, k2, tile_h=4, bwd="fused_wg", interpret=True)
        return jnp.sum(out * cot)

    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k1), jnp.asarray(k2))
    return (x, k1, k2, cot), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("bwd", ["xla", "fused", "fused_wg"])
def test_block_gradients_match_jax(block_case, bwd):
    (x, k1, k2, cot), want = block_case
    tx, tk1, tk2 = (torch.from_numpy(a).requires_grad_() for a in (x, k1, k2))
    out = tr.resnet_block_pallas(tx, tk1, tk2, bwd=bwd)
    (out * torch.from_numpy(cot)).sum().backward()
    for got, ref in zip((tx.grad, tk1.grad, tk2.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-4)


def test_block_without_grad_and_unported_modes():
    d = _inputs(0, 1, 8, 16, 8)
    x, k = torch.from_numpy(d["p"]), torch.from_numpy(d["k"])
    with torch.no_grad():
        plain = tr.resnet_block_pallas(x, k, k, bwd="fused_wg")
    assert not plain.requires_grad
    with pytest.raises(ValueError, match="bwd"):
        tr.resnet_block_pallas(x, k, k, bwd="nope")
    # The enc/dec segment modes run (tests/test_torch_encdec.py holds them
    # against JAX); an unknown pad, and mask_stats without aux, raise.
    (_, targs) = _both(d, *_DGRAD_ARGS)
    dz, dy = tr.conv3x3_dgrad_fused(targs[0], targs[1], None, *targs[3:], pad="zero",
                                    mask_p=True)
    assert dz.shape == dy.shape == targs[0].shape
    assert not torch.equal(tr.conv3x3_dgrad_fused(*targs, pad="zero")[0],
                           tr.conv3x3_dgrad_fused(*targs)[0])  # no reflect fold
    with pytest.raises(ValueError, match="pad"):
        tr.conv3x3_dgrad_fused(*targs, pad="replicate")
    with pytest.raises(ValueError, match="aux"):
        tr.conv3x3_dgrad_fused(targs[0], targs[1], None, *targs[3:], mask_stats=(targs[4],) * 2)
    (_, wargs) = _both(d, "z", "p", "comp", "m", "inv", "gm", "gy")
    dk = tr.conv3x3_wgrad_fused(*wargs, pad="zero", mask_p=True)
    assert dk.shape == (3, 3, 8, 8) and bool(torch.isfinite(dk).all())
    with pytest.raises(ValueError, match="pad"):
        tr.conv3x3_wgrad_fused(*wargs, pad="circular")
