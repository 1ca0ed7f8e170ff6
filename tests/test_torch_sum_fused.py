"""The port's multi-input SAME conv with free IN statistics (TPU kernel 7,
``kernels.resblock.conv3x3_sum_fused``) against the JAX package's on the
CPU: the JAX Pallas kernel in interpret mode (traced under ``jax.jit``),
the port's entry point on its plain version (CPU tensors), on the same
numpy inputs; and the d2-stage composition it feeds (kernel 7's free stats
into kernel 3), as the JAX tools build it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.ops.pallas_blur import norm_relu_blur_down_pallas as jnrbd
from ircolor_tpu.ops.pallas_resblock import conv3x3_sum_fused as jsum

from ircolor_tpu_torch.kernels import LAUNCHES, blur, resblock
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _legs(b, h, w, chans, cout, seed):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(b, h, w, c).astype(np.float32) for c in chans]
    k = (rng.randn(3, 3, sum(chans), cout) * 0.1).astype(np.float32)
    cuts = np.cumsum((0, *chans))
    return xs, [k[:, :, a:z] for a, z in zip(cuts[:-1], cuts[1:])]


def _jax(xs, ks, pad, tile_h, dtype):
    jd = _DT[dtype][0]
    fn = jax.jit(lambda xs, ks: jsum(xs, ks, pad=pad, tile_h=tile_h, interpret=True))
    out = fn([jnp.asarray(x).astype(jd) for x in xs], [jnp.asarray(k).astype(jd) for k in ks])
    return [np.asarray(a.astype(jnp.float32)) for a in out]


# (legs, cout, pad, tile_h, dtype): tests/test_pallas_resblock.py's one-leg
# zero case (2×16×24, 8 → 12) and its two-leg cases (1×16×16, 16 + 8 → 24)
# in both pads and both tiles, and a bf16 two-leg case.
_CASES = [
    ((8,), 12, "zero", 4, "f32"),
    ((16, 8), 24, "zero", 8, "f32"),
    ((16, 8), 24, "zero", 16, "f32"),
    ((16, 8), 24, "reflect", 8, "f32"),
    ((16, 8), 24, "reflect", 16, "f32"),
    ((16, 8), 24, "reflect", 16, "bf16"),
]


@pytest.mark.parametrize("legs, cout, pad, tile_h, dtype", _CASES)
def test_sum_fused_matches_jax(legs, cout, pad, tile_h, dtype):
    """f32: out and mean at atol 1e-4, inv at atol 1e-3 / rtol 1e-4 (the
    JAX tests' bounds). bf16: out within 2 bf16 ulps at its largest
    magnitude (both round the f32 sum over the legs once), stats 1e-3. The
    stats are of the f32 sum over the legs before rounding: the port's
    (mean, inv) equal those of the f32 concat conv."""
    b, h, w = (2, 16, 24) if len(legs) == 1 else (1, 16, 16)
    xs, ks = _legs(b, h, w, legs, cout, len(legs) + 2)
    want = _jax(xs, ks, pad, tile_h, dtype)
    td = _DT[dtype][1]
    before = dict(LAUNCHES)
    got = resblock.conv3x3_sum_fused([torch.from_numpy(x).to(td) for x in xs],
                                     [torch.from_numpy(k).to(td) for k in ks],
                                     pad=pad, tile_h=tile_h)
    assert LAUNCHES == before
    assert got[0].dtype == td and got[0].shape == (b, h, w, cout)
    out = got[0].float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(out, want[0], atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-4)
        np.testing.assert_allclose(got[2].numpy(), want[2], atol=1e-3, rtol=1e-4)
    else:
        assert np.abs(out - want[0]).max() <= 2 * 2.0**-8 * np.abs(want[0]).max()
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-3 * np.abs(want[1]).max())
        np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-3)


def test_d2_stage_composition_matches_jax():
    """Composition (a), ``tools/fwdvariants.py``'s d2 stage: kernel 7 (one
    leg, zero halos) and its free IN stats passed to kernel 3 (normalize +
    ReLU + blur-pool), at 2×16×24, 8 → 16; atol 1e-4."""
    xs, ks = _legs(2, 16, 24, (8,), 16, 9)

    @jax.jit
    def jstage(x, k):
        raw, m, inv = jsum([x], [k], pad="zero", tile_h=8, interpret=True)
        return jnrbd(raw, m, inv, interpret=True)

    want = np.asarray(jstage(jnp.asarray(xs[0]), jnp.asarray(ks[0])))
    raw, m, inv = resblock.conv3x3_sum_fused([torch.from_numpy(xs[0])], [torch.from_numpy(ks[0])],
                                             pad="zero", tile_h=8)
    got = blur.norm_relu_blur_down_pallas(raw, m, inv)
    assert got.shape == want.shape == (2, 8, 12, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


# Inputs the JAX function refuses with an assert: an unknown pad, legs of
# unequal planes, a kernel whose C is not its leg's, H not a multiple of
# tile_h, W not 8-aligned.
_REFUSED = {
    "pad": ([(1, 8, 8, 8)], [(3, 3, 8, 8)], "same", 8),
    "planes": ([(1, 8, 8, 8), (1, 8, 16, 8)], [(3, 3, 8, 8)] * 2, "zero", 8),
    "kernel-c": ([(1, 8, 8, 8)], [(3, 3, 4, 8)], "zero", 8),
    "tile-h": ([(1, 12, 8, 8)], [(3, 3, 8, 8)], "zero", 8),
    "width": ([(1, 8, 12, 8)], [(3, 3, 8, 8)], "zero", 8),
}


@pytest.mark.parametrize("case", list(_REFUSED))
def test_sum_fused_refuses_what_jax_refuses(case):
    xshapes, kshapes, pad, tile_h = _REFUSED[case]
    with pytest.raises(AssertionError):
        jsum([jnp.zeros(s) for s in xshapes], [jnp.zeros(s) for s in kshapes], pad=pad,
             tile_h=tile_h, interpret=True)
    with pytest.raises(ValueError):
        resblock.conv3x3_sum_fused([torch.zeros(s) for s in xshapes],
                                   [torch.zeros(s) for s in kshapes], pad=pad, tile_h=tile_h)
