"""The port's fused instance norm (kernel 11) against the JAX package's, on
the CPU: the JAX Pallas kernel in interpret mode, the port's entry points on
their plain versions (CPU tensors), on the same numpy inputs; the gate
``pallas_fits``; and the ``use_pallas`` generator on shared weights."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.models import generator as jgen
from ircolor_tpu.ops import pallas_kernels as jk

from ircolor_tpu_torch.compat import state_dict_from_flax
from ircolor_tpu_torch.kernels import LAUNCHES
from ircolor_tpu_torch.kernels import instance_norm as tin
from ircolor_tpu_torch.models import generator as tgen
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift).astype(np.float32)


def _both(a, dtype):
    jd, td = _DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _assert_close(got: torch.Tensor, want, dtype: str) -> None:
    """f32: atol 1e-5 (the JAX test's bound). bf16: within one bf16 ulp of
    the JAX value, element by element: both round f32 results that differ
    by the order of the sums. Where x ≈ mean the value is f32 rounding noise
    around 0 (~1e-7), so the bound is at least 1e-6."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(g, w, atol=1e-5)
        return
    ulp = np.maximum(2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0**-126))) - 7), 1e-6)
    assert np.all(np.abs(g - w) <= ulp), float(np.max(np.abs(g - w) / ulp))


# (2, 16, 20, 128): the JAX tests' shape (cb = 128); (2, 12, 10, 40): cb = C
# (C not a multiple of 128); (1, 8, 10, 256): two channel blocks.
_SHAPES = [(2, 16, 20, 128), (2, 12, 10, 40), (1, 8, 10, 256)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("form", ["in", "in_relu", "residual"])
def test_plain_matches_jax_kernel(form, shape, dtype):
    jx, tx = _both(_rand(shape, 1, 3.0, 1.0), dtype)
    jr, tr = _both(_rand(shape, 2), dtype)
    before = dict(LAUNCHES)
    if form == "residual":
        want = jk.fused_instance_norm_residual(jx, jr, True)
        got = tin.fused_instance_norm_residual(tx, tr)
    else:
        want = jk.fused_instance_norm(jx, form == "in_relu", True)
        got = tin.fused_instance_norm(tx, form == "in_relu")
    assert LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("form", ["in_relu", "residual"])
def test_gradients_match_jax(form):
    """The backward (the JAX _fin_bwd / _finr_bwd math) against jax.grad of
    the JAX custom_vjp, atol 1e-4 (tests/test_pallas.py's bound)."""
    x, r = _rand((1, 12, 14, 128), 6), _rand((1, 12, 14, 128), 7)
    cot = _rand((1, 12, 14, 128), 8)
    if form == "residual":
        def jloss(a, b):
            return jnp.sum(jk.fused_instance_norm_residual(a, b, True) * cot)

        want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(r))
        tx, t_r = (torch.from_numpy(a).requires_grad_() for a in (x, r))
        (tin.fused_instance_norm_residual(tx, t_r) * torch.from_numpy(cot)).sum().backward()
        got = (tx.grad, t_r.grad)
    else:
        want = (jax.grad(lambda a: jnp.sum(jk.fused_instance_norm(a, True, True) * cot))(
            jnp.asarray(x)),)
        tx = torch.from_numpy(x).requires_grad_()
        (tin.fused_instance_norm(tx, True) * torch.from_numpy(cot)).sum().backward()
        got = (tx.grad,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_pallas_fits_equals_jax():
    """The gate on a table of shapes: both 256² bottlenecks (bf16 fits with
    and without a residual; f32 only without), the 512×640 bottleneck, the
    256² enc/dec planes, cb = C cases and a non-4-D shape."""
    shapes = [
        (16, 64, 64, 256), (8, 64, 64, 256), (16, 128, 160, 256), (8, 128, 128, 256),
        (16, 256, 256, 64), (16, 128, 128, 128), (2, 12, 10, 40), (1, 256, 256, 16),
        (1, 200, 200, 96), (1, 64, 64),
    ]
    for shape in shapes:
        for jd, td in _DTYPES.values():
            for res in (False, True):
                assert tin.pallas_fits(shape, td, res) == jk.pallas_fits(shape, jd, res), (
                    shape, td, res)
    assert tin.pallas_fits((16, 64, 64, 256), torch.bfloat16, True)
    assert tin.pallas_fits((16, 64, 64, 256), torch.float32, False)
    assert not tin.pallas_fits((16, 64, 64, 256), torch.float32, True)
    assert not tin.pallas_fits((16, 128, 160, 256), torch.bfloat16, False)


def test_auto_dispatch_and_gate_errors():
    """instance_norm_auto takes the plain two-pass ops where the gate says
    no, as the JAX function does; the fused entry points refuse such a
    shape."""
    x = _rand((1, 96, 96, 128), 9)  # f32 planes over the budget
    r = _rand((1, 96, 96, 128), 10)
    assert not jk.pallas_fits(x.shape, jnp.float32, True)
    want = jk.instance_norm_auto(jnp.asarray(x), residual=jnp.asarray(r), use_pallas=True,
                                 interpret=True)
    got = tin.instance_norm_auto(torch.from_numpy(x), residual=torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="gate"):
        tin.fused_instance_norm(torch.from_numpy(x))
    with pytest.raises(ValueError, match="gate"):
        tin.run_in_res(torch.from_numpy(x), torch.from_numpy(r))


def test_use_pallas_generator_matches_jax(monkeypatch):
    """ngf 32, 2 blocks, f32 at 32×32: every instance norm of both
    generators goes through kernel 11 (JAX: interpret mode, behind a
    patched ``_pallas_available``; port: the plain versions), ≤ 2e-5."""
    monkeypatch.setattr(jgen, "_pallas_available", lambda: True)
    monkeypatch.setattr(jgen, "instance_norm_auto",
                        functools.partial(jk.instance_norm_auto, interpret=True))
    calls = {"relu": 0, "residual": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(tin, "fused_instance_norm", counted("relu", tin.fused_instance_norm))
    monkeypatch.setattr(tin, "fused_instance_norm_residual",
                        counted("residual", tin.fused_instance_norm_residual))
    hw, n_blocks = (32, 32), 2
    jm = jgen.ResnetUNetGenerator(ngf=32, n_blocks=n_blocks, use_pallas=True)
    x = np.random.RandomState(3).uniform(-1, 1, (2, *hw, 1)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    g = tgen.ResnetUNetGenerator(ngf=32, n_blocks=n_blocks, use_pallas=True)
    g.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)), strict=False)
    with torch.inference_mode():
        got = g.eval()(torch.from_numpy(x)).numpy()
    # inc, down1, down2, up1, up2 and the first half of each block; the
    # second half of each block with its residual.
    assert calls == {"relu": 5 + n_blocks, "residual": n_blocks}
    np.testing.assert_allclose(got, want, atol=2e-5)
