"""The int8 head (kernel 4q) and the backward of the fused tail and head.

On the CPU the port's wrappers run their plain versions; the JAX kernels
run in interpret mode, as their own tests run them. Inputs are made with
numpy from a seed and fed to both, in float32. The backward of
``norm_relu_blur_down`` and ``outc_head`` is the JAX package's
hand-assembled one (its ``custom_vjp``), held against ``jax.vjp`` of the JAX
functions; it must not depend on the forward's autograd graph, because the
forward's kernel launch returns a tensor without one.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import vjp

from ircolor_tpu.ops import pallas_blur, pallas_head
from ircolor_tpu.ops.norm import instance_norm_stats as jax_in_stats

from ircolor_tpu_torch.kernels import LAUNCHES, blur, head
from ircolor_tpu_torch.models import generator as tgen
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _jax_vjp(fn, primals, cot):
    """``jax.vjp`` of ``fn`` at ``primals``, applied to ``cot``: traced once
    under ``jax.jit`` (eager interpret mode dispatches every op of every
    grid step)."""
    def pullback(primals, cot):
        return vjp(fn, *primals)[1](cot)

    return jax.jit(pullback)(tuple(jnp.asarray(p) for p in primals), jnp.asarray(cot))


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


# --- 4q: conv7x7_head_pallas(quant=True) ------------------------------------


@pytest.mark.parametrize(
    "shape,tile_h",
    [((2, 16, 64, 8), 8), ((1, 8, 32, 8), 8), ((1, 32, 96, 4), 8), ((1, 16, 80, 8), 8)],
)
def test_conv7x7_head_q_matches_jax(shape, tile_h):
    """The shapes and bound of tests/test_pallas_head.py's int8 head test:
    the integer sums are exact on both sides; the dequantization is the
    same single multiply."""
    rng = np.random.RandomState(sum(shape) + 1)
    c = shape[-1]
    x = (rng.rand(*shape) * 2 - 1).astype(np.float32)
    k = (rng.rand(7, 7, c, 3) * 0.2 - 0.1).astype(np.float32)
    m, inv = (np.asarray(a) for a in jax_in_stats(jnp.asarray(x)))
    want = pallas_head.conv7x7_head_pallas(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(inv), jnp.asarray(k),
        tile_h=tile_h, quant=True, interpret=True,
    )
    got = head.conv7x7_head_pallas(t(x), t(m), t(inv), t(k), quant=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_outc_head_q_matches_jax():
    rng = np.random.RandomState(5)
    x = (rng.rand(2, 16, 64, 8) * 2 - 1).astype(np.float32)
    k = (rng.rand(7, 7, 8, 3) * 0.2 - 0.1).astype(np.float32)
    want = pallas_head.outc_head_q(jnp.asarray(x), jnp.asarray(k), interpret=True)
    before = dict(LAUNCHES)
    got = head.outc_head_q(t(x), t(k))
    assert LAUNCHES == before  # a CPU tensor runs the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# --- the backward of the fused tail (3) and head (4) ------------------------


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 32, 40, 16)])
def test_norm_relu_blur_down_grad_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(shape[0], shape[1] // 2, shape[2] // 2, shape[3]).astype(np.float32)
    (want,) = _jax_vjp(functools.partial(pallas_blur.norm_relu_blur_down, interpret=True),
                       (x,), g)
    xt = t(x).requires_grad_()
    (got,) = torch.autograd.grad(blur.norm_relu_blur_down(xt), xt, t(g))
    assert _rel_l2(got.numpy(), want) <= 1e-4


def test_outc_head_grad_matches_jax():
    rng = np.random.RandomState(6)
    x = (rng.rand(2, 16, 64, 8) * 2 - 1).astype(np.float32)
    k = (rng.rand(7, 7, 8, 3) * 0.2 - 0.1).astype(np.float32)
    g = rng.randn(2, 16, 64, 3).astype(np.float32)
    want_x, want_k = _jax_vjp(functools.partial(pallas_head.outc_head, interpret=True), (x, k), g)
    xt, kt = t(x).requires_grad_(), t(k).requires_grad_()
    got_x, got_k = torch.autograd.grad(head.outc_head(xt, kt), (xt, kt), t(g))
    assert _rel_l2(got_x.numpy(), want_x) <= 1e-4
    assert _rel_l2(got_k.numpy(), want_k) <= 1e-4


def test_fused_tail_and_head_train_without_forward_graph(monkeypatch):
    """The generator's training forward with the fused tails and head on
    (``pallas_norm_blur_train`` / ``pallas_head_train``), once on the plain
    versions and once with each forward swapped for a detached copy of the
    plain result, as a kernel launch returns it: every parameter still gets
    its gradient, bit for bit the same."""
    monkeypatch.setattr(tgen, "_fused_dtype_ok", lambda d: True)
    g = tgen.ResnetUNetGenerator(ngf=64, n_blocks=1, pallas_norm_blur=True, pallas_head=True)
    g.init_weights("normal", 0.02, torch.Generator().manual_seed(0))
    x = t(np.random.RandomState(9).uniform(-1, 1, (1, 16, 64, 1)))
    cot = t(np.random.RandomState(10).randn(1, 16, 64, 3))
    params = list(g.parameters())

    def grads():
        return torch.autograd.grad(g(x), params, cot, allow_unused=True)

    want = grads()
    calls = []

    def detached(fn):
        def run(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw).detach()
        return run

    monkeypatch.setattr(blur, "norm_relu_blur_down_pallas", detached(blur.norm_relu_blur_down_plain))
    monkeypatch.setattr(head, "conv7x7_head_pallas", detached(head.conv7x7_head_plain))
    got = grads()
    assert sorted(calls) == ["conv7x7_head_plain", "norm_relu_blur_down_plain",
                             "norm_relu_blur_down_plain"]
    for (name, _), a, b in zip(g.named_parameters(), got, want):
        assert a is not None and bool(torch.isfinite(a).all()), name
        assert torch.equal(a, b), name
