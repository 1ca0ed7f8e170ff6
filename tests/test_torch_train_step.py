"""One train step of the port against one of the JAX package, on the same
G, D and VGG weights and the same float batch, in float32 on the CPU: the
plain route (ngf 8, every fused gate off) and the fused block route (ngf 32,
C = 128: the JAX kernels forced on in interpret mode as tests/test_train.py
forces them, the port's kernel entry points on their plain versions).

What each check holds:
  - the step's G and D gradients, leaf by leaf, against ``jax.grad`` of the
    same losses: relative L2 within 1e-4 (1e-3 on the fused route, whose
    backward rounds dy and Z to the compute grid as the JAX kernels do, but
    sums in another order). Leaves whose reference gradient is below 1e-5
    of the net's largest leaf gradient are left out: the conv biases under
    instance norm, which get a rounding-level gradient on the plain route
    and exact zeros (JAX) or none (port) on the fused one;
  - the 7 loss scalars within 1e-5 relative (1e-4 fused);
  - the update of every other leaf, entry by entry: the port's and JAX's
    within lr/4 on all but 1% of a leaf's entries. Adam's first update is
    about ±lr wherever |gradient| ≫ eps, so a wrong sign, a missing
    gradient, a skipped step or a wrong learning rate moves every entry;
    only entries whose gradient is at rounding level may take the other
    sign. Those few flips are why the losses of a second step are not
    compared: a second batch sees a flipped weight at first order (one
    flipped entry of 1,152 moved the next loss_D by 2.5e-5 relative)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.config import Config as JConfig
from ircolor_tpu.losses.gan import hinge_d_loss, hinge_g_loss
from ircolor_tpu.losses.vgg import VGG16Features as JVGG
from ircolor_tpu.losses.vgg import init_vgg16_params
from ircolor_tpu.models import generator as jgen
from ircolor_tpu.ops import pallas_resblock
from ircolor_tpu.train.state import create_train_state as jcreate
from ircolor_tpu.train.step import composite_g_losses as jcomposite
from ircolor_tpu.train.step import make_train_step as jmake

from ircolor_tpu_torch.compat import (
    discriminator_state_dict_from_flax,
    state_dict_from_flax,
    vgg_state_dict_from_flax,
)
from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.losses.vgg import VGG16Features
from ircolor_tpu_torch.models import generator as tgen
from ircolor_tpu_torch.train.state import create_train_state
from ircolor_tpu_torch.train.step import METRIC_KEYS, make_train_step

_BUFFERS = {"down1_down.filt", "down2_down.filt", "up1_up.filt", "up2_up.filt"}
_LR = 2e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch():
    rng = np.random.RandomState(0)
    return {"ir": rng.rand(2, 32, 32, 1).astype(np.float32) * 2 - 1,
            "rgb": rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1}


def _jax_grads(jcfg, g_mod, d_mod, vgg_params, g_params, d_params, d_params_new, batch):
    """G and D gradients of the step, from the step's own loss functions: D's hinge on [ir⊕rgb ‖ ir⊕G(ir)], G's composite loss against
    the updated D."""
    ir, rgb = jnp.asarray(batch["ir"]), jnp.asarray(batch["rgb"])
    bsz = ir.shape[0]

    def g_apply(gp):
        return g_mod.apply({"params": gp}, ir, train=True)

    def d_loss(dp):
        both = jnp.concatenate([jnp.concatenate([ir, rgb], axis=-1),
                                jnp.concatenate([ir, g_apply(g_params)], axis=-1)])
        pred = d_mod.apply({"params": dp}, both, train=True)
        return hinge_d_loss(pred[:bsz], pred[bsz:])

    def g_loss(gp):
        fake = g_apply(gp)
        pred = d_mod.apply({"params": d_params_new}, jnp.concatenate([ir, fake], axis=-1), train=True)
        return jcomposite(jcfg, JVGG(), vgg_params, fake, rgb, hinge_g_loss(pred))[0]

    both = jax.jit(lambda gp, dp: (jax.grad(g_loss)(gp), jax.grad(d_loss)(dp)))
    return _np(both(g_params, d_params))


def _run_both(kw, g_min_gates=False):
    """One JAX step and one port step from the same weights and batch.
    Returns, for JAX and then the port: (metrics, (G, D) state_dicts before
    the step, after it, and the step's (G, D) gradients)."""
    batch = _batch()
    jcfg = JConfig(**kw, dp_devices=1, batch_transport="float")
    assert jcfg.d_concat
    jstate, g_mod, d_mod, (opt_g, opt_d) = jcreate(jcfg, steps_per_epoch=10)
    if g_min_gates:
        g_mod = g_mod.clone(pallas_block_min_area=0, pallas_block_min_launch=0)
    vgg_params = init_vgg16_params()
    jstep = jmake(jcfg, g_mod, d_mod, JVGG(), opt_g, opt_d, donate=False)
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, vgg_params)
    jgrads = _jax_grads(jcfg, g_mod, d_mod, vgg_params, jstate.g_params, jstate.d_params,
                        jnew.d_params, batch)
    to_sd = (state_dict_from_flax, discriminator_state_dict_from_flax)
    jbefore, jafter, jgrads = (
        tuple(f(_np(t)) for f, t in zip(to_sd, trees))
        for trees in ((jstate.g_params, jstate.d_params), (jnew.g_params, jnew.d_params), jgrads))

    cfg = Config(**kw, batch_transport="float")
    state = create_train_state(cfg, steps_per_epoch=10, device="cpu")
    if g_min_gates:
        for blk in state.g.resblocks:
            blk.pallas_block_min_area = blk.pallas_block_min_launch = 0
    missing, unexpected = state.g.load_state_dict(jbefore[0], strict=False)
    assert set(missing) == _BUFFERS and not unexpected
    state.d.load_state_dict(jbefore[1], strict=True)
    vgg = VGG16Features()
    vgg.load_state_dict(vgg_state_dict_from_flax(_np(vgg_params)), strict=True)
    nets = (state.g, state.d)
    before = tuple({k: v.clone() for k, v in net.state_dict().items()} for net in nets)
    state, tm = make_train_step(cfg, vgg)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == 1
    after = tuple(net.state_dict() for net in nets)
    grads = tuple({k: None if p.grad is None else p.grad for k, p in net.named_parameters()}
                  for net in nets)
    return (jm, jbefore, jafter, jgrads), (tm, before, after, grads)


def _live_leaves(ref):
    """Names of the leaves whose reference gradient is above 1e-5 of the
    net's largest: all but the conv biases under instance norm."""
    norms = {k: float(v.norm()) for k, v in ref.items()}
    floor = 1e-5 * max(norms.values())
    return {k for k, n in norms.items() if n > floor}


def _assert_step_agrees(run, loss_rtol, grad_rtol):
    (jm, jbefore, jafter, jgrads), (tm, before, after, grads) = run
    assert set(tm) == set(METRIC_KEYS) == set(jm)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=loss_rtol, atol=1e-7, err_msg=k)
    n_live = 0
    for net in (0, 1):
        assert set(grads[net]) == set(jgrads[net])
        for key in _live_leaves(jgrads[net]):
            want, got = jgrads[net][key], grads[net][key]
            assert got is not None, key
            rel = float((got - want).norm() / want.norm())
            assert rel <= grad_rtol, (key, rel)
            d_jax = jafter[net][key] - jbefore[net][key]
            d_own = after[net][key] - before[net][key]
            assert float(d_jax.abs().max()) > 0.5 * _LR, key
            off = int(((d_own - d_jax).abs() > 0.25 * _LR).sum())
            assert off <= 0.01 * d_jax.numel(), (key, off, d_jax.numel())
            n_live += 1
    assert n_live >= 10, n_live


def test_f32_step_matches_jax():
    run = _run_both(dict(img_size=32, batch_size=2, n_blocks=1, ngf=8))
    _assert_step_agrees(run, loss_rtol=1e-5, grad_rtol=1e-4)


def test_fused_route_step_matches_jax(monkeypatch):
    """ngf 32 → block width 128 passes the channel gate; both packages take
    the fused block route with the fused_wg backward, counted on both sides."""
    monkeypatch.setattr(jgen, "_pallas_available", lambda: True)
    monkeypatch.setattr(jgen, "_fused_dtype_ok", lambda d: True)
    monkeypatch.setattr(tgen, "_fused_dtype_ok", lambda d: True)
    calls = {"jax": [], "port": []}

    def jax_block(*a, **kw):
        calls["jax"].append(kw.get("bwd"))
        return pallas_resblock.resnet_block_pallas(*a, **kw)

    port_block = tgen.resnet_block_pallas

    def counted(*a, **kw):
        calls["port"].append(kw.get("bwd"))
        return port_block(*a, **kw)

    monkeypatch.setattr(jgen, "resnet_block_pallas", functools.partial(jax_block, interpret=True))
    monkeypatch.setattr(tgen, "resnet_block_pallas", counted)
    kw = dict(img_size=32, batch_size=2, n_blocks=1, ngf=32, pallas_block=True,
              pallas_block_train=True, pallas_block_bwd="fused_wg")
    run = _run_both(kw, g_min_gates=True)
    assert calls["jax"] and set(calls["jax"]) == {"fused_wg"}
    assert calls["port"] == ["fused_wg"]  # one block, one G forward per step
    _assert_step_agrees(run, loss_rtol=1e-4, grad_rtol=1e-3)


@pytest.mark.parametrize("update_d", [True, False])
def test_update_d_knob(update_d):
    """``update_d=False`` skips the D phase as the JAX step does: loss_D is 0,
    D's parameters and optimizer are untouched, G still steps."""
    cfg = Config(img_size=32, batch_size=2, n_blocks=1, ngf=8, lambda_perc=0.0,
                 batch_transport="float")
    state = create_train_state(cfg, steps_per_epoch=10, device="cpu")
    d0 = {k: v.clone() for k, v in state.d.state_dict().items()}
    g0 = {k: v.clone() for k, v in state.g.state_dict().items()}
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    state, m = make_train_step(cfg, None, update_d=update_d)(state, batch)
    d_moved = any(not torch.equal(v, state.d.state_dict()[k]) for k, v in d0.items())
    g_moved = any(not torch.equal(v, state.g.state_dict()[k]) for k, v in g0.items())
    assert g_moved and d_moved == update_d
    assert (float(m["loss_D"]) == 0.0) != update_d
    assert bool(state.opt_d.state) == update_d
