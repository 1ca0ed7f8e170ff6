"""Spatial training (``sp_devices`` > 1) of the generator's variants on the
CPU, every shard a CPU tensor, at ``tests/test_parallel.py``'s configuration
(img 32, b4, ngf 8, one block, float32, every loss term on), with the
one-step bounds of ``tests/test_torch_sp_train_step.py``: the losses within
1e-5 relative, every live leaf's gradient within 1e-4 relative L2, the
first Adam update within lr/4 on all but 1% of each leaf's entries, and
the batch norms' running statistics within 1e-5 relative (the mean vector
by its L2 norm: a channel's mean is near 0).

  - The port's step on 4 H-shards against JAX's GSPMD step on a ``('data',
    'sp')`` = (1, 4) mesh of the fake CPU devices (one JAX step and one
    gradient trace a configuration) for batch norm + ``no_antialias`` +
    ``no_antialias_up``, no norm, and ``use_pallas`` (JAX: kernel 11 in
    interpret mode behind a patched ``_pallas_available``; the port: row
    11h's plain versions and its backward). Without batch norm the G phase
    is JAX's on the port's D' (``tests/test_torch_sp_train_step.py``'s
    rule). Under batch norm D's learning rate is 0, as in
    ``tests/test_torch_variants.py``'s batch-norm step: the G phase's D
    forward moves D's statistics a third time, from D', and Adam's first
    step moves D's rounding-level gradient entries by ±lr either way.
  - Dropout (module API only): the sharded step against the unsharded
    step, the blocks' masks from one seeded ``dropout_generator``.
  - Batch norm over 2 gloo ranks × 2 H-shards against one process's
    4-image step (the shard sums added, then all-reduced over the ranks).
"""

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
from ircolor_tpu.ops import pallas_kernels as jk
from ircolor_tpu.parallel.mesh import make_train_mesh as jmake_train_mesh
from ircolor_tpu.parallel.mesh import replicated_sharding
from ircolor_tpu.parallel.mesh import shard_batch as jshard_batch
from ircolor_tpu.train.step import composite_g_losses as jcomposite
from ircolor_tpu.train.step import make_train_step as jmake

from ircolor_tpu_torch.compat import (
    discriminator_state_dict_from_flax,
    state_dict_from_flax,
    vgg_state_dict_from_flax,
)
from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.kernels import instance_norm as tin
from ircolor_tpu_torch.losses.vgg import VGG16Features, load_vgg16
from ircolor_tpu_torch.models.generator import ResnetUNetGenerator
from ircolor_tpu_torch.parallel.launch import spawn
from ircolor_tpu_torch.parallel.mesh import shard_batch
from ircolor_tpu_torch.tools.dp_steps import one_process_steps, run_rank
from ircolor_tpu_torch.train.state import TrainState, create_train_state
from ircolor_tpu_torch.train.step import METRIC_KEYS, make_train_step
from test_torch_dp_step import _flax_discriminator
from test_torch_sp_train_step import _flat, _jax_reference, _np, make_batch
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_train_step import _jcreate, _live_leaves

_LR = 2e-4
_S = 4
_KW = dict(img_size=32, batch_size=4, n_blocks=1, ngf=8, batch_transport="float")
_CPU = torch.device("cpu")
CONFIGS = {
    "batch_no_aa_both": dict(norm="batch", no_antialias=True, no_antialias_up=True, lr_D=0.0),
    "none": dict(norm="none"),
    "use_pallas": dict(use_pallas=True),
}
_RUNS: dict = {}


def _port_step(cfg, weights, vgg_sd, batch, place, g=None):
    """One port step from ``weights`` (G's and D's whole state_dicts) on
    ``batch`` put at ``place``; ``g`` replaces the state's generator (its
    own Adam). Losses, parameters and buffers before and after, gradients."""
    state = create_train_state(cfg, steps_per_epoch=10, device="cpu")
    if g is not None:
        g.spatial_mesh = state.g.spatial_mesh
        opt = torch.optim.Adam(g.parameters(), lr=state.sched_g(0), betas=(cfg.beta1, cfg.beta2),
                               eps=1e-8)
        state = TrainState(g=g.train(), d=state.d, opt_g=opt, opt_d=state.opt_d,
                           sched_g=state.sched_g, sched_d=state.sched_d)
    missing, unexpected = state.g.load_state_dict(weights["g"], strict=False)
    assert all(k.endswith(".filt") for k in missing) and not unexpected
    state.d.load_state_dict(weights["d"], strict=True)
    vgg = VGG16Features()
    vgg.load_state_dict(vgg_sd, strict=True)
    nets = {"g": state.g, "d": state.d}
    before = _flat(*({k: v.clone() for k, v in nets[n].state_dict().items()} for n in "gd"))
    state, m = make_train_step(cfg, vgg)(state, shard_batch(batch, place))
    grads = {f"{n}.{k}": None if p.grad is None else p.grad.numpy().copy()
             for n in "gd" for k, p in nets[n].named_parameters()}
    after = _flat(state.g.state_dict(), state.d.state_dict())
    return {"losses": {k: float(v) for k, v in m.items()}, "before": before, "after": after,
            "grads": grads}


def _jax_bn_reference(jcfg, g_mod, d_mod):
    """The batch-norm step's ``(G, D, stats, VGG, ir, rgb) → (dG, dD, G-phase
    losses)``, jitted: D's hinge on D(ir⊕rgb), then D(ir⊕G(ir)), G's
    composite loss against D (lr_D = 0: D' is D); train-mode batch
    statistics throughout, so the running ones do not enter."""

    def run(gp, dp, g_stats, d_stats, vggp, ir, rgb):
        def g_apply(g):
            return g_mod.apply({"params": g, "batch_stats": g_stats}, ir, train=True,
                               mutable=["batch_stats"])[0]

        def d_apply(d, x):
            return d_mod.apply({"params": d, "batch_stats": d_stats}, x, train=True,
                               mutable=["batch_stats"])[0]

        def d_loss(d):
            fake = g_apply(gp)
            return hinge_d_loss(d_apply(d, jnp.concatenate([ir, rgb], -1)),
                                d_apply(d, jnp.concatenate([ir, fake], -1)))

        def g_loss(g):
            fake = g_apply(g)
            pred = d_apply(dp, jnp.concatenate([ir, fake], -1))
            return jcomposite(jcfg, JVGG(), vggp, fake, rgb, hinge_g_loss(pred))

        g_grads, aux = jax.grad(g_loss, has_aux=True)(gp)
        return g_grads, jax.grad(d_loss)(dp), aux

    return jax.jit(run)


def _run(name: str):
    """JAX's GSPMD step on the (1, 4) mesh and its gradients, and the
    port's step on 4 shards, from JAX's initial state, for one config."""
    if name in _RUNS:
        return _RUNS[name]
    kw = CONFIGS[name]
    bn = kw.get("norm") == "batch"
    batch = make_batch()
    with pytest.MonkeyPatch.context() as mp:
        if kw.get("use_pallas"):
            mp.setattr(jgen, "_pallas_available", lambda: True)
            mp.setattr(jgen, "instance_norm_auto",
                       functools.partial(jk.instance_norm_auto, interpret=True))
        jcfg = JConfig(**_KW, **kw, sp_devices=_S, dp_devices=1)
        jstate, g_mod, d_mod, (opt_g, opt_d) = _jcreate(jcfg)
        vgg_params = jax.jit(init_vgg16_params)()
        g0, d0 = _np(jstate.g_params), _np(jstate.d_params)
        gs0, ds0 = (_np(jstate.g_stats), _np(jstate.d_stats)) if bn else (None, None)
        pad = dict(pad_type="reflect", use_dropout=False)
        weights = {"g": state_dict_from_flax(g0, gs0, **pad),
                   "d": discriminator_state_dict_from_flax(d0, ds0)}
        vgg_sd = vgg_state_dict_from_flax(_np(vgg_params))
        cfg = Config(**_KW, **kw, sp_devices=_S)
        calls = []
        real = tin._run_in_spatial
        mp.setattr(tin, "_run_in_spatial", lambda *a: calls.append(1) or real(*a))
        sp = _port_step(cfg, weights, vgg_sd, batch, [_CPU] * _S)

        mesh = jmake_train_mesh(1, _S, batch_size=4)
        repl = replicated_sharding(mesh)
        sharded = jshard_batch(dict(batch), mesh)
        jstep = jmake(jcfg, g_mod, d_mod, JVGG(), opt_g, opt_d, donate=False)
        jnew, jm = jstep(jax.device_put(jstate, repl), sharded, jax.device_put(vgg_params, repl))
        if bn:
            ref = _jax_bn_reference(jcfg, g_mod, d_mod)
            args = (g0, d0, gs0, ds0, vgg_params)
        else:
            d_new = _flax_discriminator(
                {k: sp["after"][k] for k in sp["after"] if k.startswith("d.")}, d0)
            ref = _jax_reference(jcfg, g_mod, d_mod)
            args = (g0, d0, d_new, vgg_params)
        g_grads, d_grads, g_phase = _np(ref(*jax.device_put(args, repl), sharded["ir"],
                                            sharded["rgb"]))
    after = _flat(state_dict_from_flax(_np(jnew.g_params), _np(jnew.g_stats) if bn else None,
                                       **pad),
                  discriminator_state_dict_from_flax(_np(jnew.d_params),
                                                     _np(jnew.d_stats) if bn else None))
    _RUNS[name] = {
        "port": sp, "calls": len(calls),
        "jax": {"losses": {"loss_D": float(jm["loss_D"]),
                           **{k: float(v) for k, v in g_phase.items()}},
                "after": after,
                "grads": _flat(state_dict_from_flax(g_grads),
                               discriminator_state_dict_from_flax(d_grads))},
    }
    return _RUNS[name]


def _assert_agrees(got, want_losses, want_after, want_grads, d_lr=True):
    """The one-step bounds (module docstring); with ``d_lr`` False D's
    leaves are held by their gradients alone (its update is 0)."""
    for k in METRIC_KEYS:
        np.testing.assert_allclose(got["losses"][k], want_losses[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    n_live = 0
    for tag in ("g.", "d."):
        ref = {k: torch.from_numpy(v) for k, v in want_grads.items()
               if k.startswith(tag) and v is not None and k in got["grads"]}
        for key in _live_leaves(ref):
            g = got["grads"][key]
            assert g is not None, key
            rel = np.linalg.norm(g - want_grads[key]) / np.linalg.norm(want_grads[key])
            assert rel <= 1e-4, (key, rel)
            n_live += 1
            d_want = want_after[key] - got["before"][key]
            d_got = got["after"][key] - got["before"][key]
            if tag == "d." and not d_lr:
                assert not np.abs(d_got).any() and not np.abs(d_want).any(), key
                continue
            assert np.abs(d_want).max() > 0.5 * _LR, key
            off = int((np.abs(d_got - d_want) > 0.25 * _LR).sum())
            assert off <= 0.01 * d_want.size, (key, off, d_want.size)
    assert n_live >= 8, n_live


def _assert_stats(got_after, want_after, n_expected):
    n = 0
    for k, want in want_after.items():
        if k.endswith("running_var"):
            np.testing.assert_allclose(got_after[k], want, rtol=1e-5, err_msg=k)
            n += 1
        elif k.endswith("running_mean"):
            assert np.linalg.norm(got_after[k] - want) <= 1e-5 * np.linalg.norm(want), k
            n += 1
    assert n == n_expected, n


@pytest.mark.parametrize("name", list(CONFIGS))
def test_variant_spatial_step_matches_jax_gspmd(name, eight_cpu_devices):
    run = _run(name)
    bn = CONFIGS[name].get("norm") == "batch"
    want = run["jax"]
    _assert_agrees(run["port"], want["losses"], want["after"], want["grads"], d_lr=not bn)
    if bn:  # G: 5 stage norms + the block's 2; D: 3. Mean and variance each.
        _assert_stats(run["port"]["after"], want["after"], 2 * (7 + 3))
        assert int(run["port"]["after"]["g.inc.2.num_batches_tracked"]) == 2
        assert int(run["port"]["after"]["d.model.3.num_batches_tracked"]) == 3
    # use_pallas: every IN of G through row 11h, forward and backward: 5
    # stages + the block's 2 in the G forward of the step.
    assert run["calls"] == (7 if name == "use_pallas" else 0)


def test_dropout_spatial_step_matches_unsharded():
    """One train step of a dropout generator (module API) on 4 shards and
    unsharded, the blocks' masks drawn from one seeded generator each time:
    the same values dropped, the one-step bounds."""
    cfg = Config(**_KW)
    ref = create_train_state(cfg, steps_per_epoch=10, device="cpu")
    weights = {"g": ref.g.state_dict(), "d": ref.d.state_dict()}
    vgg_sd = load_vgg16(None, 0).state_dict()
    runs = []
    for s in (_S, 1):
        g = ResnetUNetGenerator(ngf=8, n_blocks=1, use_dropout=True)
        for blk in g.resblocks:
            blk.dropout_generator = torch.Generator().manual_seed(11)
        kept = []
        real = g.resblocks[0]._dropout
        g.resblocks[0]._dropout = lambda hs, real=real: kept.append(
            [h.clone() for h in real(hs)]) or kept[-1]
        sd = {k.replace("conv_block.5", "conv_block.6"): v for k, v in weights["g"].items()}
        run = _port_step(cfg.replace(sp_devices=s), {"g": sd, "d": weights["d"]}, vgg_sd,
                         make_batch(), [_CPU] * s if s > 1 else _CPU, g=g)
        run["kept"] = torch.cat(kept[0], dim=1)
        runs.append(run)
    sp, one = runs
    assert float((one["kept"] == 0).float().mean()) > 0.4
    assert torch.equal(sp["kept"] == 0, one["kept"] == 0)
    _assert_agrees(sp, one["losses"], one["after"], one["grads"])


def test_batch_norm_two_ranks_of_two_shards_match_one_process():
    """Batch norm + no_antialias + no_antialias_up over 2 gloo ranks × 2
    H-shards (each rank's 2 images) against one process's unsharded 4-image
    step from the same seeded weights: the losses, G's and D's gradients,
    G's update (lr_D = 0) and every running statistic; the ranks' replicas
    equal bit for bit."""
    kw = dict(_KW, **CONFIGS["batch_no_aa_both"])
    batches = [make_batch(seed=1)]
    cfg = Config(**kw, dp_devices=2, sp_devices=2)
    ranks = spawn(run_rank, [_CPU, _CPU], (cfg, batches), timeout_s=150)
    one = one_process_steps(Config(**kw), _CPU, batches)
    assert [o["equal"] for o in ranks] == [[True]] * 2
    first = ranks[0]["first"]
    got = {"losses": ranks[0]["losses"][0], "before": one["before"],
           "after": {**first["params"], **first["buffers"]}, "grads": first["grads"]}
    want_after = {**one["first"]["params"], **one["first"]["buffers"]}
    _assert_agrees(got, one["losses"][0], want_after, one["first"]["grads"], d_lr=False)
    _assert_stats(got["after"], want_after, 2 * (7 + 3))
