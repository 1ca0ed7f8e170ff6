"""Spatial training's step (``sp_devices`` > 1) on the CPU: the port's
train step on 4 H-shards (every shard a CPU tensor) against JAX's GSPMD
step on a ``('data', 'sp')`` = (1, 4) mesh of the fake CPU devices, and
against the port's own unsharded step, from the same G, D and VGG weights
(crossed through ``ircolor_tpu_torch.compat``), in float32 at
``tests/test_parallel.py``'s configuration (img 32, b4, ngf 8, one block,
``make_batch(4, seed=7)``, every loss term on). The bounds are
``tests/test_torch_train_step.py``'s: the 7 losses within 1e-5 relative,
every live leaf's gradient within 1e-4 relative L2 (the conv biases under
instance norm left out by ``_live_leaves``), the first Adam update within
lr/4 on all but 1% of each leaf's entries.

Against JAX the G phase (its losses and G's gradient) is JAX's G phase,
under the same mesh, on the D' the port's step produced, as
``tests/test_torch_dp_step.py`` holds it: D's rounding-level gradient
entries may step either way in the two packages, and the G phase reads D'
at first order. At 40×32 the generator's shards are 10 rows, 5 after
down1 and 3/2/3/2 at the bottleneck, D's score map 3 rows on shards of
2/1/0/0 and the VGG tower's second pool takes windows across the seams:
held against the unsharded step, on seed 5's batch. Seed 3's puts an input
of the VGG tower within rounding of a kink (a max-pool tie or a ReLU at
0): the G forward's last-bit differences on shards move the perceptual
term's gradient of G's encoder weights by 2.3e-4 relative there (1.4e-6
without that term), while the tower's shard form on one and the same input
stays within 9.2e-7 of the unsharded tower in float32 and 5.5e-16 in
float64 (``tests/test_torch_sp_train_forms.py`` holds it so). The validation step on shards sums each
sample's L1 over the shards, held with a padded mask."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.config import Config as JConfig
from ircolor_tpu.losses.gan import hinge_d_loss, hinge_g_loss
from ircolor_tpu.losses.vgg import VGG16Features as JVGG
from ircolor_tpu.losses.vgg import init_vgg16_params
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
from ircolor_tpu_torch.losses.vgg import VGG16Features
from ircolor_tpu_torch.parallel.mesh import shard_batch
from ircolor_tpu_torch.parallel.spatial import check_stage_heights, window_heights
from ircolor_tpu_torch.train.state import create_train_state
from ircolor_tpu_torch.train.step import METRIC_KEYS, make_train_step, make_val_sum_step
from test_torch_dp_step import _flax_discriminator
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_train_step import _BUFFERS, _jcreate, _live_leaves

_LR = 2e-4
_S = 4
_KW = dict(img_size=32, batch_size=4, n_blocks=1, ngf=8, batch_transport="float")
_CPU = torch.device("cpu")


def make_batch(n=4, h=32, w=32, seed=7):
    """``tests/test_parallel.py``'s batch."""
    rng = np.random.RandomState(seed)
    return {"ir": rng.rand(n, h, w, 1).astype(np.float32) * 2 - 1,
            "rgb": rng.rand(n, h, w, 3).astype(np.float32) * 2 - 1}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(g_sd, d_sd):
    out = {f"g.{k}": np.asarray(v, np.float32) for k, v in g_sd.items()}
    out.update({f"d.{k}": np.asarray(v, np.float32) for k, v in d_sd.items()})
    return out


def _port_step(cfg, weights, vgg_sd, batch, place):
    """One port step from ``weights`` on ``batch`` put at ``place`` (the
    CPU, or its shard devices): losses, parameters before and after, the
    step's gradients, and the state."""
    state = create_train_state(cfg, steps_per_epoch=10, device="cpu")
    missing, unexpected = state.g.load_state_dict(weights["g"], strict=False)
    assert set(missing) == _BUFFERS and not unexpected
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
            "grads": grads, "state": state}


def _jax_reference(jcfg, g_mod, d_mod):
    """``(G, D, D', VGG, ir, rgb) → (dG, dD, G-phase losses)``, jitted: D's
    hinge on [ir⊕rgb ‖ ir⊕G(ir)] at D, G's composite loss against D'."""

    def run(gp, dp, dp_new, vggp, ir, rgb):
        bsz = ir.shape[0]
        fake = g_mod.apply({"params": gp}, ir, train=True)

        def d_loss(d):
            both = jnp.concatenate([jnp.concatenate([ir, rgb], axis=-1),
                                    jnp.concatenate([ir, fake], axis=-1)])
            pred = d_mod.apply({"params": d}, both, train=True)
            return hinge_d_loss(pred[:bsz], pred[bsz:])

        def g_loss(g):
            out = g_mod.apply({"params": g}, ir, train=True)
            pred = d_mod.apply({"params": dp_new}, jnp.concatenate([ir, out], axis=-1),
                               train=True)
            return jcomposite(jcfg, JVGG(), vggp, out, rgb, hinge_g_loss(pred))

        g_grads, aux = jax.grad(g_loss, has_aux=True)(gp)
        return g_grads, jax.grad(d_loss)(dp), aux

    return jax.jit(run)


@pytest.fixture(scope="module")
def runs(eight_cpu_devices):
    """JAX's GSPMD step on the (1, 4) mesh and its gradients (the G phase
    on the port's D'); the port's spatial and unsharded steps from JAX's
    initial weights, at 32×32 and 40×32."""
    batch = make_batch()
    jcfg = JConfig(**_KW, sp_devices=_S, dp_devices=1)
    jstate, g_mod, d_mod, (opt_g, opt_d) = _jcreate(jcfg)
    vgg_params = jax.jit(init_vgg16_params)()
    g0, d0 = _np(jstate.g_params), _np(jstate.d_params)
    weights = {"g": state_dict_from_flax(g0), "d": discriminator_state_dict_from_flax(d0)}
    vgg_sd = vgg_state_dict_from_flax(_np(vgg_params))

    cfg = Config(**_KW, sp_devices=_S)
    sp = _port_step(cfg, weights, vgg_sd, batch, [_CPU] * _S)
    one = _port_step(cfg.replace(sp_devices=1), weights, vgg_sd, batch, _CPU)

    mesh = jmake_train_mesh(1, _S, batch_size=4)
    assert mesh.shape == {"data": 1, "sp": _S}
    repl = replicated_sharding(mesh)
    sharded = jshard_batch(dict(batch), mesh)
    jstep = jmake(jcfg, g_mod, d_mod, JVGG(), opt_g, opt_d, donate=False)
    jnew, jm = jstep(jax.device_put(jstate, repl), sharded, jax.device_put(vgg_params, repl))
    d_new = _flax_discriminator({k: sp["after"][k] for k in sp["after"] if k.startswith("d.")},
                                d0)
    ref = _jax_reference(jcfg, g_mod, d_mod)
    g_grads, d_grads, g_phase = _np(ref(*jax.device_put((g0, d0, d_new, vgg_params), repl),
                                        sharded["ir"], sharded["rgb"]))
    jax_run = {
        "losses": {"loss_D": float(jm["loss_D"]), **{k: float(v) for k, v in g_phase.items()}},
        "after": _flat(state_dict_from_flax(_np(jnew.g_params)),
                       discriminator_state_dict_from_flax(_np(jnew.d_params))),
        "grads": _flat(state_dict_from_flax(g_grads), discriminator_state_dict_from_flax(d_grads)),
    }

    batch40 = make_batch(h=40, seed=5)
    cfg40 = cfg.replace(img_size=None, img_height=40, img_width=32)
    sp40 = _port_step(cfg40, weights, vgg_sd, batch40, [_CPU] * _S)
    one40 = _port_step(cfg40.replace(sp_devices=1), weights, vgg_sd, batch40, _CPU)
    return {"jax": jax_run, "sp": sp, "one": one, "sp40": sp40, "one40": one40,
            "batch": batch, "batch40": batch40}


def _assert_agrees(got, want_losses, want_after, want_grads):
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
            d_want = want_after[key] - got["before"][key]
            d_got = got["after"][key] - got["before"][key]
            assert np.abs(d_want).max() > 0.5 * _LR, key
            off = int((np.abs(d_got - d_want) > 0.25 * _LR).sum())
            assert off <= 0.01 * d_want.size, (key, off, d_want.size)
            n_live += 1
    assert n_live >= 10, n_live


def test_spatial_step_matches_jax_gspmd(runs):
    """The port's step on 4 H-shards against JAX's GSPMD step on the
    ('data', 'sp') = (1, 4) mesh."""
    jax_run = runs["jax"]
    _assert_agrees(runs["sp"], jax_run["losses"], jax_run["after"], jax_run["grads"])


@pytest.mark.parametrize("which", ["32x32", "40x32"])
def test_spatial_step_matches_unsharded_step(runs, which):
    sp, one = (runs["sp"], runs["one"]) if which == "32x32" else (runs["sp40"], runs["one40"])
    _assert_agrees(sp, one["losses"], one["after"], one["grads"])


def test_unequal_and_empty_shards_are_exercised():
    """At 40×32 over 4 shards: the generator's bottleneck shards, D's score
    map and the VGG tower's second pool take unequal and empty shards."""
    assert check_stage_heights(40, _S, 2)[-1] == [3, 2, 3, 2]
    d_rows = [40 // _S] * _S
    for s in (2, 2, 2, 1, 1):
        d_rows = window_heights(d_rows, 4, s, 1)
    assert d_rows == [2, 1, 0, 0]
    assert window_heights(window_heights([40 // _S] * _S, 2, 2, 0), 2, 2, 0) == [3, 2, 3, 2]


def test_spatial_val_step_matches_unsharded_with_padded_mask(runs):
    """The validation step's (Σ l1·mask, Σ mask) on shards against the
    unsharded one, on a batch whose last row is padding."""
    batch = {k: v.copy() for k, v in runs["batch"].items()}
    for v in batch.values():
        v[-1] = 0.0
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    one_g = runs["one"]["state"].g
    sp_g = copy.deepcopy(runs["sp"]["state"].g)
    sp_g.load_state_dict(one_g.state_dict())
    got = make_val_sum_step(sp_g)(shard_batch(batch, [_CPU] * _S), mask)
    want = make_val_sum_step(one_g)(shard_batch(batch, _CPU), mask)
    assert float(got[1]) == float(want[1]) == 3.0
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
