"""The data-parallel train step (``train.step_shardmap``) on two gloo
ranks on the CPU (``parallel.launch.spawn``, ``tools.dp_steps.run_rank``):
against JAX's shard_map step on 2 fake CPU devices and against the port's
own one-process step on the global batch, from the same weights (crossed
through ``ircolor_tpu_torch.compat``), in float32 on the plain route (ngf
8, one block, 32×32, global batch 4, ``lambda_perc`` 0). The bounds are
``tests/test_torch_train_step.py``'s: the 7 losses within 1e-5 relative,
the averaged gradient of every live leaf within 1e-4 relative L2, the
first Adam update within lr/4 on all but 1% of each leaf's entries. The
ranks' parameters and buffers are equal bit for bit after every step.

Against JAX the G phase (its losses and G's gradient) is JAX's G phase on
the D' the step produced (its D after D's Adam step, converted back to
flax): a few of D's weight entries have rounding-level gradients, so their
first update (±lr) may take the other sign in the two packages (within the
update bound), and the G phase reads D' at first order. On this batch 11
entries do, and move JAX's loss_G_GAN by 1.0e-4 relative; on JAX's own D'
the port's G phase gives JAX's loss to 4e-7.
Under ``norm="batch"`` with ``dp_mode="gspmd"`` the batch statistics are
the global batch's (the one-process step's); the shard_map step refuses
batch norm, as JAX's does. Both modes build the ranks' generators with the
kernel routing of one device. The ranks run every case in one spawn, while
this process runs JAX and the one-process references beside them."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.config import Config as JConfig
from ircolor_tpu.losses.gan import hinge_d_loss, hinge_g_loss
from ircolor_tpu.train.step import composite_g_losses as jcomposite
from ircolor_tpu.parallel.mesh import make_data_mesh, shard_batch
from ircolor_tpu.train.step_shardmap import make_train_step_shardmap as jmake_shardmap

from ircolor_tpu_torch.compat import discriminator_state_dict_from_flax, state_dict_from_flax
from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.parallel.launch import spawn
from ircolor_tpu_torch.tools.dp_steps import ROUTING, one_process_steps, run_rank_each
from ircolor_tpu_torch.train.step import METRIC_KEYS
from ircolor_tpu_torch.train.state import train_config
from ircolor_tpu_torch.train.step_shardmap import make_train_step_shardmap
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_train_step import _jcreate, _live_leaves

_LR = 2e-4
_KW = dict(img_size=32, batch_size=4, n_blocks=1, ngf=8, lambda_perc=0.0, dp_devices=2,
           dp_mode="shard_map", batch_transport="float")
_CPU = torch.device("cpu")


def _batches(n=2):
    # Not seed 0: its first batch puts one LeakyReLU input of D within
    # rounding of 0, a kink where the gradient is not defined (both
    # packages' D gradients differ by 1.5e-3 relative there, by 2e-6 after a
    # 1e-4 perturbation of the inputs).
    rng = np.random.RandomState(1)
    return [{"ir": rng.rand(4, 32, 32, 1).astype(np.float32) * 2 - 1,
             "rgb": rng.rand(4, 32, 32, 3).astype(np.float32) * 2 - 1} for _ in range(n)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(g_sd, d_sd):
    out = {f"g.{k}": np.asarray(v, np.float32) for k, v in g_sd.items()}
    out.update({f"d.{k}": np.asarray(v, np.float32) for k, v in d_sd.items()})
    return out


_BN = dict(_KW, norm="batch", dp_mode="gspmd")
# The train flags of every kernel of the step on: the routing cases.
_ROUTED = dict(_KW, pallas_norm_blur_train=True, pallas_head_train=True, pallas_encdec_bwd=True)


@pytest.fixture(scope="module")
def runs(eight_cpu_devices):
    """JAX's shard_map step and its global-batch gradients; the port's two
    ranks and its one-process step, all from JAX's initial weights; the
    ranks and one process under batch norm (gspmd, seeded weights); the
    ranks' routing under each mode (state built, no step)."""
    batches = _batches()
    jcfg = JConfig(**_KW)
    jstate, g_mod, d_mod, (opt_g, opt_d) = _jcreate(jcfg)
    g0, d0 = (_np_tree(jstate.g_params), _np_tree(jstate.d_params))
    before = _flat(state_dict_from_flax(g0), discriminator_state_dict_from_flax(d0))
    weights = {"g": {k: v.numpy() for k, v in state_dict_from_flax(g0).items()},
               "d": {k: v.numpy() for k, v in discriminator_state_dict_from_flax(d0).items()}}
    cfg, bn_cfg = Config(**_KW), Config(**_BN)
    cases = [(cfg, batches, weights), (bn_cfg, batches[:1])]
    cases += [(Config(**{**_ROUTED, "dp_mode": mode}), []) for mode in ("gspmd", "shard_map")]
    ir, rgb = jnp.asarray(batches[0]["ir"]), jnp.asarray(batches[0]["rgb"])
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(spawn, run_rank_each, [_CPU, _CPU], (cases,), timeout_s=150)
        mesh = make_data_mesh(2)
        jstep = jmake_shardmap(jcfg, g_mod, d_mod, None, opt_g, opt_d, mesh, donate=False)
        jnew, jm = jstep(jstate, shard_batch(dict(batches[0]), mesh), None)
        reference = _jax_reference(jcfg, g_mod, d_mod).lower(g0, d0, d0, ir, rgb).compile()
        one = one_process_steps(cfg.replace(dp_devices=1), _CPU, batches, weights)
        bn_one = one_process_steps(bn_cfg.replace(dp_devices=1), _CPU, batches[:1])
        per_rank = spawned.result()
    ranks, bn_ranks, *routed = ([r[i] for r in per_rank] for i in range(len(cases)))
    # D's gradient, and G's phase (its losses and gradient) against the D'
    # of the step under test.
    d_new = _flax_discriminator(ranks[0]["first"]["params"], d0)
    g_grads, d_grads, g_phase = _np_tree(reference(g0, d0, d_new, ir, rgb))
    jax_run = {
        "losses": {k: float(v) for k, v in jm.items()},
        "g_phase": {k: float(v) for k, v in g_phase.items()},
        "after": _flat(state_dict_from_flax(_np_tree(jnew.g_params)),
                       discriminator_state_dict_from_flax(_np_tree(jnew.d_params))),
        "grads": _flat(state_dict_from_flax(g_grads), discriminator_state_dict_from_flax(d_grads)),
    }
    return {"before": before, "jax": jax_run, "ranks": ranks, "one": one,
            "bn": (bn_ranks, bn_one), "routed": dict(zip(("gspmd", "shard_map"), routed))}


def _flax_discriminator(params, like):
    """The port's D parameters (``d.model.{idx}``) as JAX's param tree."""
    n = sum(1 for key in like if key.startswith("conv") and key != "conv_out")
    names = {"conv0": 0, **{f"conv{i}": 3 * i - 1 for i in range(1, n)}, "conv_out": 3 * n - 1}
    tree = {}
    for name, idx in names.items():
        entry = {"kernel": params[f"d.model.{idx}.weight"].transpose(2, 3, 1, 0)}
        if f"d.model.{idx}.bias" in params:
            entry["bias"] = params[f"d.model.{idx}.bias"]
        tree[name] = entry
    assert jax.tree.structure(tree) == jax.tree.structure(dict(like))
    return tree


def _jax_reference(jcfg, g_mod, d_mod):
    """``(G, D, D', ir, rgb) → (dG, dD, G-phase losses)``, jitted: the
    gradients of the step's own loss functions, D's hinge on
    [ir⊕rgb ‖ ir⊕G(ir)] at D and G's composite loss against D', and the
    G-phase losses (``composite_g_losses``) against D'."""

    def run(gp, dp, dp_new, ir, rgb):
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
            return jcomposite(jcfg, None, None, out, rgb, hinge_g_loss(pred))

        g_grads, aux = jax.grad(g_loss, has_aux=True)(gp)
        return g_grads, jax.grad(d_loss)(dp), aux

    return jax.jit(run)


def _assert_agrees(before, got_losses, got_first, want_losses, want_after, want_grads):
    for k in METRIC_KEYS:
        np.testing.assert_allclose(got_losses[k], want_losses[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    n_live = 0
    for tag in ("g.", "d."):
        ref = {k: torch.from_numpy(v) for k, v in want_grads.items()
               if k.startswith(tag) and k in got_first["grads"]}
        for key in _live_leaves(ref):
            got = got_first["grads"][key]
            assert got is not None, key
            rel = np.linalg.norm(got - want_grads[key]) / np.linalg.norm(want_grads[key])
            assert rel <= 1e-4, (key, rel)
            d_want = want_after[key] - before[key]
            d_got = got_first["params"][key] - before[key]
            assert np.abs(d_want).max() > 0.5 * _LR, key
            off = int((np.abs(d_got - d_want) > 0.25 * _LR).sum())
            assert off <= 0.01 * d_want.size, (key, off, d_want.size)
            n_live += 1
    assert n_live >= 10, n_live


def test_two_rank_step_matches_jax_shardmap(runs):
    jax_run, ranks = runs["jax"], runs["ranks"]
    want = {"loss_D": jax_run["losses"]["loss_D"], **jax_run["g_phase"]}
    _assert_agrees(runs["before"], ranks[0]["losses"][0], ranks[0]["first"], want,
                   jax_run["after"], jax_run["grads"])


def test_two_rank_step_matches_one_process(runs):
    ranks, one = runs["ranks"], runs["one"]
    want_grads = {k: v for k, v in one["first"]["grads"].items() if v is not None}
    _assert_agrees(runs["before"], ranks[0]["losses"][0], ranks[0]["first"], one["losses"][0],
                   one["first"]["params"], want_grads)


def test_ranks_stay_equal_bit_for_bit(runs):
    ranks = runs["ranks"]
    assert [o["equal"] for o in ranks] == [[True, True]] * 2
    assert ranks[0]["losses"] == ranks[1]["losses"]  # all-reduced: the same on every rank


def test_batch_norm_takes_global_statistics_under_gspmd(runs):
    """Two ranks of ``norm="batch"``, ``dp_mode="gspmd"``: every batch norm
    of G and D reduces its sums over the ranks, so the step is the
    one-process step's on the global batch."""
    ranks, one = runs["bn"]
    assert [o["equal"] for o in ranks] == [[True]] * 2
    first = ranks[0]["first"]
    for k in METRIC_KEYS:
        np.testing.assert_allclose(ranks[0]["losses"][0][k], one["losses"][0][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for key, want in one["first"]["grads"].items():
        if want is not None and np.linalg.norm(want) > 1e-5:
            rel = np.linalg.norm(first["grads"][key] - want) / np.linalg.norm(want)
            assert rel <= 1e-4, (key, rel)


@pytest.mark.parametrize("dp_mode", ["gspmd", "shard_map"])
def test_ranks_route_to_the_kernels_in_both_modes(runs, dp_mode):
    """In a group of two ranks the generator takes one device's routing in
    either mode: every fused kernel of the step that its train flag asks
    for (JAX's gspmd turns them off on a mesh; the port's ranks hold whole
    kernels)."""
    want = train_config(Config(**{**_ROUTED, "dp_mode": dp_mode, "dp_devices": 1}))
    for out in runs["routed"][dp_mode]:
        assert out["routing"] == {f: True for f in ROUTING}
        assert out["routing"] == {f: getattr(want, f) for f in ROUTING}


def test_shardmap_step_refuses_batch_norm():
    with pytest.raises(NotImplementedError, match="instance/none norms only"):
        make_train_step_shardmap(Config(**{**_KW, "norm": "batch"}), None)
