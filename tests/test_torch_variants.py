"""The generator and discriminator variants that ``Config`` and the module
API reach, against the JAX package on shared weights, on the CPU.

  - each generator variant in float32 within 2e-5 (the f32 parity bound):
    batch norm (eval, the running statistics crossed over), no norm,
    ``no_antialias`` (stride-2 down convs), ``no_antialias_up``
    (ConvTranspose ups), replicate and zero pads, dropout in eval (the
    identity); JAX eager, as the f32 generator's reference stays;
  - ``remat``: outputs, gradients and batch-norm statistics identical to
    the same step without it; dropout's train-mode mask by rate and scale
    (the two packages' RNGs differ);
  - D under batch and no norm;
  - one batch-norm train step against the JAX step: losses within 1e-5
    relative, gradients within 1e-4 relative L2 per leaf, G's and D's
    running mean and variance within 1e-5 relative;
  - the int8 routes of the default net, ``norm="batch"`` and
    ``no_antialias`` in bf16 against the JAX routes, within the reference's
    own rounding spread;
  - the variant state crossing from flax into the port and back out
    through a ``.pth``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp

from ircolor_tpu.compat.torch_import import load_generator_pth
from ircolor_tpu.config import Config as JConfig
from ircolor_tpu.losses.gan import hinge_d_loss, hinge_g_loss
from ircolor_tpu.losses.vgg import VGG16Features as JVGG
from ircolor_tpu.losses.vgg import init_vgg16_params
from ircolor_tpu.models import discriminator as jdisc
from ircolor_tpu.models import generator as jgen
from ircolor_tpu.train.step import composite_g_losses as jcomposite
from ircolor_tpu.train.step import make_train_step as jmake

from ircolor_tpu_torch.compat import (
    discriminator_state_dict_from_flax,
    state_dict_from_flax,
    vgg_state_dict_from_flax,
)
from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.eval.metrics import quantize_to_uint8_01
from ircolor_tpu_torch.losses.vgg import VGG16Features
from ircolor_tpu_torch.models import generator as tgen
from ircolor_tpu_torch.models.common import BatchNorm
from ircolor_tpu_torch.models.discriminator import NLayerDiscriminator
from ircolor_tpu_torch.models.wrapper import IRColorizationModel, reject_unported
from ircolor_tpu_torch.ops import quant as tquant
from ircolor_tpu_torch.train.checkpoint import save_netg_pth
from ircolor_tpu_torch.train.loop import train_kaist
from ircolor_tpu_torch.train.state import create_train_state
from ircolor_tpu_torch.train.step import METRIC_KEYS, make_train_step
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_train_step import _batch, _jcreate, _live_leaves, _np

_HW = (32, 32)


def _jax_variables(module, hw=_HW, seed=0, perturb=None):
    """One jitted init. ``perturb="norms"`` moves the batch norms'
    affine parameters away from their init and sets the batch norms' running
    statistics to those of a calibration batch, each scaled by a factor
    near 1, so eval reads live statistics: the init's (0, 1), or
    statistics merely shifted, would leave a random net's activations
    near zero or dead after the first ReLU, and the output constant.
    ``"all"`` moves every parameter too (the f32 checks: a sharper random
    net)."""
    v = _np(jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 1))))
    params, stats = v["params"], v.get("batch_stats")
    if perturb:
        rs = np.random.RandomState(seed + 1)

        def move(path, a):
            if perturb == "all" or any(getattr(k, "key", None) == "bn" for k in path):
                return a + 0.05 * rs.standard_normal(a.shape).astype(np.float32)
            return a

        params = jax.tree_util.tree_map_with_path(move, params)
        if stats:
            # One train-mode forward moves each statistic S to 0.9·S + 0.1·B,
            # B the calibration batch's: B = 10·new − 9·S.
            xc = rs.uniform(-1, 1, (2, *hw, 1)).astype(np.float32)
            _, upd = jax.jit(lambda p, s, x: module.apply(
                {"params": p, "batch_stats": s}, x, train=True, mutable=["batch_stats"]))(
                params, stats, jnp.asarray(xc))
            stats = jax.tree.map(
                lambda s, u: ((10.0 * u - 9.0 * s) * rs.uniform(0.9, 1.1, s.shape)).astype(np.float32),
                stats, _np(upd["batch_stats"]))
    return params, stats or None


def _variables(params, stats):
    return {"params": params, **({"batch_stats": stats} if stats else {})}


VARIANTS = {
    "batch": dict(norm="batch"),
    "none": dict(norm="none"),
    "no_antialias": dict(no_antialias=True),
    "no_antialias_up": dict(no_antialias_up=True),
    "replicate": dict(padding_type="replicate"),
    "zero": dict(padding_type="zero"),
    "dropout": dict(use_dropout=True),
    "batch_no_aa_both": dict(norm="batch", no_antialias=True, no_antialias_up=True),
}


def _port(params, stats, **kw):
    g = tgen.ResnetUNetGenerator(**kw)
    sd = state_dict_from_flax(params, stats, pad_type=kw.get("padding_type", "reflect"),
                              use_dropout=kw.get("use_dropout", False))
    missing, unexpected = g.load_state_dict(sd, strict=False)
    assert all(k.endswith(".filt") for k in missing) and not unexpected
    return g


@pytest.mark.parametrize("name", list(VARIANTS))
def test_generator_variant_matches_jax_f32(name):
    kw = dict(ngf=8, n_blocks=2, **VARIANTS[name])
    jm = jgen.ResnetUNetGenerator(**kw)
    params, stats = _jax_variables(jm, perturb="all")
    x = np.random.RandomState(3).uniform(-1, 1, (2, *_HW, 1)).astype(np.float32)
    want = np.asarray(jm.apply(_variables(params, stats), jnp.asarray(x)))
    with torch.inference_mode():
        got = _port(params, stats, **kw).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *_HW, 3)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_variant_state_dict_names_follow_the_reference():
    """Batch norm sits after each conv (``inc.2``, ``down1.1``, the blocks'
    ``conv_block.2`` and ``.6``, ``up1_conv.1``) with ``nn.BatchNorm2d``'s
    keys, the convs lose their bias; ConvTranspose ups and no down blurs
    under ``no_antialias(_up)``; zero padding and dropout move the block
    convs as ``build_conv_block`` does."""
    g = tgen.ResnetUNetGenerator(ngf=8, n_blocks=1, norm="batch", no_antialias=True,
                                 no_antialias_up=True)
    sd = g.state_dict()
    for prefix in ("inc.2", "down1.1", "down2.1", "resblocks.0.conv_block.2",
                   "resblocks.0.conv_block.6", "up1_conv.1", "up2_conv.1"):
        for key in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
            assert f"{prefix}.{key}" in sd, (prefix, key)
    assert "down1.0.bias" not in sd and "outc.1.bias" in sd
    assert tuple(sd["up1_up.weight"].shape) == (32, 32, 3, 3) and "down1_down.filt" not in sd
    blk = tgen.ResnetBlock(16, padding_type="zero", use_dropout=True)
    assert [type(m).__name__ for m in blk.conv_block] == [
        "Conv2d", "InstanceNorm2d", "ReLU", "Dropout", "Conv2d", "InstanceNorm2d"]
    assert blk.conv1 is blk.conv_block[0] and blk.conv2 is blk.conv_block[4]
    with pytest.raises(NotImplementedError, match="Padding"):
        tgen.ResnetBlock(16, padding_type="circular")


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_remat_gives_identical_outputs_and_gradients(norm):
    """``remat`` recomputes each block in the backward: the output, every
    parameter's gradient and the batch norms' running statistics (updated
    once, not again in the recompute) are those of the same step without
    it, bit for bit; dropout replays its mask."""
    outs = []
    for remat in (False, True):
        torch.manual_seed(0)
        g = tgen.ResnetUNetGenerator(ngf=8, n_blocks=2, norm=norm, use_dropout=True, remat=remat)
        g.init_weights("normal", 0.02, torch.Generator().manual_seed(1))
        x = torch.rand((2, *_HW, 1), generator=torch.Generator().manual_seed(2)) * 2 - 1
        torch.manual_seed(5)
        y = g.train()(x)
        y.square().mean().backward()
        outs.append((y.detach(), {k: p.grad for k, p in g.named_parameters()},
                     {k: v.clone() for k, v in g.state_dict().items()}))
    (y0, g0, s0), (y1, g1, s1) = outs
    assert torch.equal(y0, y1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    if norm == "batch":
        assert int(s1["resblocks.0.conv_block.2.num_batches_tracked"]) == 1


def test_dropout_train_mask_by_rate_and_scale(monkeypatch):
    """In training the block drops half of the post-ReLU activations and
    scales the rest by 2, as flax's ``nn.Dropout(0.5)`` does (its mask comes
    from another RNG: held by rate and scale, not element by element)."""
    seen = []
    real = F.dropout

    def recorded(h, p, training):
        out = real(h, p, training)
        seen.append((h, out, p, training))
        return out

    monkeypatch.setattr(tgen.F, "dropout", recorded)
    blk = tgen.ResnetBlock(16, use_dropout=True).train()
    x = torch.randn(4, 16, 16, 16, generator=torch.Generator().manual_seed(0))
    blk(x)
    (h, out, p, training), = seen
    assert (p, training) == (0.5, True)
    live = h > 0
    ratio = out[live] / h[live]
    kept = ratio != 0
    assert torch.allclose(ratio[kept], torch.full_like(ratio[kept], 2.0))
    rate = 1.0 - float(kept.float().mean())
    hj = jnp.asarray(np.ones((4, 16, 16, 16), np.float32))
    outj = np.asarray(fnn.Dropout(0.5).apply({}, hj, deterministic=False,
                                             rngs={"dropout": jax.random.PRNGKey(0)}))
    assert set(np.unique(outj)) == {0.0, 2.0}
    rate_j = float((outj == 0).mean())
    assert abs(rate - 0.5) < 0.03 and abs(rate_j - 0.5) < 0.03
    blk.eval()
    seen.clear()
    blk(x)
    assert torch.equal(seen[0][0], seen[0][1])  # eval: the identity


@pytest.mark.parametrize("norm", ["batch", "none"])
def test_discriminator_norm_matches_jax(norm):
    """D under batch norm (train mode: batch statistics; eval: crossed
    running statistics) and under no norm, f32, within 2e-5."""
    jd = jdisc.NLayerDiscriminator(input_nc=4, norm=norm)
    v = _np(jax.jit(jd.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4))))
    params, stats = v["params"], v.get("batch_stats")
    if stats:
        rs = np.random.RandomState(2)
        stats = jax.tree.map(lambda a: a + rs.uniform(0.2, 1.0, a.shape).astype(np.float32), stats)
    d = NLayerDiscriminator(input_nc=4, norm=norm)
    d.load_state_dict(discriminator_state_dict_from_flax(params, stats), strict=True)
    x = np.random.RandomState(4).uniform(-1, 1, (2, 64, 64, 4)).astype(np.float32)
    for train in (False, True):
        variables = _variables(params, stats)
        if train and stats:
            want, upd = jd.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        else:
            want = jd.apply(variables, jnp.asarray(x), train=train)
        with torch.no_grad():
            got = d.train(train)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)
        if train and stats:
            new = discriminator_state_dict_from_flax(params, _np(upd["batch_stats"]))
            for k in new:
                if k.endswith(("running_mean", "running_var")):
                    np.testing.assert_allclose(d.state_dict()[k].numpy(), new[k].numpy(),
                                               rtol=1e-5, atol=1e-7, err_msg=k)


def test_batch_norm_running_variance_is_the_biased_one():
    """At n = 2·2·2 values a channel, torch's ``BatchNorm2d`` would move its
    running variance by the unbiased n/(n − 1) = 8/7 of the batch's; this
    one (and flax) by the biased one."""
    bn = BatchNorm(3).train()
    x = torch.randn(2, 2, 2, 3, generator=torch.Generator().manual_seed(0))
    bn(x)
    var = x.reshape(-1, 3).var(dim=0, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.reshape(-1, 3).mean(dim=0),
                               rtol=1e-6, atol=1e-7)
    assert int(bn.num_batches_tracked) == 1


def _jax_bn_grads(jcfg, g_mod, d_mod, vgg_params, jstate, d_params_new, batch):
    """The BN step's G and D gradients from its own loss functions: D's
    hinge on D(real) then D(G(ir)) (train-mode batch statistics; the
    running ones do not enter), G's composite loss against the updated D."""
    ir, rgb = jnp.asarray(batch["ir"]), jnp.asarray(batch["rgb"])

    def g_apply(gp):
        return g_mod.apply({"params": gp, "batch_stats": jstate.g_stats}, ir, train=True,
                           mutable=["batch_stats"])[0]

    def d_apply(dp, x):
        return d_mod.apply({"params": dp, "batch_stats": jstate.d_stats}, x, train=True,
                           mutable=["batch_stats"])[0]

    def d_loss(dp):
        fake = g_apply(jstate.g_params)
        return hinge_d_loss(d_apply(dp, jnp.concatenate([ir, rgb], -1)),
                            d_apply(dp, jnp.concatenate([ir, fake], -1)))

    def g_loss(gp):
        fake = g_apply(gp)
        pred = d_apply(d_params_new, jnp.concatenate([ir, fake], -1))
        return jcomposite(jcfg, JVGG(), vgg_params, fake, rgb, hinge_g_loss(pred))[0]

    both = jax.jit(lambda gp, dp: (jax.grad(g_loss)(gp), jax.grad(d_loss)(dp)))
    return _np(both(jstate.g_params, jstate.d_params))


def test_batch_norm_train_step_matches_jax():
    """One ``norm="batch"`` train step of each package from the same weights,
    statistics and batch (ngf 8, 1 block, 32², B=2, f32): the 7 losses
    within 1e-5 relative; every live G and D gradient leaf within 1e-4
    relative L2 of ``jax.grad`` of the step's losses; and the running
    statistics of every batch norm of G (two forwards) and D (three) against
    the JAX state's: each variance within 1e-5 relative, each mean vector
    within 1e-5 relative L2 (a channel's mean is near 0, where an element's
    relative error says nothing). D's learning rate is 0 here: the third
    update of D's statistics runs in the G phase on the updated D, and
    Adam's first step moves the entries whose gradient is at rounding level
    by ±lr either way (``test_torch_train_step``), which would move that
    update by ~2e-5 of the mean's norm whatever the statistics code does."""
    kw = dict(img_size=32, batch_size=2, n_blocks=1, ngf=8, norm="batch", lr_D=0.0)
    batch = _batch()
    jcfg = JConfig(**kw, dp_devices=1, batch_transport="float")
    jstate, g_mod, d_mod, (opt_g, opt_d) = _jcreate(jcfg)
    vgg_params = jax.jit(init_vgg16_params)()
    jstep = jmake(jcfg, g_mod, d_mod, JVGG(), opt_g, opt_d, donate=False)
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, vgg_params)
    jg, jd = _jax_bn_grads(jcfg, g_mod, d_mod, vgg_params, jstate, jnew.d_params, batch)

    cfg = Config(**kw, batch_transport="float")
    state = create_train_state(cfg, steps_per_epoch=10, device="cpu")
    g_sd = state_dict_from_flax(_np(jstate.g_params), _np(jstate.g_stats))
    missing, unexpected = state.g.load_state_dict(g_sd, strict=False)
    assert all(k.endswith(".filt") for k in missing) and not unexpected
    state.d.load_state_dict(
        discriminator_state_dict_from_flax(_np(jstate.d_params), _np(jstate.d_stats)), strict=True)
    vgg = VGG16Features()
    vgg.load_state_dict(vgg_state_dict_from_flax(_np(vgg_params)), strict=True)
    state, tm = make_train_step(cfg, vgg)(state, {k: torch.from_numpy(v) for k, v in batch.items()})

    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    n_live = 0
    for net, ref in ((state.g, state_dict_from_flax(jg)),
                     (state.d, discriminator_state_dict_from_flax(jd))):
        grads = dict(net.named_parameters())
        for key in _live_leaves(ref):
            got = grads[key].grad
            rel = float((got - ref[key]).norm() / ref[key].norm())
            assert rel <= 1e-4, (key, rel)
            n_live += 1
    assert n_live >= 20
    want_stats = {**state_dict_from_flax(_np(jnew.g_params), _np(jnew.g_stats)),
                  **{f"D.{k}": v for k, v in discriminator_state_dict_from_flax(
                      _np(jnew.d_params), _np(jnew.d_stats)).items()}}
    got_stats = {**state.g.state_dict(), **{f"D.{k}": v for k, v in state.d.state_dict().items()}}
    n_stats = 0
    for k, want in want_stats.items():
        if k.endswith("running_var"):
            np.testing.assert_allclose(got_stats[k].numpy(), want.numpy(), rtol=1e-5, err_msg=k)
            n_stats += 1
        elif k.endswith("running_mean"):
            assert float((got_stats[k] - want).norm() / want.norm()) <= 1e-5, k
            n_stats += 1
    assert n_stats == 2 * (5 + 2) + 2 * 3  # G: 5 stage norms + 2 in the block; D: 3
    assert int(state.g.state_dict()["inc.2.num_batches_tracked"]) == 2
    assert int(state.d.state_dict()["model.3.num_batches_tracked"]) == 3


def _mean_abs_u8(a, b) -> float:
    """Mean |Δ| of two generator outputs in [−1, 1] after the serving
    path's uint8 rounding, in uint8 levels."""
    pa, pb = (quantize_to_uint8_01((torch.from_numpy(np.array(y, np.float32)) + 1.0) / 2.0)
              for y in (a, b))
    return float((pa - pb).abs().mean()) * 255


@pytest.mark.parametrize("perturb", ["norms", "all"])
@pytest.mark.parametrize("variant,strides", [
    (dict(), [1] * 10),
    (dict(norm="batch"), [1] * 10),
    (dict(no_antialias=True), [2, 2] + [1] * 8),
    (dict(norm="batch", no_antialias=True, no_antialias_up=True), [2, 2] + [1] * 8),
], ids=["instance", "batch", "no_antialias", "batch_no_aa_both"])
def test_int8_variant_routes_match_jax_bf16(variant, strides, perturb, monkeypatch):
    """bf16 at B=2 with the serving flags and the fused gates off: under
    batch norm no fused gate engages at any batch, under no_antialias the
    tails do not, so every heavy conv takes the int8 route in both packages
    (JAX's QuantConv, the port's ``conv3x3_int8``), the no_antialias down
    convs at stride 2.

    The bound is the reference's own rounding spread, not the serving
    budget: on a random net the JAX route itself breaks that budget. A
    quarter of a bf16 ulp of noise on JAX's input moves its int8 output by
    1.5–1.8 uint8 levels on average with the batch norms' parameters moved
    and by 2.3–3.3 with every weight moved (ΔPSNR up to 0.039 dB, ΔSSIM up
    to 0.0028), because the two packages' bf16 convs sum in different
    orders and a one-ulp difference flips an int8 level downstream. So:
    the port's output is no further from JAX's f32 output than JAX's int8
    output is (×1.1), and no further from JAX's int8 output than that
    output moves under the quarter-ulp input noise (×1.25). A misrouted
    site, a wrong stride, pad, scale or bias moves the port by tens of
    levels."""
    hw = (64, 80)
    flags = dict(ngf=16, n_blocks=2, **variant)
    if variant.get("norm") == "batch":  # the fused gates would all engage at B=2 under IN
        flags.update(pallas_block=True, pallas_norm_blur=True, pallas_head=True)
    jm = jgen.ResnetUNetGenerator(dtype=jnp.bfloat16, quant_int8=True, **flags)
    params, stats = _jax_variables(jm, hw=hw, perturb=perturb)
    rs = np.random.RandomState(11)
    x = rs.uniform(-1, 1, (2, *hw, 1)).astype(np.float32)
    nudged = x + rs.uniform(-1, 1, x.shape).astype(np.float32) * 2.0**-9
    v = _variables(params, stats)
    japply = jax.jit(jm.apply)
    want, want_nudged = (np.asarray(japply(v, jnp.asarray(a)).astype(jnp.float32))
                         for a in (x, nudged))
    f32 = np.asarray(jax.jit(jgen.ResnetUNetGenerator(**flags).apply)(v, jnp.asarray(x)))
    g = _port(params, stats, dtype=torch.bfloat16, quant_int8=True, **flags).eval()
    assert g._quant_convs(torch.from_numpy(x))
    calls = []
    real = tquant.conv3x3_int8

    def counted(xq, *a, **kw):
        calls.append(kw.get("stride", 1))
        return real(xq, *a, **kw)

    monkeypatch.setattr(tquant, "conv3x3_int8", counted)
    with torch.inference_mode():
        got = g(torch.from_numpy(x)).float().numpy()
    assert calls == strides
    assert float(np.std(f32)) > 0.1  # a live net, not a constant image
    port_err, jax_err = _mean_abs_u8(got, f32), _mean_abs_u8(want, f32)
    assert port_err <= 1.1 * jax_err, (port_err, jax_err)
    port_gap, jax_spread = _mean_abs_u8(got, want), _mean_abs_u8(want_nudged, want)
    assert port_gap <= 1.25 * jax_spread, (port_gap, jax_spread)


def test_variant_configs_build_serve_and_train_on_cpu():
    """Through the entry points: ``reject_unported`` refuses only 2-D H×W
    tiling among the multi-device modes (the spatial forward refuses the
    variants under it, in test mode and in training:
    ``test_torch_spatial.py``); batch norm, no norm, no_antialias(_up) and
    remat build, serve (eval, running statistics) and take a train step
    with finite losses."""
    for ok in (dict(norm="batch"), dict(norm="none"), dict(no_antialias=True),
               dict(no_antialias_up=True), dict(remat=True), dict(sp_devices=2),
               dict(dp_devices=2)):
        reject_unported(Config(**ok))
    for bad, exc in ((dict(sp_devices=2, sp_w_devices=2), NotImplementedError),
                     (dict(sp_w_devices=2), ValueError)):
        with pytest.raises(exc):
            reject_unported(Config(**bad))
    # Spatial training runs (tests/test_torch_sp_train_*.py); under it the
    # variants stay refused, as does the shard_map mode (the loop's check).
    for bad in (dict(norm="batch"), dict(norm="none"), dict(no_antialias=True),
                dict(no_antialias_up=True)):
        with pytest.raises(NotImplementedError, match="sp_devices > 1"):
            create_train_state(Config(sp_devices=2, img_size=32, ngf=8, n_blocks=1, **bad),
                               steps_per_epoch=1, device="cpu")
    with pytest.raises(ValueError, match="gspmd"):
        train_kaist(Config(sp_devices=2, dp_mode="shard_map"), device="cpu")
    x = torch.rand((1, 32, 32, 1), generator=torch.Generator().manual_seed(0)) * 2 - 1
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for kw in (dict(norm="batch", no_antialias=True, no_antialias_up=True, remat=True),
               dict(norm="none")):
        cfg = Config(img_size=32, batch_size=2, ngf=8, n_blocks=1, lambda_perc=0.0,
                     batch_transport="float", **kw)
        y = IRColorizationModel(cfg, "cpu")(x)
        assert y.shape == (1, 32, 32, 3) and bool(torch.isfinite(y).all())
        state = create_train_state(cfg, steps_per_epoch=10, device="cpu")
        state, m = make_train_step(cfg, None)(state, batch)
        assert all(np.isfinite(float(m[k])) for k in METRIC_KEYS)


def test_variant_state_crosses_to_jax_and_back(tmp_path):
    """ConvTranspose and batch-norm state from flax into the port, then out
    through the port's ``.pth``: the JAX package's loader reads every conv
    and ConvTranspose kernel back as it was (no flip), and a fresh port
    module loads the whole state, running statistics included."""
    kw = dict(ngf=8, n_blocks=1, norm="batch", no_antialias_up=True)
    jm = jgen.ResnetUNetGenerator(**kw)
    params, stats = _jax_variables(jm, perturb="all")
    g = _port(params, stats, **kw)
    path = save_netg_pth(g, str(tmp_path / "netG"))
    back = load_generator_pth(path)
    for name in ("inc_conv", "down1_conv", "up1_up", "up2_up", "up1_conv", "outc_conv"):
        for leaf in back[name]:
            np.testing.assert_array_equal(back[name][leaf], params[name][leaf], err_msg=name)
    np.testing.assert_array_equal(back["resblock_0"]["conv2"]["kernel"],
                                  params["resblock_0"]["conv2"]["kernel"])
    fresh = tgen.ResnetUNetGenerator(**kw)
    fresh.load_state_dict(torch.load(path, weights_only=True), strict=True)
    for k, v in g.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert fresh.state_dict()["inc.2.num_batches_tracked"].dtype == torch.long
    np.testing.assert_array_equal(fresh.state_dict()["up1_conv.1.running_var"].numpy(),
                                  stats["up1_norm"]["bn"]["var"])
