"""The port's discriminator, VGG tower, losses and LR schedule against the
JAX package's, in float32 on the CPU on weights crossed with the port's
``compat`` functions, and the composite loss against its pinned golden."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.losses import gan as jgan
from ircolor_tpu.losses import ssim as jssim
from ircolor_tpu.losses import tv as jtv
from ircolor_tpu.losses.vgg import VGG16Features as JVGG
from ircolor_tpu.losses.vgg import init_vgg16_params
from ircolor_tpu.models.discriminator import NLayerDiscriminator as JD
from ircolor_tpu.train.schedule import make_lr_schedule as jsched

from ircolor_tpu_torch.compat import discriminator_state_dict_from_flax, vgg_state_dict_from_flax
from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.losses import gan, ssim, tv
from ircolor_tpu_torch.losses.vgg import VGG16Features, load_vgg16
from ircolor_tpu_torch.models.discriminator import NLayerDiscriminator
from ircolor_tpu_torch.train.schedule import make_lr_schedule


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close_to_scale(got, want, rel=1e-5):
    """|got − want| ≤ rel · max|want| everywhere."""
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * float(np.abs(want).max())


def test_discriminator_matches_jax():
    jm = JD(input_nc=4)
    params = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 4)))["params"])
    d = NLayerDiscriminator()
    d.load_state_dict(discriminator_state_dict_from_flax(params), strict=True)
    x = np.random.RandomState(2).uniform(-1, 1, (2, 48, 40, 4)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = d(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 4, 3, 1)
    _close_to_scale(got, want)
    assert sum(p.numel() for p in d.parameters()) == sum(v.size for v in jax.tree.leaves(params))


def test_vgg_matches_jax():
    params = _np_tree(init_vgg16_params(seed=3))
    vgg = VGG16Features()
    vgg.load_state_dict(vgg_state_dict_from_flax(params), strict=True)
    x = np.random.RandomState(4).uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)
    want = np.asarray(JVGG().apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = vgg(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 8, 6, 256)
    _close_to_scale(got, want)


def test_vgg_pth_loader_and_fallback(tmp_path):
    """A torchvision-layout vgg16 file (the pinned one of tests/test_losses.py)
    loads into the tower and gives the committed digest; without a file the
    tower is the seeded lecun-normal fallback (variance 1/fan_in)."""
    from test_losses import VGG_GOLDEN_PATH, pinned_vgg_params

    pinned_vgg_params(str(tmp_path))  # writes pinned_vgg16.pth
    vgg = load_vgg16(str(tmp_path / "pinned_vgg16.pth"))
    x = np.random.RandomState(77).rand(1, 32, 32, 3).astype(np.float32) * 2 - 1
    with torch.no_grad():
        out = vgg(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.load(VGG_GOLDEN_PATH)["out"], atol=5e-5)
    assert not any(p.requires_grad for p in vgg.parameters())

    a, b = load_vgg16(None, seed=0), load_vgg16(None, seed=0)
    w = a.features[10].weight
    torch.testing.assert_close(w, b.features[10].weight, rtol=0, atol=0)
    std = (1.0 / (128 * 9)) ** 0.5
    assert abs(float(w.std()) - std) < 0.05 * std and float(w.abs().max()) <= 2 * std / 0.8796
    assert float(a.features[10].bias.abs().max()) == 0.0


def test_losses_match_jax():
    rng = np.random.RandomState(6)
    real, fake = (rng.randn(2, 6, 7, 1).astype(np.float32) for _ in range(2))
    a = rng.rand(2, 24, 20, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape).astype(np.float32), 0, 1)
    # Bound: 1e-5 of the largest magnitude involved — the loss itself for
    # the hinge and TV terms, 1 (the SSIM map's bound) for SSIM, whose
    # 1 − mean cancels digits.
    cases = [
        (gan.hinge_d_loss(torch.from_numpy(real), torch.from_numpy(fake)),
         jgan.hinge_d_loss(jnp.asarray(real), jnp.asarray(fake)), None),
        (gan.hinge_g_loss(torch.from_numpy(fake)), jgan.hinge_g_loss(jnp.asarray(fake)), None),
        (tv.tv_loss(torch.from_numpy(a)), jtv.tv_loss(jnp.asarray(a)), None),
        (ssim.ssim_loss(torch.from_numpy(a), torch.from_numpy(b)),
         jssim.ssim_loss(jnp.asarray(a), jnp.asarray(b)), 1e-5),
        (ssim.ssim_index(torch.from_numpy(a), torch.from_numpy(b), size_average=False),
         jssim.ssim_index(jnp.asarray(a), jnp.asarray(b), size_average=False), 1e-5),
    ]
    for got, want, atol in cases:
        want = np.asarray(want)
        bound = atol if atol is not None else 1e-5 * float(np.abs(want).max())
        assert float(np.abs(got.numpy() - want).max()) <= bound


def test_lr_schedule_matches_jax():
    for args in [(2e-4, 3, 5, 2), (2e-4, 10, 50, 40), (1e-3, 4, 3, 5)]:
        want, got = jsched(*args), make_lr_schedule(*args)
        for count in range(0, 60):
            assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-12)


def test_composite_loss_pinned_digest(tmp_path):
    """The port's train step on the pinned reference-format G, D and VGG
    files of tests/test_losses.py gives the committed loss values
    (tests/goldens/composite_loss_pinned.npz, same bounds). lr_D is 0 so the
    G phase sees the pinned D, as the golden's SGD(0) step does."""
    from test_losses import LOSS_GOLDEN_PATH, pinned_vgg_params
    from test_models import _pinned_golden_state_dict, pinned_discriminator
    from torch_golden import GoldGenerator

    from ircolor_tpu_torch.train.state import create_train_state
    from ircolor_tpu_torch.train.step import make_train_step

    cfg = Config(mode="train", img_size=32, n_blocks=1, batch_size=2, lr_D=0.0)
    state = create_train_state(cfg, steps_per_epoch=1, device="cpu")
    state.g.load_state_dict(_pinned_golden_state_dict(GoldGenerator(n_blocks=1)), strict=True)
    gold_d, _, _ = pinned_discriminator(str(tmp_path))
    state.d.load_state_dict(gold_d.state_dict(), strict=True)
    pinned_vgg_params(str(tmp_path))
    vgg = load_vgg16(str(tmp_path / "pinned_vgg16.pth"))
    rng = np.random.RandomState(4242)
    batch = {
        "ir": torch.from_numpy(rng.rand(2, 32, 32, 1).astype(np.float32) * 2 - 1),
        "rgb": torch.from_numpy(rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1),
    }
    _, metrics = make_train_step(cfg, vgg)(state, batch)
    golden = np.load(os.path.join(os.path.dirname(__file__), LOSS_GOLDEN_PATH))
    for k in ("loss_D", "loss_G", "loss_G_GAN", "loss_G_L1", "loss_G_perc",
              "loss_G_TV", "loss_G_SSIM"):
        np.testing.assert_allclose(float(metrics[k]), float(golden[k]), rtol=5e-5,
                                   atol=1e-7, err_msg=k)
