"""The shard forms of spatial training's stages, each against its unsharded
form on the same input, forward and backward (the gradients of the input
and of the weights), on the CPU: the discriminator
(``NLayerDiscriminator.forward_spatial``), the VGG tower
(``VGG16Features.forward_spatial``), SSIM, TV and the hinge losses, on
equal, unequal and empty shards, in float32 (1e-5 relative) and, where no
float32 instance-norm statistics enter, in float64 (1e-12). Also the helpers under them (``parallel.spatial``:
``window_heights``' owner rule, asymmetric and empty halos) and the
``('data', 'sp')`` mesh of ``parallel.mesh`` against JAX's rule."""

import numpy as np
import pytest
import torch

import jax

from ircolor_tpu.parallel import mesh as jmesh

from ircolor_tpu_torch.losses.gan import hinge_d_loss, hinge_g_loss
from ircolor_tpu_torch.losses.ssim import ssim_index, ssim_loss
from ircolor_tpu_torch.losses.tv import tv_loss
from ircolor_tpu_torch.losses.vgg import load_vgg16
from ircolor_tpu_torch.models.discriminator import NLayerDiscriminator
from ircolor_tpu_torch.parallel import spatial
from ircolor_tpu_torch.parallel.mesh import (
    make_train_mesh,
    rank_shard_devices,
    shard_batch,
    train_data_extent,
)
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

_CPU = torch.device("cpu")


def _split(x: torch.Tensor, heights) -> list:
    assert sum(heights) == x.shape[1]
    return list(x.split(list(heights), dim=1))


def _rand(shape, seed, dtype=torch.float32):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed), dtype=dtype) * 2 - 1


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _both_ways(fn_whole, fn_shards, x, heights, params=()):
    """The output and the gradients (of ``x`` and ``params``) of a fixed
    weighting of the output, unsharded and on shards of ``heights``."""
    out = []
    for sharded in (False, True):
        xv = x.clone().requires_grad_(True)
        y = fn_shards(_split(xv, heights)) if sharded else fn_whole(xv)
        if isinstance(y, list):
            y = torch.cat(y, dim=1)
        w = _rand(y.shape, 99, y.dtype) if y.dim() else torch.ones((), dtype=y.dtype)
        grads = torch.autograd.grad((y * w).sum(), [xv, *params])
        out.append((y.detach(), grads))
    return out


def _assert_close(out, tol):
    """Outputs and gradients within ``tol`` relative L2, but for gradients
    below 1e-5 of the largest: the conv biases ahead of an instance norm,
    whose exact gradient is 0 (``tests/test_torch_train_step.py``'s rule)."""
    (y1, g1), (y2, g2) = out
    assert y1.shape == y2.shape
    assert _rel(y2, y1) <= tol
    floor = 1e-5 * max(float(b.norm()) for b in g1)
    live = [(a, b) for a, b in zip(g2, g1) if float(b.norm()) > floor]
    assert live
    for a, b in live:
        assert _rel(a, b) <= tol


# Image heights over 4 shards: equal (D's stride-1 convs leave empty shards
# at 32); unequal with an empty and a one-row shard (halos from past them).
@pytest.mark.parametrize("heights", [(8, 8, 8, 8), (10, 10, 10, 10), (13, 1, 0, 10),
                                     (1, 0, 15, 8)])
def test_discriminator_shard_form(heights):
    """In float32 only: the instance norms take float32 statistics in
    either dtype."""
    d = NLayerDiscriminator(input_nc=4, ndf=8)
    d.init_weights("normal", 0.02, torch.Generator().manual_seed(1))
    x = _rand((2, sum(heights), 24, 4), 0)
    out = _both_ways(d, d.forward_spatial, x, heights, list(d.parameters()))
    _assert_close(out, 1e-5)
    rows = list(heights)
    for conv in (m for m in d.model if isinstance(m, torch.nn.Conv2d)):
        rows = spatial.window_heights(rows, 4, conv.stride[0], 1)
    shards = d.forward_spatial(_split(x, heights))
    assert [t.shape[1] for t in shards] == rows
    if heights == (8, 8, 8, 8):  # img 32, S = 4: 8 → 4 → 2 → 1, then 1/1/1/0, 1/1/0/0
        assert rows == [1, 1, 0, 0]


def test_discriminator_refuses_batch_norm_on_shards():
    d = NLayerDiscriminator(input_nc=4, ndf=8, norm="batch")
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        d([torch.zeros(1, 8, 16, 4)] * 2)


@pytest.mark.parametrize("heights", [(10, 10, 10, 10), (13, 1, 0, 10), (7, 7, 9, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vgg_shard_form(heights, dtype):
    """The 3×3 convs with one halo row and the floor-mode 2×2 pools whose
    windows straddle the seams of odd shards."""
    vgg = load_vgg16(None, 0, dtype).to(dtype)
    x = _rand((1, sum(heights), 20, 3), 2, dtype)
    params = [p.requires_grad_(True) for p in vgg.parameters()]
    out = _both_ways(vgg, vgg.forward_spatial, x, heights, params)
    _assert_close(out, 1e-5 if dtype == torch.float32 else 1e-12)


@pytest.mark.parametrize("heights", [(8, 8, 8, 8), (3, 1, 0, 12), (16, 0, 0, 16)])
def test_ssim_tv_shard_forms(heights):
    """SSIM (5-row zero halos, from past short and empty shards) and TV (the
    seams' row differences) as global means; per-sample SSIM too."""
    a = (_rand((2, sum(heights), 20, 3), 3, torch.float64) + 1) / 2
    b = (_rand((2, sum(heights), 20, 3), 4, torch.float64) + 1) / 2
    for fn in (lambda x: ssim_loss(x, b if not spatial.sharded(x) else _split(b, heights)),
               lambda x: ssim_index(x, b if not spatial.sharded(x) else _split(b, heights),
                                    size_average=False),
               tv_loss):
        _assert_close(_both_ways(fn, fn, a, heights), 1e-12)
    _assert_close(_both_ways(tv_loss, tv_loss, a.float(), heights), 1e-5)


def test_hinge_losses_take_empty_shards():
    """On D's score-map shards of 2/1/0/0 rows, as global means (float32,
    the losses' dtype)."""
    real, fake = _rand((4, 3, 5, 1), 5), _rand((4, 3, 5, 1), 6)
    heights = (2, 1, 0, 0)
    got_d = hinge_d_loss(_split(real, heights), _split(fake, heights))
    np.testing.assert_allclose(float(got_d), float(hinge_d_loss(real, fake)), rtol=1e-6)
    for fn in (hinge_g_loss, lambda p: hinge_d_loss(p, fake if not spatial.sharded(p)
                                                    else _split(fake, heights))):
        _assert_close(_both_ways(fn, fn, real, heights), 1e-6)


def test_window_owner_rule_and_halos():
    """The owner rule at strides 1 and 2 (a 4×4 conv, a floor 2×2 pool),
    asymmetric halos and halos of empty shards, zero rows past the edges."""
    assert spatial.window_heights([8] * 4, 4, 2, 1) == [4] * 4
    assert spatial.window_heights([1] * 4, 4, 1, 1) == [1, 1, 1, 0]
    assert spatial.window_heights([1, 1, 1, 0], 4, 1, 1) == [1, 1, 0, 0]
    assert spatial.window_heights([5] * 4, 2, 2, 0) == [3, 2, 3, 2]
    assert spatial.window_heights([5] * 4, 3, 1, 1) == [5] * 4
    assert spatial.stride2_heights([5] * 4) == spatial.window_heights([5] * 4, 3, 2, 1)
    x = torch.arange(1.0, 11.0).view(1, 10, 1, 1)
    shards = _split(x, (4, 0, 1, 5))
    halos = spatial.exchange_halo_rows(shards, 2, "zero")
    rows = [(top.flatten().tolist(), bot.flatten().tolist()) for top, bot in halos]
    assert rows == [([0.0, 0.0], [5.0, 6.0]), ([3.0, 4.0], [5.0, 6.0]),
                    ([3.0, 4.0], [6.0, 7.0]), ([4.0, 5.0], [0.0, 0.0])]
    # A 4-row window at stride 1, pad 1: one row above and two below each
    # shard's output rows (9 in all; the empty shard keeps none).
    slabs = spatial.window_slabs(shards, 4, 1, 1)
    assert [None if s is None else s.flatten().tolist() for s in slabs] == [
        [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0], None, [4.0, 5.0, 6.0, 7.0],
        [5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 0.0]]
    with pytest.raises(ValueError, match="more than 2 rows"):
        spatial.exchange_halo_rows(_split(x[:, :2], (1, 1)), 2, "reflect")


def test_train_mesh_follows_jax_rule(eight_cpu_devices):
    """``train_data_extent`` gives the data extent of JAX's ``make_train_mesh``
    over 8 devices for every (dp, sp, batch), and its error."""
    for dp in range(0, 5):
        for sp in (2, 4):
            for batch in (None, 1, 2, 3, 4, 6, 8):
                try:
                    want = jmesh.make_train_mesh(dp, sp, batch_size=batch).shape["data"]
                except ValueError as exc:
                    with pytest.raises(ValueError, match="train mesh"):
                        train_data_extent(dp, sp, 8, batch)
                    assert "train mesh" in str(exc)
                else:
                    assert train_data_extent(dp, sp, 8, batch) == want
    assert make_train_mesh(2, 2, device="cpu") == [[_CPU] * 2] * 2
    assert make_train_mesh(0, 4, batch_size=4, device="cpu") == [[_CPU] * 4]
    assert rank_shard_devices(3, "cpu", rank=1) == [_CPU] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_train_mesh(0, 2)
    assert len(jax.devices()) >= 8


def test_shard_batch_cuts_images_on_h_and_keeps_masks_whole():
    """JAX's ``P('data', 'sp')`` for NHWC arrays and ``P('data')`` for the
    val mask, on a rank's shard devices."""
    batch = {"ir": np.arange(2 * 8 * 3, dtype=np.float32).reshape(2, 8, 3, 1),
             "mask": np.ones(2, np.float32)}
    out = shard_batch(batch, [_CPU] * 4)
    assert [t.shape for t in out["ir"]] == [(2, 2, 3, 1)] * 4
    assert torch.equal(torch.cat(out["ir"], dim=1), torch.from_numpy(batch["ir"]))
    assert all(t.is_contiguous() for t in out["ir"])
    assert isinstance(out["mask"], torch.Tensor) and out["mask"].shape == (2,)
    with pytest.raises(ValueError, match="divide"):
        shard_batch(batch, [_CPU] * 3)


def test_remat_recomputes_the_blocks_over_shards():
    """``remat`` under spatial training checkpoints each block's shard
    forward: the step's gradients are the step's without it, bit for bit."""
    from ircolor_tpu_torch.config import Config
    from ircolor_tpu_torch.train.state import create_train_state
    from ircolor_tpu_torch.train.step import make_train_step

    rng = np.random.RandomState(0)
    batch = {"ir": rng.rand(2, 32, 32, 1).astype(np.float32) * 2 - 1,
             "rgb": rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1}
    grads = []
    for remat in (False, True):
        cfg = Config(img_size=32, batch_size=2, ngf=8, n_blocks=2, sp_devices=2, remat=remat,
                     lambda_perc=0.0, batch_transport="float")
        state = create_train_state(cfg, steps_per_epoch=1, device="cpu")
        make_train_step(cfg, None)(state, shard_batch(batch, [_CPU] * 2))
        grads.append({k: p.grad for k, p in state.g.named_parameters()})
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k
