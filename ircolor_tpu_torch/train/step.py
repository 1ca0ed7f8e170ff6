"""The train step (``ircolor_tpu/train/step.py``): D update, then G update
against the updated D, with the composite G loss.

  G forward once: its output, detached, feeds the D phase; the G phase
      backpropagates through the same output (G is deterministic, so the
      reference's second no-grad forward would give the same tensor).
  D phase (hinge): L_D = 0.5·(E[relu(1 − D(ir⊕rgb))] + E[relu(1 + D(ir⊕fake))]),
      one double-batch forward over [ir⊕rgb ‖ ir⊕fake] with ``d_concat``
      (exact for instance norm); one Adam step on D.
  G phase: λ_gan·(−E[D'(ir⊕fake)]) + λ_L1·L1 + λ_perc·VGG-L1 + λ_tv·TV
      + λ_ssim·(1 − SSIM), with D' the updated D, whose parameters take no
      gradient here; one Adam step on G.

Under ``norm="batch"`` the step keeps the JAX package's structure, whose
running statistics follow torch's train-mode semantics: G runs twice (a
no-grad forward whose output feeds the D phase, then the G phase's own
forward), D runs on the real and the fake halves one after the other (its
batch statistics would mix a concatenated batch), and the G phase's D
forward updates D's statistics once more.

Spatial training (``sp_devices`` > 1, the JAX GSPMD step on a ``('data',
'sp')`` mesh): the batch's images come as lists of H-shards
(``parallel.mesh.shard_batch``) and the generator holds the mesh. The same
step then runs every stage on the shards, as GSPMD partitions it: G's
spatial forward, D and the VGG tower on their shards with halo rows, every
loss as sums over the shards divided by the whole image's count. Autograd
of the shard ops gives the backward; each parameter gathers every shard's
gradient into its one ``.grad``, as GSPMD's replicated parameters do.
Batch norm keeps the structure above on shards: each of its forwards
normalizes by the whole batch's statistics across the shards (and, with
``sync``, across the ranks) and moves the running statistics once.

Losses are computed in float32 whatever the compute dtype, and a λ of 0
skips its term: the term is never computed. Loss values come back as 0-d
device tensors (on shard 0's device); the caller decides when to read them.
"""

from __future__ import annotations

from typing import Callable

import torch

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.losses.gan import hinge_d_loss, hinge_g_loss
from ircolor_tpu_torch.losses.ssim import ssim_loss
from ircolor_tpu_torch.losses.tv import tv_loss
from ircolor_tpu_torch.losses.vgg import VGG16Features
from ircolor_tpu_torch.parallel.spatial import (
    first_shard,
    global_mean,
    global_sum,
    on_shards,
    sharded,
)
from ircolor_tpu_torch.train.state import TrainState
from ircolor_tpu_torch.utils.timing import span

METRIC_KEYS = ("loss_D", "loss_G", "loss_G_GAN", "loss_G_L1", "loss_G_perc",
               "loss_G_TV", "loss_G_SSIM")


def _decode_one(ir: torch.Tensor, rgb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if ir.dtype == torch.uint16:
        ir = ir.float() / 65535.0 * 2.0 - 1.0
    if rgb.dtype == torch.uint8:
        rgb = rgb.float() / 255.0 * 2.0 - 1.0
    return ir, rgb


def _decode_transport(ir, rgb):
    """uint16 IR and uint8 RGB (the loader's integer transport) → float32 in
    [−1, 1]; float batches pass through. Lists of H-shards (spatial
    training) are decoded shard by shard."""
    if not sharded(ir):
        return _decode_one(ir, rgb)
    pairs = [_decode_one(i, r) for i, r in zip(ir, rgb)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs()


def composite_g_losses(
    cfg: Config, vgg: VGG16Features | None, fake, rgb, loss_gan: torch.Tensor,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """λ_gan·loss_gan + λ_L1·L1 + λ_perc·Perc + λ_tv·TV + λ_ssim·(1 − SSIM),
    each term in float32 and left out entirely when its λ is 0. ``fake`` and
    ``rgb`` may be lists of H-shards (spatial training): every term is then
    computed on the shards (the VGG tower's and the SSIM window's halos,
    TV's seams) and every mean is over the whole image's count."""
    zero = torch.zeros((), dtype=torch.float32, device=first_shard(fake).device)
    fake32, rgb32 = on_shards(torch.Tensor.float, fake), on_shards(torch.Tensor.float, rgb)
    loss_l1 = loss_perc = loss_tv = loss_ssim = zero
    if cfg.lambda_L1 != 0.0:
        with span("loss.l1"):
            loss_l1 = global_mean(on_shards(_l1, fake32, rgb32)) * cfg.lambda_L1
    if cfg.lambda_perc != 0.0:
        with span("loss.vgg"):
            feat_fake, feat_real = vgg(fake), vgg(rgb)
            loss_perc = global_mean(on_shards(_l1, feat_fake, feat_real)) * cfg.lambda_perc
    if cfg.lambda_tv != 0.0:
        with span("loss.tv"):
            loss_tv = tv_loss(fake32) * cfg.lambda_tv

    def to01(t: torch.Tensor) -> torch.Tensor:
        return (t + 1.0) / 2.0

    if cfg.lambda_ssim != 0.0:
        with span("loss.ssim"):
            loss_ssim = ssim_loss(on_shards(to01, fake32), on_shards(to01, rgb32)) * cfg.lambda_ssim
    total = cfg.lambda_gan * loss_gan + loss_l1 + loss_perc + loss_tv + loss_ssim
    return total, {
        "loss_G": total,
        "loss_G_GAN": loss_gan,
        "loss_G_L1": loss_l1,
        "loss_G_perc": loss_perc,
        "loss_G_TV": loss_tv,
        "loss_G_SSIM": loss_ssim,
    }


def _d_input(ir: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """D's input: IR ⊕ RGB on the channels, RGB (real or G's) in float32."""
    return torch.cat([ir, rgb.float()], dim=-1)


def _real_fake(ir: torch.Tensor, rgb: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """D's double batch [ir⊕rgb ‖ ir⊕fake] (``d_concat``)."""
    return torch.cat([_d_input(ir, rgb), _d_input(ir, fake)])


def _adam_step(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


def make_train_step(
    cfg: Config, vgg: VGG16Features | None, *, update_d: bool = True,
    reduce_grads: Callable[[torch.nn.Module], None] | None = None,
) -> Callable[[TrainState, dict[str, torch.Tensor]], tuple[TrainState, dict[str, torch.Tensor]]]:
    """``step(state, batch) → (state, metrics)`` with ``batch = {'ir', 'rgb'}``
    NHWC tensors on the state's device, or lists of their H-shards on the
    generator's ``spatial_mesh``. ``vgg`` may be None when
    ``lambda_perc`` is 0. ``update_d=False`` skips the D phase (an ablation
    knob; the reference always steps D). ``reduce_grads(net)``, where given,
    runs after each backward, before that net's Adam step (the data-parallel
    step's all-reduce, ``train.step_shardmap``)."""

    has_bn = cfg.norm == "batch"

    def _reduce(net: torch.nn.Module) -> None:
        if reduce_grads is not None:
            with span("train.allreduce"):
                reduce_grads(net)

    def step(state: TrainState, batch: dict[str, torch.Tensor]):
        with span("train.step", state.step):
            return _step(state, batch)

    def _step(state: TrainState, batch: dict[str, torch.Tensor]):
        g, d = state.g, state.d
        with span("train.decode"):
            ir, rgb = _decode_transport(batch["ir"], batch["rgb"])
        with span("train.g_forward"):
            if has_bn:
                with torch.no_grad():
                    fake_detached = g(ir)
            else:
                fake = g(ir)
                fake_detached = on_shards(torch.Tensor.detach, fake)

        if update_d:
            d.requires_grad_(True)
            with span("train.d_forward"):
                if cfg.d_concat and not has_bn:
                    b = first_shard(ir).shape[0]
                    pred = d(on_shards(_real_fake, ir, rgb, fake_detached))
                    loss_d = hinge_d_loss(on_shards(lambda p: p[:b], pred),
                                          on_shards(lambda p: p[b:], pred))
                else:
                    loss_d = hinge_d_loss(d(on_shards(_d_input, ir, rgb)),
                                          d(on_shards(_d_input, ir, fake_detached)))
            with span("train.d_backward"):
                state.opt_d.zero_grad(set_to_none=True)
                loss_d.backward()
            _reduce(d)
            with span("train.d_adam"):
                _adam_step(state.opt_d, state.sched_d(state.step))
        else:
            loss_d = torch.zeros((), dtype=torch.float32, device=first_shard(ir).device)

        # G phase against the updated D; D's parameters take no gradient.
        if has_bn:
            with span("train.g_forward"):
                fake = g(ir)
        d.requires_grad_(False)
        try:
            with span("train.g_gan"):
                if cfg.lambda_gan != 0.0:
                    loss_gan = hinge_g_loss(d(on_shards(_d_input, ir, fake)))
                else:
                    loss_gan = torch.zeros((), dtype=torch.float32,
                                           device=first_shard(fake).device)
            with span("train.losses"):
                total, metrics = composite_g_losses(cfg, vgg, fake, rgb, loss_gan)
            with span("train.g_backward"):
                state.opt_g.zero_grad(set_to_none=True)
                total.backward()
        finally:
            d.requires_grad_(True)
        _reduce(g)
        with span("train.g_adam"):
            _adam_step(state.opt_g, state.sched_g(state.step))
        state.step += 1
        return state, {"loss_D": loss_d.detach(), **{k: v.detach() for k, v in metrics.items()}}

    return step


def make_val_step(g: torch.nn.Module) -> Callable[[dict[str, torch.Tensor]], torch.Tensor]:
    """Per-sample pixel L1, (B,), for the sample-weighted validation mean."""

    @torch.no_grad()
    def val(batch: dict[str, torch.Tensor]) -> torch.Tensor:
        ir, rgb = _decode_transport(batch["ir"], batch["rgb"])
        fake = g(ir)
        if sharded(fake):  # the shards' per-sample sums over the image's count
            per = global_sum([_l1(f, r).sum(dim=(1, 2, 3)) for f, r in zip(fake, rgb)])
            return per / (sum(f.numel() for f in fake) // fake[0].shape[0])
        return (fake.float() - rgb.float()).abs().mean(dim=(1, 2, 3))

    return val


def make_val_sum_step(g: torch.nn.Module):
    """(batch, mask) → (Σ l1·mask, Σ mask): the masked form of ``make_val_step``
    for a zero-padded final batch."""
    val = make_val_step(g)

    def val_sum(batch: dict[str, torch.Tensor], mask: torch.Tensor):
        per = val(batch)
        return (per * mask).sum(), mask.sum()

    return val_sum
