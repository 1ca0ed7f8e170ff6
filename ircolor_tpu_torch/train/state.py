"""Train state (``ircolor_tpu/train/state.py``): G and D, their Adam
optimizers with the per-step LR schedules, and the step counter. Under
``norm="batch"`` the running statistics are buffers of G and D (the JAX
state's ``g_stats`` and ``d_stats``), saved with them.

Adam: β = (beta1, beta2) from the config (0.5, 0.999), eps 1e-8. torch's
update is lr·m̂/(√v̂ + eps), optax's ``adam``; each step's LR is set from
the schedule before the update, as optax reads ``schedule(count)``. A
parameter whose gradient is None (the conv biases on the fused block
route, inert through instance norm) is not moved, as optax does not move
the exact-zero gradients the JAX package gives it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.models.discriminator import NLayerDiscriminator
from ircolor_tpu_torch.models.generator import ResnetUNetGenerator
from ircolor_tpu_torch.models.wrapper import _DTYPES, generator_from_config, resolve_device
from ircolor_tpu_torch.train.schedule import make_lr_schedule


@dataclass
class TrainState:
    g: ResnetUNetGenerator
    d: NLayerDiscriminator
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    sched_g: Callable[[int], float]
    sched_d: Callable[[int], float]
    step: int = 0


def train_config(cfg: Config) -> Config:
    """The JAX package's training flag forcing: int8 off (rounding has no
    gradient); the fused tails and head off unless their ``*_train`` flags
    are set; the fused blocks off without ``pallas_block_train``. The
    parameters are the same either way."""
    if cfg.resolved_quant_int8 or cfg.quant_int8 is None:
        cfg = cfg.replace(quant_int8=False)
    if cfg.pallas_norm_blur and not cfg.pallas_norm_blur_train:
        cfg = cfg.replace(pallas_norm_blur=False)
    if cfg.pallas_head and not cfg.pallas_head_train:
        cfg = cfg.replace(pallas_head=False)
    if cfg.pallas_block and not cfg.pallas_block_train:
        cfg = cfg.replace(pallas_block=False)
    return cfg


def discriminator_from_config(cfg: Config) -> NLayerDiscriminator:
    """PatchGAN on concat(IR, RGB) in the compute dtype."""
    return NLayerDiscriminator(
        input_nc=cfg.input_nc + cfg.output_nc, ndf=64, n_layers=3, norm=cfg.norm,
        dtype=_DTYPES[cfg.compute_dtype],
    )


def create_train_state(
    cfg: Config, steps_per_epoch: int, device: str | torch.device | None = None
) -> TrainState:
    """G and D initialized from ``torch.Generator(cfg.seed)`` (the reference
    scheme: N(0, init_gain) kernels, zero biases), moved to ``device`` (the
    card by default; ``resolve_device``), with their optimizers.
    Multi-device training raises NotImplementedError (``generator_from_config``)."""
    dev = resolve_device(device)
    cfg = train_config(cfg)
    g = generator_from_config(cfg, train=True)
    d = discriminator_from_config(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    g.init_weights(cfg.init_type, cfg.init_gain, gen)
    d.init_weights(cfg.init_type, cfg.init_gain, gen)
    g.to(dev).train()
    d.to(dev).train()
    sched_g = make_lr_schedule(cfg.lr_G, steps_per_epoch, cfg.epochs, cfg.lr_decay_start_epoch)
    sched_d = make_lr_schedule(cfg.lr_D, steps_per_epoch, cfg.epochs, cfg.lr_decay_start_epoch)
    betas = (cfg.beta1, cfg.beta2)
    opt_g = torch.optim.Adam(g.parameters(), lr=sched_g(0), betas=betas, eps=1e-8)
    opt_d = torch.optim.Adam(d.parameters(), lr=sched_d(0), betas=betas, eps=1e-8)
    return TrainState(g=g, d=d, opt_g=opt_g, opt_d=opt_d, sched_g=sched_g, sched_d=sched_d)
