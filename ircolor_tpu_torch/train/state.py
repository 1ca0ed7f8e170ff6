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
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.models.common import BatchNorm
from ircolor_tpu_torch.models.discriminator import NLayerDiscriminator
from ircolor_tpu_torch.models.generator import ResnetUNetGenerator
from ircolor_tpu_torch.models.wrapper import _DTYPES, generator_from_config, resolve_device
from ircolor_tpu_torch.parallel.mesh import rank_shard_devices
from ircolor_tpu_torch.train.schedule import make_lr_schedule
from ircolor_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclass
class TrainState:
    g: ResnetUNetGenerator
    d: NLayerDiscriminator
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    sched_g: Callable[[int], float]
    sched_d: Callable[[int], float]
    step: int = 0


# The flags spatial training turns off.
SPATIAL_OFF = ("pallas_block_train", "pallas_norm_blur", "pallas_head", "pallas_encdec_bwd",
               "blur_matmul_bwd")


def train_config(cfg: Config) -> Config:
    """The JAX package's training flag forcing: int8 off (rounding has no
    gradient); the fused tails and head off unless their ``*_train`` flags
    are set; the fused blocks off without ``pallas_block_train``. The
    parameters are the same either way.

    Data parallelism routes as one device does, under either ``dp_mode``:
    every rank runs the kernels on its own slice. JAX turns them off on a
    multi-device ``"gspmd"`` mesh because GSPMD cannot partition a
    ``pallas_call``; the port's ranks hold whole kernels, so that gate has
    no counterpart here and ``"gspmd"`` differs from ``"shard_map"`` only
    in its batch norms (``models.common.BatchNorm.sync``).

    Spatial training (``sp_devices`` > 1) turns off ``pallas_block_train``,
    ``pallas_norm_blur``, ``pallas_head``, ``pallas_encdec_bwd`` and
    ``blur_matmul_bwd``, as ``ircolor_tpu/train/state.py:108-121`` does:
    the kernels' halo forms have no backward, so JAX's spatial step runs no
    Pallas kernel, and neither does the port's (logged)."""
    if cfg.sp_devices > 1:
        off = {f: False for f in SPATIAL_OFF if getattr(cfg, f)}
        if off:
            log.info("[TRAIN] spatial training (sp_devices=%d): %s off, as in the JAX package "
                     "(no fused kernel has a backward over H-shards)", cfg.sp_devices,
                     ", ".join(off))
        cfg = cfg.replace(**off)
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
    cfg: Config, steps_per_epoch: int, device: str | torch.device | None = None,
    spatial_mesh: Sequence[torch.device] | None = None,
) -> TrainState:
    """G and D initialized from ``torch.Generator(cfg.seed)`` (the reference
    scheme: N(0, init_gain) kernels, zero biases), moved to ``device`` (the
    card by default; ``resolve_device``), with their optimizers. In a
    process group of more than one rank (data parallelism) rank 0's
    parameters and buffers are broadcast to every rank, and the batch norms
    (``dp_mode="gspmd"``; the shard_map step refuses them) take their
    statistics over the global batch; the routing is ``train_config``'s, as
    on one device. Spatial training (``sp_devices`` > 1): the generator
    holds ``spatial_mesh``, the S devices of this rank's H-shards (default
    ``parallel.mesh.rank_shard_devices``: ``device`` S times where it names
    one, else cards 0..S-1), and the parameters live on its first; the
    variants it does not run raise here."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    cfg = train_config(cfg)
    g = generator_from_config(cfg)
    if cfg.sp_devices > 1:
        mesh = (rank_shard_devices(cfg.sp_devices, device) if spatial_mesh is None
                else [torch.device(x) for x in spatial_mesh])
        if len(mesh) != cfg.sp_devices:
            raise ValueError(f"{len(mesh)} shard devices for sp_devices={cfg.sp_devices}")
        g.spatial_mesh, dev = mesh, mesh[0]
        g.train().check_spatial_variants()
    d = discriminator_from_config(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    g.init_weights(cfg.init_type, cfg.init_gain, gen)
    d.init_weights(cfg.init_type, cfg.init_gain, gen)
    g.to(dev).train()
    d.to(dev).train()
    if world > 1:
        from ircolor_tpu_torch.train.step_shardmap import broadcast_replicas

        broadcast_replicas(g, d)
        for m in (*g.modules(), *d.modules()):
            if isinstance(m, BatchNorm):
                m.sync = True
    sched_g = make_lr_schedule(cfg.lr_G, steps_per_epoch, cfg.epochs, cfg.lr_decay_start_epoch)
    sched_d = make_lr_schedule(cfg.lr_D, steps_per_epoch, cfg.epochs, cfg.lr_decay_start_epoch)
    betas = (cfg.beta1, cfg.beta2)
    opt_g = torch.optim.Adam(g.parameters(), lr=sched_g(0), betas=betas, eps=1e-8)
    opt_d = torch.optim.Adam(d.parameters(), lr=sched_d(0), betas=betas, eps=1e-8)
    return TrainState(g=g, d=d, opt_g=opt_g, opt_d=opt_d, sched_g=sched_g, sched_d=sched_d)
