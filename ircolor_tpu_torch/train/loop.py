"""The training loop (``ircolor_tpu/train/loop.py``): data, state, epoch
loop, validation, checkpoints.

The reference recipe: scan the KAIST pairs once, seed-42 train/val split
(``val_ratio``), Adam for G and D with the linear LR decay, D-then-G
updates per batch, a loss line every ``log_every`` steps (and at step 1),
validation L1 per epoch, ``netG_epoch_{k:03d}.{msgpack,pth}`` every
``save_every`` epochs and at the end, ``netG_best.{msgpack,pth}`` on a
val-L1 improvement (decided before the full-state save, so a resume
restores the right best), and the next epoch's LR printed at each epoch's
end. ``--resume`` continues from the newest full state; ``init_G_weights``
may be a ``.pth`` or a ``.msgpack`` export.

``profile_dir``: a ``torch.profiler`` trace of the first epoch's first
``min(5, steps)`` steps, written to ``<profile_dir>/trace.json`` (also when
a step raises). ``debug_nans`` (the JAX ``jax_debug_nans``): G's and D's
forwards check every op's output and raise ``FloatingPointError`` at the
first that is not finite (``_NanGuard``), and the backward runs under
``torch.autograd.detect_anomaly(check_nan=True)``.

Every generator variant of ``Config`` trains (``norm``, ``no_antialias``,
``no_antialias_up``, ``remat``), on one device or data-parallel over
``dp_devices`` ranks (``train_kaist``: one process a rank, each with its
slice of every global batch from a rank-sharded loader; the step of
``train.step_shardmap``, whose all-reduces keep the replicas equal; the
validation padded to each rank's share of the batch and summed over the
ranks, so that every rank takes the same best-checkpoint decision; rank 0
logs and writes the checkpoints while the others wait at a barrier; a
resume on every rank). Spatial training (``sp_devices`` S > 1, JAX's
GSPMD step on a ``('data', 'sp')`` mesh; ``dp_mode="gspmd"`` only, as in
JAX): each rank holds S H-shards (``parallel.mesh.make_train_mesh``), cuts
every batch of its slice on H (``shard_batch``), and runs the train and val
steps on the shards with every fused kernel off (``train.state.
train_config``); checkpoints and ``--resume`` are those of one device.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.data.kaist import KAISTPairDataset, scan_kaist_pairs, split_train_val
from ircolor_tpu_torch.data.pipeline import BatchLoader
from ircolor_tpu_torch.losses.vgg import load_vgg16
from ircolor_tpu_torch.models.wrapper import _DTYPES, load_state_permissive, resolve_device
from ircolor_tpu_torch.parallel.launch import spawn
from ircolor_tpu_torch.parallel.mesh import (
    initialize_multihost,
    make_train_mesh,
    rank_shard_devices,
    shard_batch,
    warmup_mesh_collectives,
    world,
)
from ircolor_tpu_torch.parallel.spatial import check_stage_heights
from ircolor_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    load_netg_state,
    restore_full_state,
    save_full_state,
    save_netg_export,
)
from ircolor_tpu_torch.train.schedule import linear_decay_factor
from ircolor_tpu_torch.train.state import create_train_state, without_sp_w
from ircolor_tpu_torch.train.step import METRIC_KEYS, make_train_step, make_val_sum_step
from ircolor_tpu_torch.train.step_shardmap import (
    broadcast_replicas,
    make_train_step_shardmap,
    make_val_sum_step_shardmap,
    replicas_equal,
)
from ircolor_tpu_torch.utils.logging import JsonlLogger, get_logger
from ircolor_tpu_torch.utils.timing import ProfilerTrace, synchronize

log = get_logger(__name__)


def _check_loss_sanity(m: dict[str, float], cfg: Config, epoch: int, step: int) -> None:
    """Raise on non-finite losses, and on an L1 above its bound for inputs in
    [−1, 1] (2·λ_L1): a sign that a batch reached the step undecoded."""
    bad = [k for k, v in m.items() if not np.isfinite(v)]
    if bad:
        raise FloatingPointError(
            f"Non-finite training losses at epoch {epoch} step {step}: "
            + ", ".join(f"{k}={m[k]}" for k in bad)
        )
    if cfg.lambda_L1 > 0.0 and m.get("loss_G_L1", 0.0) > 2.0 * cfg.lambda_L1 + 1e-6:
        raise FloatingPointError(
            f"loss_G_L1={m['loss_G_L1']:.3f} exceeds the [-1,1]-input bound "
            f"2·lambda_L1={2.0 * cfg.lambda_L1:.3f} at epoch {epoch} step {step}; "
            "inputs are likely not decoded to [-1,1] (check batch_transport handling)"
        )


# Allocations whose contents are not yet written: not checked for NaNs.
_UNWRITTEN = {torch.empty, torch.empty_like, torch.empty_strided, torch.Tensor.new_empty,
              torch.Tensor.new_empty_strided}


class _NonFiniteCheck(TorchFunctionMode):
    """Checks the floating outputs of every torch op that runs inside it."""

    def __init__(self, guard: "_NanGuard", net: str):
        super().__init__()
        self.guard, self.net, self.owner = guard, net, ""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for a in (*args, *kwargs.values()):
            self.owner = self.guard.owners.get(id(a), self.owner)
        if func not in _UNWRITTEN:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and not bool(torch.isfinite(t).all())):
                    raise FloatingPointError(
                        f"debug_nans: non-finite output of {getattr(func, '__name__', func)} in "
                        f"{self.net} module {self.owner or '(its input)'!r} at {self.guard.where}")
        return out


class _NanGuard:
    """``debug_nans`` for G and D: a forward pre-hook on each enters a
    ``_NonFiniteCheck`` and a forward hook leaves it, so that the first op
    of their forwards whose output is not finite raises
    ``FloatingPointError`` naming the module, by qualified name, whose
    parameter that forward read last: the port's layers apply their
    weights functionally (``conv_nhwc(layer, x)``), so the layer a value
    comes from is the one whose weights were just read. ``where`` says the
    epoch and step."""

    def __init__(self, nets: dict[str, torch.nn.Module]):
        self.where = ""
        self.owners = {id(p): name.rpartition(".")[0] for net in nets.values()
                       for name, p in net.named_parameters()}
        self.handles = []
        for label, net in nets.items():
            checks: list = []

            def enter(module, args, label=label, checks=checks):
                checks.append(_NonFiniteCheck(self, label))
                checks[-1].__enter__()

            def leave(module, args, out, checks=checks):
                checks.pop().__exit__(None, None, None)

            self.handles += [net.register_forward_pre_hook(enter),
                             net.register_forward_hook(leave, always_call=True)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


# The summary entries every rank must agree on (the wall-clock ones differ).
_AGREED = ("best_val_l1", "final_epoch_losses", "epochs_run", "steps_total")


def train_kaist(
    cfg: Config,
    *,
    device: str | torch.device | None = None,
    max_steps_per_epoch: int | None = None,
    jsonl: JsonlLogger | None = None,
    spatial_mesh: list | None = None,
) -> dict[str, Any]:
    """Run the training recipe on ``device`` (the card by default); returns a
    summary (best val L1, final-epoch mean losses, steps, throughput, state).
    ``max_steps_per_epoch`` truncates epochs for tests and smoke runs.
    ``spatial_mesh``: this rank's H-shard devices under ``sp_devices`` > 1
    (default: ``make_train_mesh``'s first rank's).

    Data parallelism: in a process group already up, or one a launcher's
    environment describes (``parallel.mesh.initialize_multihost``), this
    process trains as its rank. Else, where ``make_train_mesh`` gives more
    than one rank (``dp_devices``; 0: every card, fit to the batch), one
    process a rank is spawned (``parallel.launch``) and rank 0's summary is
    returned without ``state`` (the checkpoints hold it), after checking that
    every rank's agrees. Under a launcher's environment with ``sp_devices``
    > 1 a rank's shards share its device. ``sp_w_devices`` is not read,
    as in JAX (``train.state.without_sp_w``, logged)."""
    cfg = without_sp_w(cfg)
    if cfg.sp_devices > 1 and cfg.dp_mode != "gspmd":
        raise ValueError("spatially-sharded training (--sp-devices > 1) requires "
                         "dp_mode='gspmd' — the shard_map step partitions the batch axis only")
    sp = cfg.sp_devices > 1
    if not dist.is_initialized():
        env_dev = initialize_multihost(device=device)
        if env_dev is not None:
            device = env_dev
        else:
            mesh = make_train_mesh(cfg.dp_devices, cfg.sp_devices, cfg.batch_size, device)
            devices = [m[0] for m in mesh] if sp else mesh
            if len(devices) > 1:
                summaries = spawn(_train_rank, devices,
                                  (cfg, max_steps_per_epoch, *([mesh] if sp else [])))
                for r, s in enumerate(summaries[1:], start=1):
                    if any(s[k] != summaries[0][k] for k in _AGREED):
                        raise RuntimeError(f"rank {r}'s summary differs from rank 0's: "
                                           f"{[(k, s[k], summaries[0][k]) for k in _AGREED]}")
                return summaries[0]
            device = devices[0]
            if sp and spatial_mesh is None:
                spatial_mesh = mesh[0]
    rank = dist.get_rank() if dist.is_initialized() else 0
    if sp and spatial_mesh is None:  # a launcher's rank: its device S times
        spatial_mesh = rank_shard_devices(cfg.sp_devices, device, rank)
    if rank:
        logging.disable(logging.INFO)  # rank 0 logs
    try:
        return _train(cfg, resolve_device(device), max_steps_per_epoch,
                      jsonl if rank == 0 else JsonlLogger(None),
                      [torch.device(d) for d in spatial_mesh] if sp else None)
    finally:
        if rank:
            logging.disable(logging.NOTSET)


def _train_rank(rank: int, device: torch.device, cfg: Config,
                max_steps_per_epoch: int | None, mesh: list | None = None) -> dict[str, Any]:
    """A spawned rank's training (``mesh``: every rank's H-shard devices,
    under ``sp_devices`` > 1); its summary without the state."""
    summary = train_kaist(cfg, device=device, max_steps_per_epoch=max_steps_per_epoch,
                          spatial_mesh=None if mesh is None else mesh[rank])
    return {k: v for k, v in summary.items() if k != "state"}


def _train(cfg: Config, dev: torch.device, max_steps_per_epoch: int | None,
           jsonl: JsonlLogger | None, sp_mesh: list[torch.device] | None) -> dict[str, Any]:
    """The recipe on this rank (the only one without a process group);
    ``sp_mesh``: its H-shard devices (spatial training), whose first holds
    the state."""
    rank, n_ranks = world()
    own_jsonl = jsonl is None
    jsonl = jsonl or JsonlLogger(cfg.jsonl_log)
    h, w = cfg.resolved_hw
    if cfg.dp_mode not in ("gspmd", "shard_map"):
        raise ValueError(f"dp_mode must be 'gspmd' or 'shard_map', got {cfg.dp_mode!r}")
    if sp_mesh is not None:
        dev = sp_mesh[0]
        try:
            check_stage_heights(h, len(sp_mesh), 2)
        except ValueError as exc:
            raise ValueError(f"img height {h} with sp_devices={len(sp_mesh)}: {exc}") from None
    # Where a batch goes: this rank's device, or cut on H over its shards'.
    place = dev if sp_mesh is None else sp_mesh
    log.info("[TRAIN] Device: %s%s%s", dev, f" (rank 0 of {n_ranks}, {cfg.dp_mode})"
             if n_ranks > 1 else "",
             "" if sp_mesh is None else
             f", H over {len(sp_mesh)} shards on {[str(d) for d in sp_mesh]}")
    log.info("KAIST root (V000, V001, ...): %s", cfg.train_roots[0] if cfg.train_roots else "")

    all_ir, all_rgb = scan_kaist_pairs(list(cfg.train_roots))
    if not all_ir:
        raise RuntimeError(f"No IR-RGB pairs found under roots: {list(cfg.train_roots)}")
    n = len(all_ir)
    train_idx, val_idx = split_train_val(n, cfg.val_ratio, seed=42)
    log.info("Total pairs: %d, train: %d, val: %d", n, len(train_idx), len(val_idx))
    train_ds = KAISTPairDataset(
        [all_ir[i] for i in train_idx], [all_rgb[i] for i in train_idx],
        size_hw=(h, w), augment=True, seed=cfg.seed,
    )
    val_ds = KAISTPairDataset(
        [all_ir[i] for i in val_idx], [all_rgb[i] for i in val_idx],
        size_hw=(h, w), augment=False,
    )
    train_loader = BatchLoader(train_ds, cfg.batch_size, shuffle=True, drop_last=True,
                               num_workers=cfg.num_workers, seed=cfg.seed,
                               shard_index=rank, shard_count=n_ranks,
                               transport=cfg.batch_transport)
    val_loader = BatchLoader(val_ds, cfg.batch_size, shuffle=False, drop_last=False,
                             num_workers=cfg.num_workers, shard_index=rank,
                             shard_count=n_ranks, transport=cfg.batch_transport)
    steps_per_epoch = len(train_loader)
    if max_steps_per_epoch is not None:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    if steps_per_epoch == 0:
        raise RuntimeError("Not enough pairs for a single training batch")

    # The ranks meet once before the state's init and the first step, whose
    # time may differ by rank.
    warmup_mesh_collectives(dev)
    state = create_train_state(cfg, steps_per_epoch, dev, spatial_mesh=sp_mesh)
    if cfg.init_G_weights is not None and os.path.isfile(cfg.init_G_weights):
        log.info("Initializing generator from: %s", cfg.init_G_weights)
        load_state_permissive(state.g, load_netg_state(cfg.init_G_weights, state.g))

    vgg = None
    if cfg.lambda_perc != 0.0:
        vgg = load_vgg16(cfg.vgg16_weights, cfg.seed, _DTYPES[cfg.compute_dtype]).to(dev)
        if cfg.vgg16_weights is None:
            log.warning("WARNING: no pretrained VGG-16 weights supplied (cfg.vgg16_weights); "
                        "perceptual loss uses a deterministic random tower.")
    if n_ranks > 1:
        train_step = make_train_step_shardmap(cfg, vgg)
        val_step = make_val_sum_step_shardmap(state.g)
    else:
        train_step = make_train_step(cfg, vgg)
        val_step = make_val_sum_step(state.g)

    state_dir = cfg.orbax_dir or os.path.join(cfg.save_dir, "state")
    start_epoch = 1
    best_val_l1 = float("inf")
    if cfg.resume:
        last = latest_checkpoint(state_dir)
        if last is not None:
            extra = restore_full_state(state_dir, last, state)
            start_epoch = int(extra["epoch"]) + 1
            best_val_l1 = float(extra["best_val_l1"])
            log.info("Resumed from epoch %d (best val L1 %.4f)", last, best_val_l1)
            if start_epoch > cfg.epochs:
                log.warning("Resume checkpoint is at epoch %d but cfg.epochs=%d — nothing "
                            "left to train (raise --epochs to continue).", last, cfg.epochs)
    if n_ranks > 1:  # the replicas start equal whatever was loaded
        broadcast_replicas(state.g, state.d)

    os.makedirs(cfg.save_dir, exist_ok=True)
    best_stem = os.path.join(cfg.save_dir, "netG_best")

    def run_validation() -> float:
        # A short final batch is zero-padded to the full batch and masked,
        # so every validation batch takes the same kernel routes. With
        # several ranks each pads its slice (0 rows too) to its share of
        # the batch, and every rank sums the same totals, so all reach the
        # same val L1 and best-checkpoint decision.
        total = torch.zeros((), device=dev)
        count = torch.zeros((), device=dev)
        full = val_loader.batch_size // n_ranks
        for batch in val_loader:
            bsz = batch["ir"].shape[0]
            mask = np.zeros((full,), np.float32)
            mask[:bsz] = 1.0
            if bsz < full:
                batch = {k: np.concatenate([v, np.zeros((full - bsz, *v.shape[1:]), v.dtype)])
                         for k, v in batch.items()}
            s, c = val_step(shard_batch(batch, place), torch.from_numpy(mask).to(dev))
            total += s
            count += c
        return float(total) / max(float(count), 1.0)

    def run_epoch(epoch: int) -> list[torch.Tensor]:
        """The epoch's training steps; returns their packed metrics. The
        first epoch's first ``min(5, steps)`` steps are traced under
        ``profile_dir``; under ``debug_nans`` the steps run guarded."""
        nonlocal state
        epoch_metrics: list[torch.Tensor] = []
        trace = None
        if cfg.profile_dir is not None and epoch == start_epoch and rank == 0:
            trace = ProfilerTrace(cfg.profile_dir)
            trace.start()
        guard = _NanGuard({"G": state.g, "D": state.d}) if cfg.debug_nans else None
        try:
            for i, batch in enumerate(train_loader, start=1):
                if i > steps_per_epoch:
                    break
                if guard is None:
                    state, metrics = train_step(state, shard_batch(batch, place))
                else:
                    guard.where = f"epoch {epoch} step {i}"
                    with torch.autograd.detect_anomaly(check_nan=True):
                        state, metrics = train_step(state, shard_batch(batch, place))
                if trace is not None and trace.running and i >= min(5, steps_per_epoch):
                    synchronize(dev)
                    log.info("Profiler trace (first %d steps) written to %s", i, trace.stop())
                epoch_metrics.append(torch.stack([metrics[k] for k in METRIC_KEYS]))
                if i % cfg.log_every == 0 or i == 1:
                    m = dict(zip(METRIC_KEYS, epoch_metrics[-1].tolist()))
                    _check_loss_sanity(m, cfg, epoch, i)
                    log.info(
                        "Epoch [%d/%d] Step [%d/%d] D: %.4f | G: %.4f "
                        "(GAN %.4f + L1 %.4f + Perc %.4f + TV %.6f + SSIM %.4f)",
                        epoch, cfg.epochs, i, steps_per_epoch,
                        m["loss_D"], m["loss_G"], m["loss_G_GAN"], m["loss_G_L1"],
                        m["loss_G_perc"], m["loss_G_TV"], m["loss_G_SSIM"],
                    )
        finally:
            # A step that raises (the loss sanity check, debug_nans) still
            # ends the trace and the guard.
            if trace is not None:
                trace.stop()
            if guard is not None:
                guard.remove()
        return epoch_metrics

    summary: dict[str, Any] = {}
    steps_total = 0
    t_train0 = time.perf_counter()
    for epoch in range(start_epoch, cfg.epochs + 1):
        train_loader.set_epoch(epoch)
        t0 = time.perf_counter()
        epoch_metrics = run_epoch(epoch)
        synchronize(dev)
        dt = time.perf_counter() - t0
        steps_done = len(epoch_metrics)
        steps_total += steps_done
        if epoch_metrics:
            means = torch.stack(epoch_metrics).mean(dim=0).tolist()
            summary["final_epoch_losses"] = dict(zip(METRIC_KEYS, means))
            avg_d = summary["final_epoch_losses"]["loss_D"]
            avg_g = summary["final_epoch_losses"]["loss_G"]
        else:
            avg_d = avg_g = 0.0
        val_l1 = run_validation()
        sps = steps_done / dt if dt > 0 else 0.0
        log.info(
            "Epoch [%d/%d] DONE | avg D: %.4f | avg G: %.4f | val L1: %.4f "
            "| %.2f steps/s (%.1f frames/s)",
            epoch, cfg.epochs, avg_d, avg_g, val_l1, sps, sps * cfg.batch_size,
        )
        jsonl.log("epoch", epoch=epoch, avg_d=avg_d, avg_g=avg_g, val_l1=val_l1,
                  steps_per_sec=sps)

        is_best = val_l1 < best_val_l1
        if is_best:
            best_val_l1 = val_l1
        do_save = epoch % cfg.save_every == 0 or epoch == cfg.epochs
        if n_ranks > 1 and (do_save or is_best) and not replicas_equal(state.g, state.d):
            raise RuntimeError(f"epoch {epoch}: the ranks' parameters differ")
        if rank == 0:
            if do_save:
                save_full_state(state_dir, epoch, state,
                                {"epoch": epoch, "best_val_l1": best_val_l1, "val_l1": val_l1})
                written = save_netg_export(state.g,
                                           os.path.join(cfg.save_dir, f"netG_epoch_{epoch:03d}"))
                log.info("Saved generator checkpoint to %s", written[0])
            if is_best:
                save_netg_export(state.g, best_stem)
                log.info("New best model saved to %s (val L1=%.4f)", best_stem, best_val_l1)
        if n_ranks > 1:  # rank 0 writes while the others wait, in lockstep
            dist.barrier()

        next_lr = cfg.lr_G * linear_decay_factor(epoch + 1, cfg.lr_decay_start_epoch, cfg.epochs)
        log.info("Current LR (G): %.6e", next_lr)

    wall = time.perf_counter() - t_train0
    if own_jsonl:
        jsonl.close()
    log.info("Training finished. Best val L1: %.4f, best model: %s", best_val_l1, best_stem)
    summary.setdefault("final_epoch_losses", {})
    summary.update(
        best_val_l1=best_val_l1,
        epochs_run=max(0, cfg.epochs - start_epoch + 1),
        steps_total=steps_total,
        wall_s=wall,
        steps_per_sec=steps_total / wall if wall > 0 else 0.0,
        state=state,
    )
    return summary
