"""The training loop (``ircolor_tpu/train/loop.py``): data, state, epoch
loop, validation, checkpoints.

The reference recipe: scan the KAIST pairs once, seed-42 train/val split
(``val_ratio``), Adam for G and D with the linear LR decay, D-then-G
updates per batch, a loss line every ``log_every`` steps (and at step 1),
validation L1 per epoch, ``netG_epoch_{k:03d}.pth`` every ``save_every``
epochs and at the end, ``netG_best.pth`` on a val-L1 improvement (decided
before the full-state save, so a resume restores the right best), and the
next epoch's LR printed at each epoch's end. ``--resume`` continues from the
newest full state.

Every generator variant of ``Config`` trains (``norm``, ``no_antialias``,
``no_antialias_up``, ``remat``). Single device only; ``dp_devices``/
``sp_devices`` > 1 raise NotImplementedError (``reject_unported``), as do
``profile_dir``, ``debug_nans`` and ``.msgpack`` initial weights
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import os
import time
from typing import Any

import numpy as np
import torch

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.data.kaist import KAISTPairDataset, scan_kaist_pairs, split_train_val
from ircolor_tpu_torch.data.pipeline import BatchLoader
from ircolor_tpu_torch.losses.vgg import load_vgg16
from ircolor_tpu_torch.models.wrapper import (
    _DTYPES,
    load_state_permissive,
    reject_unported,
    resolve_device,
)
from ircolor_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_full_state,
    save_full_state,
    save_netg_pth,
)
from ircolor_tpu_torch.train.schedule import linear_decay_factor
from ircolor_tpu_torch.train.state import create_train_state
from ircolor_tpu_torch.train.step import METRIC_KEYS, make_train_step, make_val_sum_step
from ircolor_tpu_torch.utils.logging import JsonlLogger, get_logger

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


def _reject_unported(cfg: Config) -> None:
    reject_unported(cfg, train=True)
    if cfg.profile_dir is not None:
        raise NotImplementedError("profile_dir is not ported yet (ROADMAP.md, Queue 1)")
    if cfg.debug_nans:
        raise NotImplementedError("debug_nans is not ported yet (ROADMAP.md, Queue 1)")
    if cfg.init_G_weights is not None and not cfg.init_G_weights.endswith((".pth", ".pt")):
        raise NotImplementedError(".msgpack initial weights are not ported yet (ROADMAP.md, Queue 1)")


def _to_device(batch: dict[str, np.ndarray], dev: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def train_kaist(
    cfg: Config,
    *,
    device: str | torch.device | None = None,
    max_steps_per_epoch: int | None = None,
    jsonl: JsonlLogger | None = None,
) -> dict[str, Any]:
    """Run the training recipe on ``device`` (the card by default); returns a
    summary (best val L1, final-epoch mean losses, steps, throughput, state).
    ``max_steps_per_epoch`` truncates epochs for tests and smoke runs."""
    _reject_unported(cfg)
    dev = resolve_device(device)
    own_jsonl = jsonl is None
    jsonl = jsonl or JsonlLogger(cfg.jsonl_log)
    h, w = cfg.resolved_hw
    log.info("[TRAIN] Device: %s", dev)
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
                               transport=cfg.batch_transport)
    val_loader = BatchLoader(val_ds, cfg.batch_size, shuffle=False, drop_last=False,
                             num_workers=cfg.num_workers, transport=cfg.batch_transport)
    steps_per_epoch = len(train_loader)
    if max_steps_per_epoch is not None:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    if steps_per_epoch == 0:
        raise RuntimeError("Not enough pairs for a single training batch")

    state = create_train_state(cfg, steps_per_epoch, dev)
    if cfg.init_G_weights is not None and os.path.isfile(cfg.init_G_weights):
        log.info("Initializing generator from: %s", cfg.init_G_weights)
        load_state_permissive(state.g, torch.load(cfg.init_G_weights, map_location=dev,
                                                  weights_only=True))

    vgg = None
    if cfg.lambda_perc != 0.0:
        vgg = load_vgg16(cfg.vgg16_weights, cfg.seed, _DTYPES[cfg.compute_dtype]).to(dev)
        if cfg.vgg16_weights is None:
            log.warning("WARNING: no pretrained VGG-16 weights supplied (cfg.vgg16_weights); "
                        "perceptual loss uses a deterministic random tower.")
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

    os.makedirs(cfg.save_dir, exist_ok=True)
    best_stem = os.path.join(cfg.save_dir, "netG_best")

    def run_validation() -> float:
        # A short final batch is zero-padded to the full batch and masked,
        # so every validation batch takes the same kernel routes.
        total = torch.zeros((), device=dev)
        count = torch.zeros((), device=dev)
        full = val_loader.batch_size
        for batch in val_loader:
            bsz = batch["ir"].shape[0]
            mask = np.zeros((full,), np.float32)
            mask[:bsz] = 1.0
            if bsz < full:
                batch = {k: np.concatenate([v, np.zeros((full - bsz, *v.shape[1:]), v.dtype)])
                         for k, v in batch.items()}
            s, c = val_step(_to_device(batch, dev), torch.from_numpy(mask).to(dev))
            total += s
            count += c
        return float(total) / max(float(count), 1.0)

    summary: dict[str, Any] = {}
    steps_total = 0
    t_train0 = time.perf_counter()
    for epoch in range(start_epoch, cfg.epochs + 1):
        epoch_metrics: list[torch.Tensor] = []
        train_loader.set_epoch(epoch)
        t0 = time.perf_counter()
        for i, batch in enumerate(train_loader, start=1):
            if i > steps_per_epoch:
                break
            state, metrics = train_step(state, _to_device(batch, dev))
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
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
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
        if epoch % cfg.save_every == 0 or epoch == cfg.epochs:
            save_full_state(state_dir, epoch, state,
                            {"epoch": epoch, "best_val_l1": best_val_l1, "val_l1": val_l1})
            written = save_netg_pth(state.g, os.path.join(cfg.save_dir, f"netG_epoch_{epoch:03d}"))
            log.info("Saved generator checkpoint to %s", written)
        if is_best:
            save_netg_pth(state.g, best_stem)
            log.info("New best model saved to %s (val L1=%.4f)", best_stem, best_val_l1)

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
