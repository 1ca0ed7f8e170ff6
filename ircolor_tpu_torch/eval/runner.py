"""Test mode: the serving step plus metrics and artifact export
(``ircolor_tpu/eval/runner.py``), on one device or, with ``sp_devices`` >
1, with the image rows sharded over a 1-D H mesh (``spatial_generator``).

``make_infer_fn`` is the step a user pays for: it decodes the integer
transport (uint16 or uint8 IR, uint8 GT) on the device, runs the generator,
quantizes the prediction to uint8 and computes per-image MAE/MSE/PSNR/SSIM
on the quantized prediction. ``run_test`` feeds it fixed-size batches (the
last one zero-padded, so every batch takes the same kernel routes) from
host decode threads, starts each batch's device→host copy as soon as the
step is queued, writes the mirrored predictions, collages,
``metrics_test.csv`` with its "# Summary" block and the Top-K folder.

Every generator variant of ``Config`` serves (``norm``, ``no_antialias``,
``no_antialias_up``; batch norm on its running statistics), on one device
or data-parallel (``dp_devices`` > 1, ``make_infer_fn``'s ``dp_mesh``: each
device serves whole images of the batch; exclusive with ``sp_devices``, as
in JAX). 2-D H×W tiling is not ported yet, and ``reject_unported`` rejects
it; the generator's spatial forward rejects the variants under
``sp_devices`` > 1.
"""

from __future__ import annotations

import copy
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.data.io import load_ir_image, load_rgb_image, save_rgb
from ircolor_tpu_torch.data.kaist import collect_kaist_ir_files_from_sets
from ircolor_tpu_torch.eval.metrics import batched_metrics, quantize_to_uint8_01
from ircolor_tpu_torch.export.collage import make_comparison_collage, save_comparison_image
from ircolor_tpu_torch.export.topk import save_best_k_outputs, write_metrics_csv
from ircolor_tpu_torch.models.wrapper import IRColorizationModel, reject_unported
from ircolor_tpu_torch.parallel.mesh import make_data_mesh
from ircolor_tpu_torch.parallel.spatial import (
    check_stage_heights,
    gather_h,
    make_spatial_mesh,
    shard_h,
)
from ircolor_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_MKEYS = ("mae", "mse", "psnr", "ssim")


def spatial_generator(cfg: Config, module: torch.nn.Module,
                      device: str | torch.device | None = None) -> torch.nn.Module:
    """The generator for test mode over ``cfg.sp_devices`` H-shards (JAX
    ``runner.py:186-260``, its 1-D H mesh): a copy of ``module`` with the
    norm-blur tails and the head off (they reflect at the image's edges)
    and ``spatial_mesh`` set, so the fused blocks run their halo forms per
    shard. The mesh: every shard on ``device`` where it names one
    (``"cpu"``, or ``"cuda:i"``), else (None or ``"cuda"``) the shards
    spread over the visible cards (raises where there are fewer). H must
    divide by the shard count, as in JAX, and the bottleneck (after the two
    stride-2 stages) keep a row a shard."""
    n = cfg.sp_devices
    h = cfg.resolved_hw[0]
    try:
        check_stage_heights(h, n, 2)
    except ValueError as exc:
        raise ValueError(f"img height {h} with sp_devices={n}: {exc}") from None
    dev = None if device is None else torch.device(device)
    if dev is None or (dev.type == "cuda" and dev.index is None):
        mesh = make_spatial_mesh(n)
    else:
        mesh = make_spatial_mesh(n, [dev] * n)
    log.info("[TEST] spatial sharding: rebuilding generator with pallas_norm_blur=False / "
             "pallas_head=False (in-kernel reflect halos are incompatible with image-axis "
             "sharding); fused resblocks run their halo forms per shard where the per-shard "
             "gate holds; H %d over %s", h, [str(d) for d in mesh])
    spatial = copy.deepcopy(module)
    spatial.pallas_norm_blur = spatial.pallas_head = False
    spatial.spatial_mesh = mesh
    return spatial


def make_infer_fn(module: torch.nn.Module, dp_mesh: list[torch.device] | None = None):
    """One serving step on NHWC tensors already on the module's device:
    ``(ir, gt01) → (uint8 RGB prediction, {mae, mse, psnr, ssim})``.

    ``ir`` is uint16 ``round(ir01·65535)``, uint8 ``round(ir01·255)`` or
    float in [−1, 1]; ``gt01`` uint8 ``round(gt01·255)`` or float in [0, 1].
    The prediction arithmetic runs in the generator's compute dtype, as the
    JAX step's does. With the module's ``spatial_mesh`` set
    (``spatial_generator``) the decoded batch is sharded over the mesh and
    the prediction gathered onto shard 0's device before the uint8 step and
    the metrics (SSIM's window crosses the seams).

    ``dp_mesh`` (data-parallel test mode, JAX's ``dp_mesh``; a list of
    devices, ``parallel.mesh.make_data_mesh``): the batch is split into
    equal contiguous chunks, one a mesh entry, each run through the whole
    step (decode, generator, uint8, metrics) on a replica of the module on
    that entry's device (one replica a distinct device), routed by the
    gates at the chunk's batch; the outputs are concatenated in order on
    the first entry's device. The batch must divide by the mesh size."""
    mesh = getattr(module, "spatial_mesh", None)
    if dp_mesh is not None:
        home = next(module.parameters()).device
        replicas: dict[torch.device, torch.nn.Module] = {}
        for dev in dp_mesh:
            if dev not in replicas:
                replicas[dev] = module if dev == home else copy.deepcopy(module).to(dev)
        steps = {dev: make_infer_fn(m) for dev, m in replicas.items()}

        @torch.inference_mode()
        def infer_dp(ir: torch.Tensor, gt01: torch.Tensor):
            n = len(dp_mesh)
            if ir.shape[0] % n:
                raise ValueError(f"batch {ir.shape[0]} must divide by the {n}-device data mesh")
            # Every chunk's copy is queued before any chunk's step: a copy
            # off the first device waits for the work already queued there.
            chunks = [(x.to(dev), g.to(dev))
                      for dev, x, g in zip(dp_mesh, ir.chunk(n), gt01.chunk(n))]
            outs = [steps[dev](x, g) for dev, (x, g) in zip(dp_mesh, chunks)]
            first = dp_mesh[0]
            pred = torch.cat([p.to(first) for p, _ in outs])
            return pred, {k: torch.cat([m[k].to(first) for _, m in outs]) for k in outs[0][1]}

        return infer_dp

    @torch.inference_mode()
    def infer(ir: torch.Tensor, gt01: torch.Tensor):
        if ir.dtype == torch.uint16:
            ir = ir.float() / 65535.0 * 2.0 - 1.0
        elif ir.dtype == torch.uint8:
            ir = ir.float() / 255.0 * 2.0 - 1.0
        if gt01.dtype == torch.uint8:
            gt01 = gt01.float() / 255.0
        if mesh is None:
            fake = module(ir)                               # (B, H, W, 3) [-1, 1]
        else:
            fake = gather_h(module(shard_h(ir, mesh)))
            gt01 = gt01.to(fake.device)
        pred01q = quantize_to_uint8_01((fake + 1.0) / 2.0)
        pred_u8 = (pred01q * 255.0).to(torch.uint8)
        return pred_u8, batched_metrics(pred01q, gt01)

    return infer


def _decode_one(entry: tuple[str, str, str], size_hw: tuple[int, int]):
    """Host decode of one frame plus its integer transport encodings."""
    ir_path, set_name, seq_rel = entry
    ir01, ir_depth = load_ir_image(ir_path, size_hw, return_depth=True)
    base = os.path.basename(ir_path)
    vis_dir = os.path.join(os.path.dirname(os.path.dirname(ir_path)), "visible")
    gt_path = os.path.join(vis_dir, base)
    has_vis_dir = os.path.isdir(vis_dir)
    gt01 = load_rgb_image(gt_path, size_hw) if has_vis_dir and os.path.isfile(gt_path) else None
    out_rel = os.path.join(set_name, seq_rel, base)
    if ir_depth == 8:
        ir_enc = np.rint(ir01 * 255.0).astype(np.uint8)
    else:
        ir_enc = np.rint(ir01 * 65535.0).astype(np.uint16)
    gt_enc = None if gt01 is None else np.rint(gt01 * 255.0).astype(np.uint8)
    return ir01, gt01, out_rel, base, gt_path, has_vis_dir, ir_enc, gt_enc


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """Start a device→host copy without waiting for it."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def run_test(cfg: Config, device: str | torch.device | None = None) -> dict[str, Any]:
    """Batched test mode on ``device`` (the card by default; raises without
    one unless ``device="cpu"``); returns the summary dict (also logged and
    saved)."""
    reject_unported(cfg)
    bsz = cfg.resolved_test_batch_size
    dp_mesh = None
    if cfg.dp_devices > 1:
        if cfg.sp_devices > 1:
            raise ValueError(
                "test mode: dp_devices and sp_devices are mutually exclusive "
                "(batch-parallel vs image-spatial sharding; pick one)"
            )
        dp_mesh = make_data_mesh(cfg.dp_devices, device=device)
        if bsz % len(dp_mesh):
            raise ValueError(
                f"test_batch_size {bsz} must divide by dp_devices {len(dp_mesh)} "
                "(each device infers batch/dp_devices whole images)"
            )
    os.makedirs(cfg.output_dir, exist_ok=True)
    if not cfg.test_roots:
        raise ValueError("cfg.test_roots is empty. Please set cfg.test_roots to KAIST set paths.")
    entries = collect_kaist_ir_files_from_sets(list(cfg.test_roots))
    log.info("Found %d IR images across test sets: %s", len(entries), list(cfg.test_roots))

    model = IRColorizationModel(cfg, device)
    log.info("[TEST] Device: %s", model.device)
    if cfg.test_G_weights is not None and os.path.isfile(cfg.test_G_weights):
        log.info("Loading generator weights from: %s", cfg.test_G_weights)
        model.load_weights(cfg.test_G_weights)
    else:
        log.warning(
            "WARNING: cfg.test_G_weights is None or does not exist; "
            "generator is randomly initialized, results will be meaningless."
        )
    size_hw = cfg.resolved_hw
    module = model.module if cfg.sp_devices <= 1 else spatial_generator(cfg, model.module, device)
    if dp_mesh is not None:
        log.info("[TEST] Data parallel: batch %d over %s", bsz, [str(d) for d in dp_mesh])
    infer = make_infer_fn(module, dp_mesh)

    metrics_list: list[dict[str, Any]] = []
    sums = {k: 0.0 for k in _MKEYS}
    count = done = 0
    best_psnr, best_psnr_sample = -1.0, None
    best_ssim, best_ssim_sample = -1.0, None

    decode_pool = ThreadPoolExecutor(max_workers=max(1, cfg.num_workers))
    # A separate orchestrator thread: decode_batch fans out onto decode_pool.
    prefetch_pool = ThreadPoolExecutor(max_workers=1)
    writer_pool = ThreadPoolExecutor(max_workers=max(1, cfg.num_workers))
    write_futures: list[Any] = []
    batches = [entries[i : i + bsz] for i in range(0, len(entries), bsz)]

    def decode_batch(batch):
        return list(decode_pool.map(lambda e: _decode_one(e, size_hw), batch))

    def write_collage(out_rel, ir01, pred, gt01, metrics_text):
        collage = make_comparison_collage(
            ir01_hw=ir01, pred_u8_hwc=pred, gt01_hwc=gt01,
            add_text=cfg.comparison_add_text, pad=cfg.comparison_pad,
            font_scale=cfg.comparison_font_scale, thickness=cfg.comparison_thickness,
            metrics_text=metrics_text,
        )
        save_comparison_image(cfg, out_rel, collage)

    def consume(decoded, has_gt, pred_host, m_host, ready):
        nonlocal count, done, best_psnr, best_psnr_sample, best_ssim, best_ssim_sample
        if ready is not None:
            ready.synchronize()
        pred_u8 = pred_host.numpy()
        m = {k: m_host[i].numpy() for i, k in enumerate(_MKEYS)}
        for j, d in enumerate(decoded):
            ir01, gt01, out_rel, base, gt_path, has_vis_dir = d[:6]
            out_path = os.path.join(cfg.output_dir, out_rel)
            pred = pred_u8[j]
            write_futures.append(writer_pool.submit(save_rgb, out_path, pred))
            psnr_val = ssim_val = None
            if has_gt[j]:
                mae, mse = float(m["mae"][j]), float(m["mse"][j])
                psnr_val, ssim_val = float(m["psnr"][j]), float(m["ssim"][j])
                metrics_list.append(
                    {"file": out_rel, "mae": mae, "mse": mse, "psnr": psnr_val, "ssim": ssim_val}
                )
                sums["mae"] += mae
                sums["mse"] += mse
                # The reference's accumulation: an inf PSNR (exact uint8
                # match) is left out of the sum but counted in the mean.
                if np.isfinite(psnr_val):
                    sums["psnr"] += psnr_val
                sums["ssim"] += ssim_val
                count += 1
                if np.isfinite(psnr_val) and psnr_val > best_psnr:
                    best_psnr, best_psnr_sample = psnr_val, out_rel
                if ssim_val > best_ssim:
                    best_ssim, best_ssim_sample = ssim_val, out_rel
            elif has_vis_dir:
                log.warning("[WARN] No GT RGB found for %s at %s; metrics skipped for this image.",
                            base, gt_path)
            if cfg.save_comparisons:
                metrics_text = None
                if psnr_val is not None:
                    metrics_text = f"PSNR={psnr_val:.2f}dB  SSIM={ssim_val:.4f}"
                write_futures.append(
                    writer_pool.submit(write_collage, out_rel, ir01, pred, gt01, metrics_text)
                )
            done += 1
            if done % 50 == 0 or done == len(entries):
                log.info("[%d/%d] %s -> %s", done, len(entries), base, out_path)

    t0 = time.perf_counter()
    pending = prefetch_pool.submit(decode_batch, batches[0]) if batches else None
    in_flight = None
    for bi in range(len(batches)):
        decoded = pending.result()
        if bi + 1 < len(batches):
            pending = prefetch_pool.submit(decode_batch, batches[bi + 1])
        ir_dt = np.uint8 if all(d[6].dtype == np.uint8 for d in decoded) else np.uint16
        ir_np = np.zeros((bsz, *size_hw, 1), ir_dt)
        gt_np = np.zeros((bsz, *size_hw, 3), np.uint8)
        has_gt = np.zeros((bsz,), bool)
        for j, d in enumerate(decoded):
            ir_enc, gt_enc = d[6], d[7]
            # A mixed batch widens 8-bit frames: k·257/65535 == k/255.
            ir_np[j, :, :, 0] = ir_enc if ir_enc.dtype == ir_dt else ir_enc.astype(np.uint16) * 257
            if gt_enc is not None:
                gt_np[j] = gt_enc
                has_gt[j] = True
        ir_dev = torch.from_numpy(ir_np).to(model.device)
        gt_dev = torch.from_numpy(gt_np).to(model.device)
        pred, m = infer(ir_dev, gt_dev)
        pred_host = _to_host_async(pred)
        m_host = _to_host_async(torch.stack([m[k] for k in _MKEYS]))
        ready = None
        if pred.is_cuda:
            ready = torch.cuda.Event()
            ready.record()
        # Consume the previous batch while this one runs on the device.
        if in_flight is not None:
            consume(*in_flight)
        in_flight = (decoded, has_gt, pred_host, m_host, ready)
    if in_flight is not None:
        consume(*in_flight)
    for f in write_futures:
        f.result()
    decode_pool.shutdown()
    prefetch_pool.shutdown()
    writer_pool.shutdown()
    elapsed = time.perf_counter() - t0
    log.info("Test finished.")
    if done:
        log.info("End-to-end: %d frames in %.1f s (%.1f frames/s)", done, elapsed, done / elapsed)

    summary: dict[str, Any] = {"count": count}
    if count > 0:
        mean_mae, mean_mse = sums["mae"] / count, sums["mse"] / count
        mean_psnr, mean_ssim = sums["psnr"] / count, sums["ssim"] / count
        summary.update(
            mean_mae=mean_mae, mean_mse=mean_mse, mean_psnr=mean_psnr, mean_ssim=mean_ssim,
            best_psnr=best_psnr, best_psnr_sample=best_psnr_sample,
            best_ssim=best_ssim, best_ssim_sample=best_ssim_sample,
        )
        log.info("\n=== Test Metrics (on images with GT) ===")
        log.info("Count      : %d", count)
        log.info("Mean MAE   : %.6f", mean_mae)
        log.info("Mean MSE   : %.6f", mean_mse)
        log.info("Mean PSNR  : %.4f dB", mean_psnr)
        log.info("Mean SSIM  : %.6f", mean_ssim)
        if best_psnr_sample:
            log.info("Best PSNR  : %.4f (%s)", best_psnr, best_psnr_sample)
        if best_ssim_sample:
            log.info("Best SSIM  : %.6f (%s)", best_ssim, best_ssim_sample)
        metrics_path = os.path.join(cfg.output_dir, "metrics_test.csv")
        write_metrics_csv(metrics_path, metrics_list, count, mean_mae, mean_mse, mean_psnr, mean_ssim)
        log.info("\nMetrics saved to: %s", metrics_path)
        save_best_k_outputs(cfg, metrics_list)
    else:
        log.info("No metrics were computed (no matching GT RGB images found).")
    return summary
