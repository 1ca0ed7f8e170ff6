"""Top-K export and metrics CSV writers (``ircolor_tpu/export/topk.py``).

* ``save_best_k_outputs``: rank by SSIM when any is present, else PSNR;
  drop None/non-finite; sort descending; take the top ``max(1, topk)``;
  write ``top_{K}_ranking.csv`` (``rank,file,mae,mse,psnr,ssim,metric_used``);
  copy predictions and collages into flat
  ``<best50_dirname>/{colored,collages}/`` dirs with ``set__seq__name``
  naming (collage destination ``<flat_stem>__cmp.png``).
* ``write_metrics_csv``: the per-image ``metrics_test.csv`` + ``# Summary``
  comment block written at the end of ``run_test``.

Formats are byte-compatible with the JAX package's.
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import numpy as np

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def save_best_k_outputs(cfg: Config, metrics_list: list[dict[str, Any]]) -> None:
    if not metrics_list:
        log.info("[TOP-K] metrics_list empty, skipping top-K save.")
        return

    if any(m.get("ssim") is not None for m in metrics_list):
        metric_key = "ssim"
    else:
        metric_key = "psnr"

    valid = []
    for m in metrics_list:
        v = m.get(metric_key, None)
        if v is None:
            continue
        if isinstance(v, float) and not np.isfinite(v):
            continue
        valid.append(m)
    if not valid:
        log.info("[TOP-K] No valid '%s' values, skipping top-K save.", metric_key)
        return

    valid.sort(key=lambda x: x[metric_key], reverse=True)
    top_k = valid[: max(1, int(cfg.topk))]

    best_dir = os.path.join(cfg.output_dir, cfg.best50_dirname)
    preds_sub = os.path.join(best_dir, cfg.best50_preds_subdir)
    colls_sub = os.path.join(best_dir, cfg.best50_collages_subdir)
    os.makedirs(preds_sub, exist_ok=True)
    os.makedirs(colls_sub, exist_ok=True)

    rank_path = os.path.join(best_dir, f"top_{len(top_k)}_ranking.csv")
    with open(rank_path, "w", encoding="utf-8") as f:
        f.write("rank,file,mae,mse,psnr,ssim,metric_used\n")
        for r, m in enumerate(top_k, start=1):
            ssim_val = m.get("ssim", None)
            ssim_str = "" if ssim_val is None else f"{ssim_val:.6f}"
            f.write(
                f"{r},{m['file']},{m['mae']:.8f},{m['mse']:.8f},"
                f"{m['psnr']:.6f},{ssim_str},{metric_key}\n"
            )

    copied_preds = copied_colls = 0
    for m in top_k:
        rel_norm = m["file"].replace("\\", "/")
        subdir = os.path.dirname(rel_norm)
        stem = os.path.splitext(os.path.basename(rel_norm))[0]
        flat_base = rel_norm.replace("/", "__")
        flat_stem = os.path.splitext(flat_base)[0]

        if cfg.best50_copy_preds:
            src_pred = os.path.join(cfg.output_dir, m["file"])
            if os.path.isfile(src_pred):
                shutil.copy2(src_pred, os.path.join(preds_sub, flat_base))
                copied_preds += 1
            else:
                log.warning("[TOP-K][WARN] Missing prediction, cannot copy: %s", src_pred)

        # When comparisons are disabled no collages exist — skip the copy
        # attempts instead of warning per image (the reference always has
        # them because its save_comparisons defaults on, ref :127).
        if cfg.best50_copy_collages and cfg.save_comparisons:
            src_cmp = os.path.join(cfg.output_dir, cfg.comparison_dirname, subdir, f"{stem}_cmp.png")
            if not os.path.isfile(src_cmp):
                alt = os.path.join(cfg.output_dir, cfg.comparison_dirname, subdir, f"{stem}_cmp.jpg")
                if os.path.isfile(alt):
                    src_cmp = alt
            if os.path.isfile(src_cmp):
                shutil.copy2(src_cmp, os.path.join(colls_sub, f"{flat_stem}__cmp.png"))
                copied_colls += 1
            else:
                log.warning("[TOP-K][WARN] Missing collage, cannot copy: %s", src_cmp)

    log.info("[TOP-K] Saved best outputs to: %s", best_dir)
    log.info("[TOP-K] Colored copied : %d/%d -> %s", copied_preds, len(top_k), preds_sub)
    log.info("[TOP-K] Collage copied : %d/%d -> %s", copied_colls, len(top_k), colls_sub)
    log.info("[TOP-K] Ranking file   : %s", rank_path)


def write_metrics_csv(
    path: str,
    metrics_list: list[dict[str, Any]],
    count: int,
    mean_mae: float,
    mean_mse: float,
    mean_psnr: float,
    mean_ssim: float | None,
) -> None:
    """Per-image rows + '# Summary' block (ref :1492-1507), byte-compatible."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("file,mae,mse,psnr,ssim\n")
        for m in metrics_list:
            ssim_str = "" if m["ssim"] is None else f"{m['ssim']:.6f}"
            f.write(f"{m['file']},{m['mae']:.8f},{m['mse']:.8f},{m['psnr']:.6f},{ssim_str}\n")
        f.write("\n# Summary\n")
        f.write(f"# count,{count}\n")
        f.write(f"# mean_mae,{mean_mae:.8f}\n")
        f.write(f"# mean_mse,{mean_mse:.8f}\n")
        f.write(f"# mean_psnr,{mean_psnr:.6f}\n")
        if mean_ssim is not None:
            f.write(f"# mean_ssim,{mean_ssim:.6f}\n")
        else:
            f.write("# mean_ssim,\n")
