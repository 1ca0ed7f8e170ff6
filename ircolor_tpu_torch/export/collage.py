"""IR | Pred | GT comparison collages (``ircolor_tpu/export/collage.py``):
``pad``-px black gutters, the GT column only when GT exists, optional cv2
labels, written to ``<output_dir>/<comparison_dirname>/<subdirs>/<stem>_cmp.png``."""

from __future__ import annotations

import os

import numpy as np

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.data.io import float01_to_uint8_rgb, save_rgb


def make_comparison_collage(
    ir01_hw: np.ndarray,
    pred_u8_hwc: np.ndarray,
    gt01_hwc: np.ndarray | None = None,
    add_text: bool = True,
    pad: int = 8,
    font_scale: float = 0.6,
    thickness: int = 2,
    metrics_text: str | None = None,
) -> np.ndarray:
    imgs = [float01_to_uint8_rgb(ir01_hw), pred_u8_hwc]
    if gt01_hwc is not None:
        imgs.append(float01_to_uint8_rgb(gt01_hwc))
    h = imgs[0].shape[0]
    widths = [im.shape[1] for im in imgs]
    canvas = np.zeros((h, sum(widths) + pad * (len(imgs) - 1), 3), dtype=np.uint8)
    x = 0
    for im in imgs:
        canvas[:, x : x + im.shape[1], :] = im
        x += im.shape[1] + pad
    if add_text:
        import cv2

        font, white = cv2.FONT_HERSHEY_SIMPLEX, (255, 255, 255)
        cv2.putText(canvas, "IR", (10, 30), font, font_scale, white, thickness, cv2.LINE_AA)
        cv2.putText(canvas, "Pred", (widths[0] + pad + 10, 30), font, font_scale, white,
                    thickness, cv2.LINE_AA)
        if gt01_hwc is not None:
            x_gt = widths[0] + pad + widths[1] + pad + 10
            cv2.putText(canvas, "GT", (x_gt, 30), font, font_scale, white, thickness, cv2.LINE_AA)
        if metrics_text is not None:
            cv2.putText(canvas, metrics_text, (10, h - 12), font, font_scale, white,
                        thickness, cv2.LINE_AA)
    return canvas


def save_comparison_image(cfg: Config, out_rel: str, collage_u8_hwc: np.ndarray) -> str:
    stem, _ = os.path.splitext(os.path.basename(out_rel))
    cmp_dir = os.path.join(cfg.output_dir, cfg.comparison_dirname, os.path.dirname(out_rel))
    os.makedirs(cmp_dir, exist_ok=True)
    cmp_path = os.path.join(cmp_dir, f"{stem}_cmp.png")
    save_rgb(cmp_path, collage_u8_hwc)
    return cmp_path
