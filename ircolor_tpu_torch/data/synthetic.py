"""Synthetic KAIST directory trees (``ircolor_tpu/data/synthetic.py``, copied:
the port imports nothing of the JAX package) for the int8 budget
without a dataset.

The real KAIST Multispectral Pedestrian Dataset is not shipped. The tree
has the layout the scanners expect:

    <root>/setXX/<seq...>/lwir/INNNNN.png
    <root>/setXX/<seq...>/visible/INNNNN.png

IR frames are structured gradients + blobs, and RGB is a fixed colormap of
IR, so colorization is learnable.
"""

from __future__ import annotations

import os

import numpy as np


def _synth_pair(h: int, w: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic (ir_u8 HxW, rgb_u8 HxWx3 in BGR for cv2.imwrite)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ir = 0.5 + 0.4 * np.sin(xx / w * 4 * np.pi + seed) * np.cos(yy / h * 2 * np.pi)
    cx, cy, r = rng.randint(0, w), rng.randint(0, h), max(3, min(h, w) // 4)
    blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r**2)))
    ir = np.clip(ir + 0.5 * blob, 0, 1)
    # RGB as a fixed colormap of IR: learnable mapping for tiny train runs.
    r_ch = np.clip(1.5 * ir - 0.2, 0, 1)
    g_ch = np.clip(1.0 - np.abs(ir - 0.5) * 2.0, 0, 1)
    b_ch = np.clip(0.9 - ir, 0, 1)
    rgb = np.stack([b_ch, g_ch, r_ch], axis=2)  # BGR for cv2.imwrite
    return (ir * 255).astype(np.uint8), (rgb * 255).astype(np.uint8)


def make_kaist_tree(root: str, sets: dict[str, dict[str, int]], size_hw: tuple[int, int]) -> int:
    """Materialize a synthetic KAIST tree of PNG pairs. Returns the number
    of pairs written.

    ``sets`` maps set name → {sequence relpath → frame count}, e.g.
    ``{"set00": {"V000": 4, "V001/nested": 2}}``.
    """
    import cv2

    h, w = size_hw
    seed = 0
    for set_name, seqs in sets.items():
        for seq_rel, count in seqs.items():
            lwir = os.path.join(root, set_name, seq_rel, "lwir")
            vis = os.path.join(root, set_name, seq_rel, "visible")
            os.makedirs(lwir, exist_ok=True)
            os.makedirs(vis, exist_ok=True)
            for i in range(count):
                ir_u8, rgb_u8 = _synth_pair(h, w, seed)
                seed += 1
                cv2.imwrite(os.path.join(lwir, f"I{i:05d}.png"), ir_u8)
                cv2.imwrite(os.path.join(vis, f"I{i:05d}.png"), rgb_u8)
    return seed
