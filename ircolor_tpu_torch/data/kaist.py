"""KAIST discovery, pairing and splits (``ircolor_tpu/data/kaist.py``).

* ``collect_kaist_ir_files_from_sets``: every image under a directory named
  ``lwir`` (any case) that has a ``visible`` sibling, sorted, as
  ``(ir_path, set_name, seq_rel)`` — the test set.
* ``scan_kaist_pairs``: IR/RGB pairs by file-name intersection of each
  sequence's ``lwir``/``visible`` directories — the training set.
* ``split_train_val``: the reference's seed-42 split, bit for bit
  (``random.Random(42).shuffle``, ``val = max(1, int(N·val_ratio))``).
* ``KAISTPairDataset``: decoded pairs with the paired horizontal flip
  (p = 0.5) drawn from ``(seed, epoch, index)``, as float arrays in [−1, 1]
  (``__getitem__``), the integer transport (``int_item``) or the uint8
  frames the native batch assembler takes (``raw_item``).

cv2 is imported inside the functions that read files.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from ircolor_tpu_torch.data.io import load_ir_image, load_rgb_image
from ircolor_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def _list_imgs(folder: str) -> list[str]:
    if not os.path.isdir(folder):
        return []
    return sorted(
        os.path.join(folder, fn) for fn in os.listdir(folder) if fn.lower().endswith(IMAGE_EXTS)
    )


def _walk_lwir_dirs(root: str) -> Iterable[tuple[str, str]]:
    for dirpath, _dirnames, _filenames in os.walk(root):
        if os.path.basename(dirpath).lower() != "lwir":
            continue
        vis_dir = os.path.join(os.path.dirname(dirpath), "visible")
        if os.path.isdir(vis_dir):
            yield dirpath, vis_dir


def collect_kaist_ir_files_from_sets(set_roots: str | Sequence[str]) -> list[tuple[str, str, str]]:
    if isinstance(set_roots, (str, bytes)):
        set_roots = [set_roots]
    entries: list[tuple[str, str, str]] = []
    for root in set_roots:
        if not os.path.isdir(root):
            log.warning("[WARN] set root not found: %s", root)
            continue
        set_name = os.path.basename(root.rstrip("\\/"))
        for lwir_dir, _vis_dir in _walk_lwir_dirs(root):
            ir_files = _list_imgs(lwir_dir)
            if not ir_files:
                continue
            seq_rel = os.path.relpath(os.path.dirname(lwir_dir), root)
            entries.extend((p, set_name, seq_rel) for p in ir_files)
    return entries


def scan_kaist_pairs(roots: str | Sequence[str]) -> tuple[list[str], list[str]]:
    """File-name intersection pairing across all sequences under ``roots``."""
    if isinstance(roots, (str, bytes)):
        roots = [roots]
    all_ir: list[str] = []
    all_rgb: list[str] = []
    for root in roots:
        if not os.path.isdir(root):
            continue
        for lwir_dir, vis_dir in _walk_lwir_dirs(root):
            ir_map = {os.path.basename(p): p for p in _list_imgs(lwir_dir)}
            rgb_map = {os.path.basename(p): p for p in _list_imgs(vis_dir)}
            for fn in sorted(set(ir_map) & set(rgb_map)):
                all_ir.append(ir_map[fn])
                all_rgb.append(rgb_map[fn])
    return all_ir, all_rgb


def split_train_val(n: int, val_ratio: float, seed: int = 42) -> tuple[list[int], list[int]]:
    """The reference's reproducible split: shuffled indices, the last
    ``max(1, int(n·val_ratio))`` for validation."""
    val_size = max(1, int(n * val_ratio))
    idxs = list(range(n))
    random.Random(seed).shuffle(idxs)
    return idxs[: n - val_size], idxs[n - val_size:]


@dataclass
class KAISTPairDataset:
    """Paired IR/RGB frames resized to ``size_hw``, NHWC numpy samples."""

    ir_paths: list[str]
    rgb_paths: list[str]
    size_hw: tuple[int, int] = (256, 256)
    augment: bool = True
    seed: int = 0

    def __post_init__(self) -> None:
        if len(self.ir_paths) != len(self.rgb_paths):
            raise ValueError("ir/rgb path lists must have equal length")
        self._epoch = 0
        log.info("[KAISTPairDataset] total pairs: %d (augment=%s)", len(self.ir_paths), self.augment)

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation stream (flips differ across epochs)."""
        self._epoch = epoch

    def _flip(self, idx: int) -> bool:
        if not self.augment:
            return False
        return random.Random(f"{self.seed}:{self._epoch}:{idx}").random() < 0.5

    def __len__(self) -> int:
        return len(self.ir_paths)

    def _read_pair(self, idx: int):
        """Resized IR in its own bit depth + resized uint8 RGB."""
        import cv2

        ir_u = cv2.imread(self.ir_paths[idx], cv2.IMREAD_GRAYSCALE)
        if ir_u is None:
            raise RuntimeError(f"Could not read IR image: {self.ir_paths[idx]}")
        rgb_u = cv2.imread(self.rgb_paths[idx], cv2.IMREAD_COLOR)
        if rgb_u is None:
            raise RuntimeError(f"Could not read RGB image: {self.rgb_paths[idx]}")
        h, w = self.size_hw
        ir_u = cv2.resize(ir_u, (w, h), interpolation=cv2.INTER_AREA)
        rgb_u = cv2.cvtColor(rgb_u, cv2.COLOR_BGR2RGB)
        rgb_u = cv2.resize(rgb_u, (w, h), interpolation=cv2.INTER_AREA)
        return ir_u, rgb_u

    def raw_item(self, idx: int):
        """``(ir (H, W, 1), rgb (H, W, 3), flip)``: the resized uint8 frames
        and the flip still to apply, for the native batch assembler
        (``data.native``), which normalizes, flips and stacks. None for a
        frame that is not 8-bit, and for an IR frame of 0s and 1s only, which
        the reference does not divide by 255 (the assembler always does):
        their batches take the exact float path."""
        ir_u, rgb_u = self._read_pair(idx)
        if ir_u.dtype != np.uint8 or ir_u.max() <= 1:
            return None
        return ir_u[:, :, None], rgb_u, self._flip(idx)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        """``{'ir': (H, W, 1), 'rgb': (H, W, 3)}`` float32 in [−1, 1]."""
        ir = load_ir_image(self.ir_paths[idx], self.size_hw)
        rgb = load_rgb_image(self.rgb_paths[idx], self.size_hw)
        if self._flip(idx):
            ir = np.fliplr(ir).copy()
            rgb = np.fliplr(rgb).copy()
        return {
            "ir": (ir[:, :, None] * 2.0 - 1.0).astype(np.float32),
            "rgb": (rgb * 2.0 - 1.0).astype(np.float32),
        }

    def int_item(self, idx: int) -> dict[str, np.ndarray]:
        """``{'ir': uint16 (H, W, 1), 'rgb': uint8 (H, W, 3)}`` encoding the
        exact values ``__getitem__`` gives (the step decodes them): 8-bit IR
        k → 257·k (k/255 = 257k/65535), 16-bit IR m → m, an all-0/1 IR frame
        (which the reference does not divide) → k·65535; RGB k → k."""
        ir_u, rgb_u = self._read_pair(idx)
        if ir_u.max() <= 1:
            scale = 65535
        elif ir_u.dtype == np.uint8:
            scale = 257
        else:
            scale = 1
        ir16 = ir_u.astype(np.uint16) * np.uint16(scale)
        if self._flip(idx):
            ir16 = np.fliplr(ir16)
            rgb_u = np.fliplr(rgb_u)
        return {"ir": np.ascontiguousarray(ir16[:, :, None]), "rgb": np.ascontiguousarray(rgb_u)}
