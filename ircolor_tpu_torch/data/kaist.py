"""KAIST test-set discovery (``ircolor_tpu/data/kaist.py``, what ``run_test``
needs): every image under a directory named ``lwir`` (any case) that has a
``visible`` sibling, sorted, as ``(ir_path, set_name, seq_rel)``."""

from __future__ import annotations

import os
from typing import Iterable, Sequence

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
