"""The native batch assembler (``ircolor_tpu/data/native.py``): a ctypes
binding of ``native/batchops.cpp``, the fused uint8 → float32 [−1, 1]
normalize + horizontal flip + stack into the NHWC batch, over C++ threads.

The C++ source is read where it is, at the root of the checkout, and never
edited. It is built at first use with ``g++ -O3 -shared -fPIC -std=c++17``
into ``build/native/libbatchops_<digest>.so`` (``.gitignore`` lists
``build/``), the digest covering the source and the flags, so an edited
source rebuilds. Each build writes a file of its process's own and renames
it into place, so processes that build at once never load a half-written
library. A build that fails raises with the compiler's message: there is no
numpy fallback here; a caller that wants numpy asks ``BatchLoader`` for
``use_native=False``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "batchops.cpp"
BUILD_DIR = ROOT / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _lib_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libbatchops_{digest.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"native batch assembler: no g++ to build {SOURCE}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first where needed; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            out = _lib_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            lib.assemble_batch_u8.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.assemble_batch_u8.restype = None
            _lib = lib
    return _lib


def assemble_batch(
    images_u8: Sequence[np.ndarray],
    flips: Sequence[bool] | None = None,
    out: np.ndarray | None = None,
    nthreads: int = 4,
) -> np.ndarray:
    """``(B, H, W, C)`` float32 ``x/255·2 − 1`` of the uint8 images, each
    flipped left-right where its ``flips`` entry is true. Every image must
    have the first one's shape; ``out``, where given, must be a C-contiguous
    float32 array of the batch's shape (the C++ code writes through a raw
    pointer and strides every source by H·W·C)."""
    b = len(images_u8)
    first = images_u8[0]
    h, w = first.shape[:2]
    c = first.shape[2] if first.ndim == 3 else 1
    if flips is None:
        flips = [False] * b
    if len(flips) != b:
        raise ValueError(f"assemble_batch: {len(flips)} flips for {b} images")
    if out is None:
        out = np.empty((b, h, w, c), np.float32)
    elif out.shape != (b, h, w, c) or out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(
            f"assemble_batch out must be C-contiguous float32 {(b, h, w, c)}, "
            f"got {out.dtype} {out.shape}"
        )
    ptrs = (ctypes.c_void_p * b)()
    keepalive = []
    for i, img in enumerate(images_u8):
        if img.dtype != np.uint8:
            raise TypeError("assemble_batch requires uint8 images")
        if img.shape != first.shape:
            raise ValueError(
                f"assemble_batch image {i} has shape {img.shape}, expected "
                f"{first.shape} (all images must match the first)"
            )
        img = np.ascontiguousarray(img)
        keepalive.append(img)
        ptrs[i] = img.ctypes.data
    get_lib().assemble_batch_u8(
        ptrs, bytes(1 if f else 0 for f in flips),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b, h, w, c, nthreads,
    )
    return out
