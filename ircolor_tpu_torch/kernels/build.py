"""Build and load the CUDA kernels: ``nvcc`` → one shared library per
source in ``csrc/``, plain C interface, loaded with ``ctypes``.

Built at first use from the package's own sources into ``build/kernels/``
at the root of the checkout (``.gitignore`` lists ``build/``). A library's
file name carries a hash of its source and the shared headers, so an edited
source rebuilds and a built one loads at once. ``build_all`` starts one
``nvcc`` per source, all together. Nothing here touches CUDA when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("conv_fwd", "wgrad", "blur", "head", "instance_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of each library, from this process's
# build or, for a library built earlier, the report kept beside it.
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(found):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return found


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[Path, subprocess.Popen | None]:
    out = _lib_path(name)
    if out.exists():
        log = out.with_suffix(".log")
        if name not in build_logs and log.exists():
            build_logs[name] = log.read_text()
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, proc


def _finish(name: str, out: Path, proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    build_logs[name] = log


def build_all() -> None:
    """Compile every source that has no up-to-date library, in parallel."""
    started = {name: _start(name) for name in SOURCES}
    errors = []
    for name, (out, proc) in started.items():
        try:
            _finish(name, out, proc)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        out, proc = _start(name)
        _finish(name, out, proc)
        _loaded[name] = ctypes.CDLL(str(out))
    return _loaded[name]


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
