"""One process per rank (the port's form of JAX's one-process data mesh).

``spawn(fn, devices, args)`` starts ``len(devices)`` processes with
``torch.multiprocessing``'s ``spawn`` start method. Each joins a process
group whose rendezvous is a ``file://`` store in a fresh temporary
directory (``parallel.mesh.initialize_multihost``; the backend by
``backend_for``), runs ``fn(rank, device, *args)`` and sends its return
value back pickled (numbers, numpy arrays, dicts: no tensors). The parent
returns the values in rank order. A rank that raises or dies makes the
parent raise naming it, after the other ranks are killed; ``timeout_s``
bounds the whole run. A rank dies with its parent.

A rank on the CPU takes ``torch.get_num_threads() // len(devices)`` of the
parent's intra-op threads (at least one), so that the ranks share the
cores. The parent starts no CUDA work of its own: where the ranks run on
cards, it builds the kernels first (``kernels.build.build_all``, which only
compiles), so that every rank loads the same libraries from ``build/``.
"""

from __future__ import annotations

import ctypes
import os
import queue
import signal
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ircolor_tpu_torch.parallel.mesh import initialize_multihost

# How long a rank that has sent its result may take to exit.
_EXIT_S = 60.0
# How long the other ranks may take to report, once one has failed.
_REPORT_S = 3.0


def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when its parent exits (Linux ``prctl``)."""
    if sys.platform.startswith("linux"):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(1)


def _rank_main(rank: int, fn: Callable, devices: list, init_method: str, threads: int,
               args: tuple, parent: int, results: Any) -> None:
    _die_with_parent(parent)
    try:
        if devices[rank].type == "cpu":
            torch.set_num_threads(threads)
        dev = initialize_multihost(init_method=init_method, world_size=len(devices), rank=rank,
                                   devices=devices)
        out = fn(rank, dev, *args)
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, devices: Sequence[torch.device], args: tuple = (), *,
          timeout_s: float | None = None) -> list:
    """Run ``fn(rank, device, *args)`` on one process per entry of
    ``devices``; returns the ranks' return values in rank order. Raises
    ``RuntimeError`` for a rank that raised or exited without a result and
    ``TimeoutError`` past ``timeout_s``; either way every rank is killed."""
    devices = [torch.device(d) for d in devices]
    if any(d.type == "cuda" for d in devices):
        from ircolor_tpu_torch.kernels import build

        build.build_all()
    world = len(devices)
    threads = max(1, torch.get_num_threads() // world)
    ctx = mp.get_context("spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="ircolor_rdzv_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(
            rank, fn, devices, f"file://{tmp}/store", threads, tuple(args), os.getpid(), results))
            for rank in range(world)]
        for p in procs:
            p.start()
        got: dict[int, Any] = {}
        failed: dict[int, str] = {}
        grace = None  # after a first failure, the others' reports are awaited briefly
        try:
            while len(got) + len(failed) < world:
                now = time.monotonic()
                if grace is not None and now > grace:
                    break
                if deadline is not None and now > deadline:
                    raise TimeoutError(f"data-parallel ranks still running after {timeout_s} s "
                                       f"(done: {sorted(got)})")
                try:
                    rank, ok, out = results.get(timeout=0.5)
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if p.exitcode is not None and r not in got and r not in failed \
                                and results.empty():
                            failed[r] = f"rank {r} exited with code {p.exitcode} without a result"
                else:
                    if ok:
                        got[rank] = out
                    else:
                        failed[rank] = f"rank {rank} failed:\n{out}"
                if failed and grace is None:
                    grace = time.monotonic() + _REPORT_S
            if failed:
                raise RuntimeError("\n".join(failed[r] for r in sorted(failed)))
            for r, p in enumerate(procs):
                p.join(_EXIT_S)
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} exited with code {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    return [got[r] for r in range(world)]
