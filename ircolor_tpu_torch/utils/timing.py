"""Wall-clock timing, throughput meters and profiler traces
(``ircolor_tpu/utils/timing.py``).

The meters synchronize with the card (``torch.cuda.synchronize``) where the
JAX package blocks until its arrays are ready, so that a rate covers the
device's work and not only its enqueue. ``profiler_trace`` /
``ProfilerTrace`` capture a ``torch.profiler`` trace (the host, and the
card where there is one) as a Chrome trace (chrome://tracing, Perfetto).

Not ported: the JAX package's ``start_transfer_warmup`` and
``time_chained_fn``, helpers for a remotely attached TPU's transport (its
first device→host handshake; in-graph chained timing around its dispatch
latency). The port times kernels with CUDA events (``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator

import torch


def synchronize(on: Any = None) -> None:
    """Wait for the card that ``on`` (a tensor or device) lives on; a CPU
    tensor or device, or None, waits for nothing."""
    if on is None:
        return
    dev = on.device if isinstance(on, torch.Tensor) else torch.device(on)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating wall-clock timer. ``with timer: ...``."""

    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0
        self._t0: float | None = None

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._t0 is None:
            raise RuntimeError("Timer exited without being entered")
        self.total += time.perf_counter() - self._t0
        self.count += 1
        self._t0 = None

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


class ThroughputMeter:
    """Items/s over a window, synchronized with the card of ``sync_on`` at
    its ends."""

    def __init__(self) -> None:
        self._t0: float | None = None
        self.items = 0

    def start(self, sync_on: Any = None) -> None:
        synchronize(sync_on)
        self.items = 0
        self._t0 = time.perf_counter()

    def add(self, n: int) -> None:
        self.items += n

    def stop(self, sync_on: Any = None) -> float:
        """Items/s since ``start()``."""
        synchronize(sync_on)
        if self._t0 is None:
            raise RuntimeError("ThroughputMeter stopped without being started")
        dt = time.perf_counter() - self._t0
        return self.items / dt if dt > 0 else float("inf")


class ProfilerTrace:
    """A ``torch.profiler`` trace of the host (and the card, where CUDA is
    there) from ``start()`` to ``stop()``, which writes it to
    ``<logdir>/trace.json`` as a Chrome trace. ``stop()`` is a no-op once
    stopped, so a ``finally`` can always call it."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._prof = None

    @property
    def running(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()

    def stop(self) -> str | None:
        """Stop and write the trace; returns its path (None if not running)."""
        if self._prof is None:
            return None
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, "trace.json")
        prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def profiler_trace(logdir: str | None) -> Iterator[None]:
    """Trace the block into ``<logdir>/trace.json`` (nothing if None), and
    write it also when the block raises."""
    if logdir is None:
        yield
        return
    trace = ProfilerTrace(logdir)
    trace.start()
    try:
        yield
    finally:
        trace.stop()
