"""Synchronizing with the card, spans of the program's own phases, and
profiler traces (``ircolor_tpu/utils/timing.py``).

``span(name)`` marks a phase of the serving step, the generator or the
training step, and each kernel wrapper's launch, as a profiler range named
``ircolor.<name>``, but only while a ``torch.profiler`` profile records: on
the same clock as the card's activity in that profile (Kineto's), with
nothing kept anywhere else. The range is a ``RecordFunction`` at an op's
scope (``torch._C._profiler._RecordFunctionFast``), a host-side event like
any op's, where ``torch.profiler.record_function``'s user scope would also
give the card a ``gpu_user_annotation`` event over the kernels under it: in
a profile whose events carry no activity type (torch 2.11) such an event
reads as device work. With no profiler recording a span is one test of the
profiler's flag and a shared no-op context: no range is made and no clock
is read, so the step, and a ``torch.export`` trace of it, run as without
it. ``ProfilerTrace`` records such a profile (the host, and the card where
there is one) as a Chrome trace (chrome://tracing, Perfetto).

Not ported: the JAX package's ``Timer``, ``ThroughputMeter``,
``profiler_trace`` (nothing of the port read them), ``start_transfer_warmup``
and ``time_chained_fn`` (a remotely attached TPU's transport). The port
times kernels with CUDA events (``chip_smoke.py``) and its steps by the
benchmark (``portbench/``; ``portbench/spans.py`` reads these spans from a
profiled window).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any

import torch
import torch.autograd.profiler as _profiler

SPAN_PREFIX = "ircolor."
_OFF = contextlib.nullcontext()


def span(name: str, ordinal: int | None = None):
    """A profiler range ``ircolor.<name>`` (``ircolor.<name>#<ordinal>``
    where an ordinal is given: a step's number, which groups one batch's
    spans) while a ``torch.profiler`` profile records; otherwise a shared
    no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if ordinal is not None:
        name = f"{name}#{ordinal}"
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)


def synchronize(on: Any = None) -> None:
    """Wait for the card that ``on`` (a tensor or device) lives on; a CPU
    tensor or device, or None, waits for nothing."""
    if on is None:
        return
    dev = on.device if isinstance(on, torch.Tensor) else torch.device(on)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
