"""The benchmark's own instrumentation: spans around the calls into each
layer of the program, kernel-call wrappers for the traced sub-window, and
the reduction of a ``torch.profiler`` sub-window to a small summary (never
a whole Chrome trace).

Spans are ``record_function`` ranges in the traced sub-window, and each
wrapped kernel entry point of the program (a per-layer metric's ``WRAPS``)
runs inside a range of its own while its call's least time is counted from
its shapes, so the kernels it launches can be summed by the profiler's
correlation of launches to ranges.
"""

from __future__ import annotations

import contextlib
import importlib
from collections import defaultdict

import torch

SPAN = "portbench.span::"
KERNEL = "portbench.kernel::"


class Spans:
    """Named ranges around the calls into each layer: a profiler range
    while ``traced``, nothing otherwise."""

    def __init__(self):
        self.traced = False

    def __call__(self, name: str):
        return (torch.profiler.record_function(SPAN + name) if self.traced
                else contextlib.nullcontext())


class KernelCalls:
    """Wrappers around program functions, installed for the traced
    sub-window only: each call runs in a profiler range named after its
    label, and (ops, bytes, peak) of the call, from ``count(args, kwargs)``,
    is kept under the label."""

    def __init__(self):
        self.calls: dict[str, list[tuple[float, float, float]]] = defaultdict(list)
        self._saved: list = []

    def install(self, wraps) -> None:
        for module_name, attr, label, count in wraps:
            module = importlib.import_module(module_name)
            fn = getattr(module, attr)
            self._saved.append((module, attr, fn))
            setattr(module, attr, self._wrap(fn, label, count))

    def _wrap(self, fn, label, count):
        def wrapped(*args, **kwargs):
            self.calls[label].append(count(args, kwargs))
            with torch.profiler.record_function(KERNEL + label):
                return fn(*args, **kwargs)

        return wrapped

    def restore(self) -> None:
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        self._saved.clear()


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


_LAUNCHERS = ("cuda_runtime", "cuda_driver")
_DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


def _activity(e) -> str | None:
    """The event's activity type where the profiler gives it (older builds
    do not)."""
    get = getattr(e, "activity_type", None)
    return get() if get is not None else None


def _is_launch(e) -> bool:
    kind = _activity(e)
    if kind is not None:
        return kind in _LAUNCHERS
    n = e.name()
    return n.startswith("cu") and any(w in n for w in ("Launch", "Memcpy", "Memset"))


def _is_device_op(e) -> bool:
    kind = _activity(e)
    if kind is not None:
        return kind in _DEVICE_OPS
    return not e.name().startswith(("portbench.", "ProfilerStep"))


def summarize(prof, top: int = 10) -> dict:
    """The profiled sub-window as numbers, from the profiler's raw events:
    its length (from the first benchmark span's start to the last one's
    end), the device operations (kernels, copies, sets) with their times,
    the device-busy union, the device time of the operations launched
    inside each kernel range (a launch is matched to its operation by the
    CUDA correlation id, and to the innermost range open on its thread at
    that moment), and the longest idle gaps named by the benchmark span the
    host was in."""
    events = list(prof.profiler.kineto_results.events())
    cpu = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU]
    spans = [(e.start_ns(), e.end_ns(), e.name()[len(SPAN):]) for e in cpu
             if e.name().startswith(SPAN)]
    if not spans:
        return {}
    w0, w1 = min(a for a, _, _ in spans), max(b for _, b, _ in spans)
    dev = [e for e in events if e.device_type() != torch.autograd.DeviceType.CPU
           and _is_device_op(e)]
    ops = [(e.name(), max(e.start_ns(), w0), min(e.end_ns(), w1), e.correlation_id())
           for e in dev]
    ops = [op for op in ops if op[2] > op[1]]
    busy = _union([(a, b) for _, a, b, _ in ops])
    by_name: dict[str, int] = defaultdict(int)
    for n, a, b, _ in ops:
        by_name[n] += b - a

    launches = {e.correlation_id(): (e.start_thread_id(), e.start_ns()) for e in cpu
                if e.correlation_id() > 0 and _is_launch(e)}
    ranges = sorted((e.start_thread_id(), e.start_ns(), e.end_ns(), e.name()[len(KERNEL):])
                    for e in cpu if e.name().startswith(KERNEL))
    range_ns: dict[str, int] = defaultdict(int)
    matched = 0
    for _, a, b, corr in ops:
        if corr not in launches:
            continue
        matched += 1
        tid, t = launches[corr]
        inner = [r for r in ranges if r[0] == tid and r[1] <= t <= r[2]]
        if inner:
            range_ns[max(inner, key=lambda r: r[1])[3]] += b - a

    gaps, last = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > last:
            host = [n for s, e, n in spans if s <= last < e]
            gaps.append((host[-1] if host else "between spans", (a - last) / 1e9))
        last = max(last, b)
    gaps.sort(key=lambda g: -g[1])
    kernels = {n: t for n, t in by_name.items() if not n.startswith(("Memcpy", "Memset"))}
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "kernel_s": sum(kernels.values()) / 1e9,
        "port_kernel_s": sum(t for n, t in kernels.items() if "ircolor::" in n) / 1e9,
        "collective_s": sum(t for n, t in kernels.items() if "nccl" in n.lower()) / 1e9,
        "range_s": {k: v / 1e9 for k, v in range_ns.items()},
        "ops": len(ops),
        "ops_matched": matched,
        "device_ops": [[n[:160], t / 1e9] for n, t in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, s] for n, s in gaps[:top]],
    }


def complete(summary: dict, calls: dict) -> bool:
    """Whether a profiled sub-window recorded device work, and device time
    under every kernel range that was called."""
    return bool(summary) and summary["kernel_s"] > 0 and all(
        summary["range_s"].get(label, 0.0) > 0 for label, c in calls.items() if c)
