"""The program's own spans in a profiled sub-window: where each step's host
time goes and where it waits for the card.

``ircolor_tpu_torch`` marks its phases as profiler ranges named
``ircolor.<name>`` (host-side op events) while a profiler records (``utils/timing.py:span``): the
serving and training steps (``serve.step#<n>``, ``train.step#<n>``), their
phases, the generator's stages, the losses and each kernel wrapper's launch
(``kernel.<LAUNCHES key>``). ``extend`` reads them from the same raw events
as ``trace.summarize`` and adds to its summary:

  step_host_ms, step_wait_ms  one entry a step span, in order: the wait is
      the union, over every CPU thread, of the CUDA API calls (``cuda*``,
      ``cu*``) whose name does not contain ``Launch`` (synchronizes, copies),
      clipped to the span; the host time is the span less that wait.
  span_s      device time (s) of the operations launched under each program
      span: a launch is matched to the innermost span open on its thread,
      or, where none is (autograd's thread), to the innermost span open on
      the loop's thread at that moment. Ordinals are dropped from names.
  span_waits  for each program span, ``{call: [count, ms]}`` of those
      non-launch runtime calls, matched to spans as the launches are.

and names each idle gap that starts inside a program span on the loop's
thread ``<benchmark span>/<innermost program span>`` (``step/g.up1``);
every other key, and every other gap, stays as ``summarize`` gave it.
``trace.summarize`` does not call it yet (``PERF.md`` §7); a profiled run
of a cell with it is

    python3 -m portbench.spans --workload flagship-serve-int8-b32 --seed 7 --seconds 5

which prints the result line of ``portbench.run --trace 1`` with the
medians below as metrics, and the added keys on standard error.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import statistics
import sys
from collections import defaultdict
from types import SimpleNamespace

import torch

from portbench import trace as tr

PROGRAM = "ircolor."
STEPS = ("serve.step", "train.step")
_RUNTIME = re.compile(r"cu[A-Z]|cuda[A-Z]")


def _is_runtime(e) -> bool:
    kind = tr._activity(e)
    if kind is not None:
        return kind in tr._LAUNCHERS
    return bool(_RUNTIME.match(e.name()))


def _base(name: str) -> str:
    return name.partition("#")[0]


class _Open:
    """The program spans of each thread, for the innermost one open at a
    moment."""

    def __init__(self, spans: list[tuple[int, int, int, str]], main: int | None):
        self.by_tid: dict[int, list] = defaultdict(list)
        for tid, a, b, name in spans:
            self.by_tid[tid].append((a, b, name))
        self.main = main

    def on(self, tid: int, t: int) -> str | None:
        inner = [(a, n) for a, b, n in self.by_tid.get(tid, ()) if a <= t <= b]
        return _base(max(inner)[1]) if inner else None

    def at(self, tid: int, t: int) -> str | None:
        """Innermost on ``tid``, else on the loop's thread."""
        got = self.on(tid, t)
        return got if got is not None or tid == self.main else self.on(self.main, t)


def _clipped_union(intervals, a: int, b: int) -> int:
    return sum(y - x for x, y in tr._union([(max(x, a), min(y, b)) for x, y in intervals
                                            if min(y, b) > max(x, a)]))


def extend(summary: dict, events, top: int = 10) -> dict:
    """``summary`` (``trace.summarize``'s, of the same events) with the
    program's spans read into it (module docstring); unchanged where the
    sub-window has no benchmark span."""
    if not summary:
        return summary
    cpu = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU]
    bench = [(e.start_ns(), e.end_ns(), e.name()[len(tr.SPAN):], e.start_thread_id())
             for e in cpu if e.name().startswith(tr.SPAN)]
    if not bench:
        return summary
    w0, w1 = min(a for a, _, _, _ in bench), max(b for _, b, _, _ in bench)
    main = bench[0][3]
    prog = [(e.start_thread_id(), e.start_ns(), e.end_ns(), e.name()[len(PROGRAM):])
            for e in cpu if e.name().startswith(PROGRAM)]
    where = _Open(prog, main)

    runtime = [e for e in cpu if _is_runtime(e)]
    waits = [e for e in runtime if "Launch" not in e.name()]
    wait_iv = [(e.start_ns(), e.end_ns()) for e in waits]
    steps = sorted((a, b) for tid, a, b, n in prog if _base(n) in STEPS)
    wait_ns = [_clipped_union(wait_iv, a, b) for a, b in steps]

    launches = {e.correlation_id(): (e.start_thread_id(), e.start_ns()) for e in cpu
                if e.correlation_id() > 0 and tr._is_launch(e)}
    ops = [(max(e.start_ns(), w0), min(e.end_ns(), w1), e.correlation_id()) for e in events
           if e.device_type() != torch.autograd.DeviceType.CPU and tr._is_device_op(e)]
    ops = [op for op in ops if op[1] > op[0]]
    span_ns: dict[str, int] = defaultdict(int)
    for a, b, corr in ops:
        if corr in launches:
            name = where.at(*launches[corr])
            if name is not None:
                span_ns[name] += b - a
    span_waits: dict[str, dict[str, list]] = defaultdict(dict)
    for e in waits:
        if w0 <= e.start_ns() <= w1:
            name = where.at(e.start_thread_id(), e.start_ns())
            if name is not None:
                c = span_waits[name].setdefault(e.name(), [0, 0.0])
                c[0] += 1
                c[1] += (e.end_ns() - e.start_ns()) / 1e6

    out = dict(summary)
    out.update(
        step_host_ms=[(b - a - w) / 1e6 for (a, b), w in zip(steps, wait_ns)],
        step_wait_ms=[w / 1e6 for w in wait_ns],
        span_s={k: v / 1e9 for k, v in span_ns.items()},
        span_waits={k: dict(v) for k, v in span_waits.items()},
        idle_gaps=_named_gaps(ops, bench, where, w0, w1, top),
    )
    return out


def _named_gaps(ops, bench, where: _Open, w0: int, w1: int, top: int) -> list:
    """``summarize``'s idle gaps, in its order, each that starts inside a
    program span on the loop's thread named ``<benchmark span>/<span>``."""
    busy = tr._union([(a, b) for a, b, _ in ops])
    gaps, last = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > last:
            host = [n for s, e, n, _ in bench if s <= last < e]
            name = host[-1] if host else "between spans"
            inner = where.on(where.main, last)
            gaps.append((f"{name}/{inner}" if inner else name, (a - last) / 1e9))
        last = max(last, b)
    gaps.sort(key=lambda g: -g[1])
    return [[n, s] for n, s in gaps[:top]]


def median_ms(run, kind: str, key: str) -> float | None:
    """The median of ``key`` (``step_host_ms`` or ``step_wait_ms``) over the
    profiled sub-window's steps of a ``kind`` cell, ms; None where there is
    none (another kind of traffic, no profile, a program without spans)."""
    s = run.summary
    if run.kind != kind or not s or not s.get(key):
        return None
    return statistics.median(s[key])


READERS = {"serve.host_ms": ("serve", "step_host_ms"), "serve.wait_ms": ("serve", "step_wait_ms"),
           "train.host_ms": ("train", "step_host_ms"), "train.wait_ms": ("train", "step_wait_ms")}


def profiled(spec: dict, seed: int, seconds: float, device: str = "cuda",
             setup_t0: float | None = None) -> tuple[dict, list[str], dict]:
    """``run.run_cell`` of ``spec`` with ``--trace 1``, its summary read by
    ``extend`` and ``READERS`` among its metrics: (the result, the lines of
    standard error, the added keys with ``range_s`` and each benchmark
    ``step`` span in ms)."""
    from portbench import run

    spec = dict(spec, per_layer=dict(spec["per_layer"]))
    for name, (kind, key) in READERS.items():
        if kind == spec["traffic"]["kind"]:
            reader = SimpleNamespace(read=functools.partial(median_ms, kind=kind, key=key))
            spec["per_layer"][name] = ({"name": name, "unit": "ms"}, reader)
    kept = {}
    summarize = tr.summarize

    def read_spans(prof, top=10):
        events = list(prof.profiler.kineto_results.events())
        kept["summary"] = extend(summarize(prof, top), events, top)
        kept["bench_step_ms"] = [(e.end_ns() - e.start_ns()) / 1e6 for e in events
                                 if e.name() == tr.SPAN + "step"
                                 and e.device_type() == torch.autograd.DeviceType.CPU]
        return kept["summary"]

    tr.summarize = read_spans
    try:
        result, lines = run.run_cell(spec, seed, seconds, True, device, setup_t0)
    finally:
        tr.summarize = summarize
    s = kept.get("summary", {})
    extra = {k: s.get(k) for k in ("range_s", "span_s", "span_waits", "step_host_ms",
                                   "step_wait_ms")}
    extra["bench_step_ms"] = kept.get("bench_step_ms")
    return result, lines, extra


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="A profiled run of a cell with the program's spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from portbench import run

    spec = run.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device", file=sys.stderr)
        return 2
    result, lines, extra = profiled(spec, args.seed, args.seconds)
    print(f"card: {run.power_limit()}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    print("spans: " + json.dumps(extra), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
