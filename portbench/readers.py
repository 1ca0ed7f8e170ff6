"""Arithmetic shared by the per-layer metric readers (``metrics/<name>.py``).
A reader returns None where its run has nothing for it to read: another
kind of traffic, no profiled sub-window, a kernel that was never called."""

from __future__ import annotations


def mfu(run, kind: str) -> float | None:
    """The model's operations a frame times the frames of the window, over
    the window and the card's peak (the configuration's peak for this kind
    of work), in %."""
    if run.kind != kind or not run.window_s:
        return None
    cfg = run.config
    return 100.0 * cfg["flops_per_frame"][kind] * run.frames / run.window_s / cfg["peak_ops"][kind]


def glue_share(run, kind: str) -> float | None:
    """Device time in kernels outside the program's ``ircolor::`` namespace,
    as a share of the device-busy time of the profiled sub-window, in %."""
    s = run.summary
    if run.kind != kind or not s or not s["busy_s"]:
        return None
    return 100.0 * (s["kernel_s"] - s["port_kernel_s"]) / s["busy_s"]


def idle_share(run, kind: str) -> float | None:
    """1 - the union of device-busy intervals over the profiled sub-window, in %."""
    s = run.summary
    if run.kind != kind or not s or not s["window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def roofline(run, kind: str, labels: tuple[str, ...]) -> float | None:
    """The calls' least time (operations or bytes over the peaks, from their
    shapes) over the device time of the kernels they launched, in %."""
    s = run.summary
    if run.kind != kind or not s:
        return None
    from portbench.roofline import bound_s

    calls = [c for label in labels for c in run.calls.get(label, ())]
    device = sum(s["range_s"].get(label, 0.0) for label in labels)
    if not calls or device <= 0:
        return None
    return 100.0 * sum(bound_s(*c)[0] for c in calls) / device
