"""The program spans' reduction (``spans.extend``) on a synthetic event list:
each step's host and wait time (a wait on autograd's thread, overlapping
waits counted once, a wait that outlasts the step clipped), the device time
of each program span, the waits by span and call, and the idle gaps named by
the program span the loop was in; every key that ``trace.summarize`` gives,
and every reader of one, unchanged."""

from types import SimpleNamespace

import pytest
import torch

from portbench import readers, roofline, spans, trace
from portbench.tests import tiny

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, AUTOGRAD = 1, 2


class _Event:
    def __init__(self, name, a, b, tid=MAIN, corr=0, kind="user_annotation", device=CPU):
        self._v = (name, a, b, tid, corr, kind, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def activity_type(self):
        return self._v[5]

    def device_type(self):
        return self._v[6]


def _call(name, a, b, tid=MAIN, corr=0):
    return _Event(name, a, b, tid, corr, "cuda_runtime")


def _op(name, a, b, corr):
    return _Event(name, a, b, 0, corr, "kernel", CUDA)


EVENTS = [
    _Event(trace.SPAN + "step", 0, 1000),
    _Event(trace.SPAN + "wait", 1000, 1200),
    _Event(trace.SPAN + "step", 1200, 1600),
    _Event("ircolor.serve.step#0", 10, 990),
    _Event("ircolor.g.up1", 100, 500),
    _Event(trace.KERNEL + "block_q", 115, 205),
    _Event("ircolor.kernel.conv3x3_reflect_fused_q", 120, 200),
    _call("cudaLaunchKernel", 130, 140, corr=5),
    _op("ircolor::conv_q_fused_kernel", 300, 400, 5),
    _call("cudaStreamSynchronize", 210, 450),
    _call("cudaMemcpyAsync", 400, 500, tid=AUTOGRAD),          # overlaps the one above
    _call("cudaLaunchKernel", 600, 610, tid=AUTOGRAD, corr=6),  # no span open on its thread
    _op("void at::native::elementwise_kernel", 620, 700, 6),
    _Event("ircolor.kernel.conv3x3_dgrad_fused", 640, 680, tid=AUTOGRAD),
    _call("cuLaunchKernel", 650, 655, tid=AUTOGRAD, corr=7),
    _op("ircolor::conv_dgrad_kernel", 710, 760, 7),
    _call("cudaDeviceSynchronize", 980, 1010),                 # outlasts the step
    _call("cudaEventSynchronize", 1050, 1150),                 # in no program span
    _Event("ircolor.serve.step#1", 1210, 1590),
]


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


@pytest.fixture(scope="module")
def both():
    before = trace.summarize(_prof(EVENTS))
    return before, spans.extend(dict(before), EVENTS)


def test_host_and_wait_of_each_step(both):
    _, s = both
    # Step 0: waits [210, 500] (two threads, overlapping) and [980, 990].
    assert s["step_wait_ms"] == [300 / 1e6, 0.0]
    assert s["step_host_ms"] == [680 / 1e6, 380 / 1e6]
    for host, wait, span in zip(s["step_host_ms"], s["step_wait_ms"], (980, 380)):
        assert round((host + wait) * 1e6) == span


def test_device_time_by_program_span(both):
    before, s = both
    assert s["span_s"] == {"kernel.conv3x3_reflect_fused_q": 100 / 1e9,
                           "serve.step": 80 / 1e9,
                           "kernel.conv3x3_dgrad_fused": 50 / 1e9}
    assert before["range_s"] == {"block_q": 100 / 1e9}


def test_waits_by_span_and_call(both):
    _, s = both
    assert s["span_waits"] == {"g.up1": {"cudaStreamSynchronize": [1, 240 / 1e6],
                                         "cudaMemcpyAsync": [1, 100 / 1e6]},
                               "serve.step": {"cudaDeviceSynchronize": [1, 30 / 1e6]}}


def test_idle_gaps_named_by_program_span(both):
    before, s = both
    assert s["idle_gaps"] == [["step/serve.step", 840 / 1e9], ["step", 300 / 1e9],
                              ["step/g.up1", 220 / 1e9], ["step/serve.step", 10 / 1e9]]
    assert [g[1] for g in before["idle_gaps"]] == [g[1] for g in s["idle_gaps"]]
    assert [g[0] for g in before["idle_gaps"]] == ["step"] * 4


def test_summarize_keys_and_readers_unchanged(both):
    before, s = both
    assert set(s) - set(before) == {"step_host_ms", "step_wait_ms", "span_s", "span_waits"}
    for k, v in before.items():
        if k != "idle_gaps":
            assert s[k] == v, k
    calls = {"block_q": [roofline.block_conv_q(32, 128, 160, 256, 256)]}
    for summary_kind in ("serve", "train"):
        a = SimpleNamespace(kind=summary_kind, summary=before, calls=calls)
        b = SimpleNamespace(kind=summary_kind, summary=s, calls=calls)
        for read in (readers.glue_share, readers.idle_share):
            assert read(a, summary_kind) == read(b, summary_kind)
        assert (readers.roofline(a, summary_kind, ("block_q",))
                == readers.roofline(b, summary_kind, ("block_q",)))


def test_median_readers():
    run = SimpleNamespace(kind="serve", summary={"step_host_ms": [3.0, 1.0, 2.0],
                                                 "step_wait_ms": []})
    assert spans.median_ms(run, "serve", "step_host_ms") == 2.0
    assert spans.median_ms(run, "serve", "step_wait_ms") is None
    assert spans.median_ms(run, "train", "step_host_ms") is None
    assert spans.extend({}, EVENTS) == {}


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.TRAIN])
def test_profiled_dry_run_reads_the_program_spans(cell):
    spec = tiny.spec(cell)
    torch.manual_seed(0)
    result, _, extra = spans.profiled(spec, tiny.SEED, 0.3, device="cpu", setup_t0=0.0)
    kind = spec["traffic"]["kind"]
    steps = spec["traffic"]["profile_batches" if kind == "serve" else "profile_steps"]
    assert {f"{kind}.host_ms", f"{kind}.wait_ms"} <= set(result["metrics"])
    assert len(extra["step_host_ms"]) == len(extra["bench_step_ms"]) == steps
    assert extra["step_wait_ms"] == [0.0] * steps  # no CUDA runtime call on the CPU
    for host, step in zip(extra["step_host_ms"], extra["bench_step_ms"]):
        assert 0 < host <= step
    assert result["correct"] is True
