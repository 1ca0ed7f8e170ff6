"""The training diagnostics of the port on the CPU: ``profile_dir`` (a
``torch.profiler`` trace of the first steps, stopped also when a step
raises), ``debug_nans`` (the first module whose output is not finite, named)
and ``utils/timing.py``."""

import json
import os

import pytest
import torch

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.models.wrapper import IRColorizationModel
from ircolor_tpu_torch.train import loop
from ircolor_tpu_torch.train.checkpoint import save_netg_pth
from ircolor_tpu_torch.utils import timing
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _cfg(root, tmp_path, **kw):
    return Config(img_size=32, n_blocks=1, ngf=8, batch_size=2, epochs=1, save_every=1,
                  lambda_perc=0.0, num_workers=1, train_roots=(str(root / "set00"),),
                  save_dir=str(tmp_path / "ckpt"), **kw)


def _trace_events(logdir):
    with open(os.path.join(logdir, "trace.json"), encoding="utf-8") as f:
        return json.load(f)["traceEvents"]


def test_profile_dir_writes_a_trace(kaist_tree, tmp_path):
    root, _ = kaist_tree
    logdir = str(tmp_path / "prof")
    loop.train_kaist(_cfg(root, tmp_path, profile_dir=logdir), device="cpu",
                     max_steps_per_epoch=2)
    names = {e.get("name", "") for e in _trace_events(logdir)}
    assert any("conv" in n for n in names)
    assert not torch.autograd.profiler._is_profiler_enabled


def test_profile_trace_stops_when_a_step_raises(kaist_tree, tmp_path, monkeypatch):
    """A step that raises inside the traced window still writes the trace
    and leaves no profiler running."""
    root, _ = kaist_tree
    real = loop.make_train_step

    def failing_second_step(cfg, vgg):
        step, calls = real(cfg, vgg), []

        def run(state, batch):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("step 2 fails")
            return step(state, batch)

        return run

    monkeypatch.setattr(loop, "make_train_step", failing_second_step)
    logdir = str(tmp_path / "prof")
    with pytest.raises(RuntimeError, match="step 2 fails"):
        loop.train_kaist(_cfg(root, tmp_path, profile_dir=logdir), device="cpu",
                         max_steps_per_epoch=4)
    assert _trace_events(logdir)
    assert not torch.autograd.profiler._is_profiler_enabled


def test_debug_nans_names_the_first_module(kaist_tree, tmp_path):
    """NaN weights in down2's conv and, later in the forward, up1's: the
    error names down2's conv, with the epoch and step; the hooks are gone
    after the run."""
    root, _ = kaist_tree
    cfg = _cfg(root, tmp_path, debug_nans=True)
    g = IRColorizationModel(cfg, "cpu").module
    with torch.no_grad():
        g.up1_conv[0].weight[0, 0, 0, 0] = float("nan")
        g.down2[0].weight[1, 2, 0, 1] = float("nan")
    init = save_netg_pth(g, str(tmp_path / "nan_init"))
    with pytest.raises(FloatingPointError, match=r"G module 'down2\.0' at epoch 1 step 1"):
        loop.train_kaist(cfg.replace(init_G_weights=init), device="cpu", max_steps_per_epoch=1)
    # Finite weights train through the guard, and leave no hook behind.
    summary = loop.train_kaist(cfg, device="cpu", max_steps_per_epoch=1)
    state = summary["state"]
    assert not state.g._forward_pre_hooks and not state.d._forward_hooks


def test_timing_meters():
    t = timing.Timer()
    for _ in range(2):
        with t:
            pass
    assert t.count == 2 and t.mean >= 0.0
    meter = timing.ThroughputMeter()
    meter.start(torch.zeros(1))
    meter.add(8)
    assert meter.stop("cpu") > 0
    with pytest.raises(RuntimeError):
        timing.ThroughputMeter().stop()


def test_profiler_trace_context(tmp_path):
    with timing.profiler_trace(str(tmp_path)):
        torch.ones(4).sum()
    assert os.path.isfile(tmp_path / "trace.json")
    with timing.profiler_trace(None):
        pass
