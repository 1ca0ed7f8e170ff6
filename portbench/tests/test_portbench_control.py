"""``correct`` comes out false for the control and for each fault a cell can
have: the whole run on the CPU at a tiny size, past the harness's look for
a card, with the timed path broken underneath (the program's entry points
monkeypatched). The cells' own limits judge; the same control, read on the
chip at the cells' sizes, is in PERF.md."""

import copy

import pytest
import torch

from portbench import cells, compare
from portbench.tests import tiny
from portbench.trace import Spans


def _broken_infer(monkeypatch, how):
    import ircolor_tpu_torch.eval.runner as runner

    real = runner.make_infer_fn

    def make(module, dp_mesh=None):
        infer = real(module, dp_mesh)

        def broken(ir, gt):
            b = ir.shape[0]
            if how == "half_batch":
                pred, m = infer(ir[: b // 2], gt[: b // 2])
                pred = torch.cat([pred, torch.zeros_like(pred)])
                m = {k: torch.cat([v, v]) for k, v in m.items()}
                return pred, m
            pred, m = infer(ir, gt)
            pred = pred.clone()
            pred[0] = 255 - pred[0]
            return pred, m

        return broken

    monkeypatch.setattr(runner, "make_infer_fn", make)


def _broken_step(monkeypatch, how):
    import ircolor_tpu_torch.train.step as step_mod

    real = step_mod.make_train_step

    def make(cfg, vgg, **kw):
        step = real(cfg, vgg, **kw)

        def broken(state, batch):
            if how == "half_batch":
                b = batch["ir"].shape[0]
                return step(state, {k: v[: b // 2] for k, v in batch.items()})
            if how == "unchanged":
                nets = (state.g, state.d)
                before = [copy.deepcopy(n.state_dict()) for n in nets]
                state, m = step(state, batch)
                for n, sd in zip(nets, before):
                    n.load_state_dict(sd)
                return state, m
            state, m = step(state, batch)
            if how == "loss_altered":
                return state, dict(m, loss_G=m["loss_G"] * 1.5)
            # An answer altered where it is produced: G's first weight as
            # the step returns it.
            with torch.no_grad():
                next(state.g.parameters()).mul_(1.5)
            return state, m

        return broken

    monkeypatch.setattr(step_mod, "make_train_step", make)


@pytest.mark.parametrize("how", ["half_batch", "answer_altered"])
def test_serving_fault_is_not_correct(monkeypatch, how):
    _broken_infer(monkeypatch, how)
    assert tiny.run(tiny.spec(tiny.SERVE))["correct"] is False


@pytest.mark.parametrize("how", ["unchanged", "half_batch", "answer_altered", "loss_altered"])
def test_training_fault_is_not_correct(monkeypatch, how):
    _broken_step(monkeypatch, how)
    assert tiny.run(tiny.spec(tiny.TRAIN))["correct"] is False


# The smallest sizes at which the control's rounding, through the network's
# depth, reaches past the full-size limits (int4 reads 22 uint8 levels at
# ngf 32, 64x64, two blocks; 16 at ngf 16, 32x32, one block).
CONTROL_SIZES = {tiny.SERVE: dict(ngf=32, hw=64, n_blocks=2), tiny.TRAIN: dict(ngf=16, hw=32)}


@pytest.mark.parametrize("cell_name", [tiny.SERVE, tiny.TRAIN])
def test_control_is_not_correct(cell_name):
    spec = tiny.spec(cell_name, **CONTROL_SIZES[cell_name])
    kind = cells.KINDS[spec["traffic"]["kind"]]
    cell = kind(spec["config"], spec["traffic"], tiny.SEED, "cpu", Spans())
    cell.setup()
    cell.window(0.3)
    cell.release()
    numbers = cell.check(control=spec["config"]["control"][kind.kind])
    ok, checks = compare.judge(numbers, spec["limits"])
    assert not ok, checks
