"""The plain reference agrees with the program on the CPU at a tiny size, on
the same seeded weights and frames: the generator's float32 forward, and
the float32 training step's first steps (the program's kernels take their
plain versions on the CPU). Only this test imports both."""

import copy

import torch

from portbench import cells, compare, inputs
from portbench.reference.model import networks as reference_nets
from portbench.reference.serve import decode
from portbench.tests import tiny
from portbench.trace import Spans


def test_generator_forward_matches_the_program():
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    spec = tiny.spec(tiny.SERVE, ngf=8, hw=32)
    cfg = spec["config"]
    from ircolor_tpu_torch.config import Config

    port_cfg = Config.from_dict(dict(cfg["port_config"], compute_dtype="f32", quant_int8=False))
    ref = reference_nets(cfg["model"], "cpu")
    weights = inputs.make_weights(inputs.weight_specs(ref), tiny.SEED, "cpu")
    ref["g"].load_state_dict(weights["g"])
    model = IRColorizationModel(port_cfg.replace(mode="test"), "cpu")
    cells._load(model.module, weights["g"], "G")
    ir_u16, gt_u8 = inputs.make_frames(tiny.SEED, 1, 2, (32, 32), "cpu", pin=False)[0]
    ir, _ = decode(ir_u16, gt_u8)
    with torch.no_grad():
        want = ref["g"](ir)
        got = model(ir.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    assert float((got - want).abs().max()) < 1e-4


def test_train_steps_match_the_program():
    spec = tiny.spec(tiny.TRAIN, ngf=8, hw=32)
    cfg = copy.deepcopy(spec["config"])
    cfg["port_config"]["compute_dtype"] = "f32"
    cell = cells.Train(cfg, spec["traffic"], tiny.SEED, "cpu", Spans())
    cell.setup()
    cell.release()
    numbers = cell.check(detail=True)
    # Step 1's losses agree to round-off; Adam carries it into the later
    # steps. A weight gradient ahead of an instance norm is a sum that nearly
    # cancels (the norm's backward has zero mean over the plane), so sums
    # taken in another order move its direction by a few 1e-3 in float32.
    assert numbers["loss1_gap"] < 1e-5, numbers
    assert numbers["grad1_dir_gap"] < 2e-2, numbers
    assert numbers["change_gap"] < 1e-2, numbers
    assert numbers["detail"]["grad1_gap"] < 1e-2, numbers
    assert compare.counted_leaves({"g.a": 1.0, "g.b": 1e-9, "g.c": 2.0}) == ["g.a", "g.c"]
