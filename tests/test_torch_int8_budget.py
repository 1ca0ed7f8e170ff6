"""The port's int8 accuracy gate (``ircolor_tpu_torch.eval.int8budget``) on
the CPU: the micro-train gate of ``tests/test_quant.py::
test_int8_budget_gate_micro_train`` on the port, and the assert flags'
exit code on doctored summaries."""

import json
import os

import pytest

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.eval import int8budget
from ircolor_tpu_torch.train.loop import train_kaist
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def test_int8_budget_gate_micro_train(kaist_tree, tmp_path):
    """The port's own ``train_kaist`` micro-trains a small generator (32²,
    ngf 16, 2 blocks, 2 epochs) on the synthetic tree; the gate's
    ``run_budget`` then runs the port's ``run_test`` on the trained weights
    in float and int8 (the int8 route of every heavy conv: f32, no fused
    gate) and the summary deltas stay inside the JAX test's bounds: 0.3 dB
    PSNR, 0.01 SSIM, 0.005 MAE. A broken scale fold moves PSNR by whole
    dB; the full-scale gate (0.02 dB / 0.002 at 512×640 on a trained
    checkpoint) is the tool's ``--assert-max-*`` run."""
    root, _ = kaist_tree
    train_cfg = Config(
        mode="train", img_size=32, batch_size=2, epochs=2, save_every=2, n_blocks=2, ngf=16,
        num_workers=2, train_roots=(str(root / "set00"),), save_dir=str(tmp_path / "ckpt"),
        lr_decay_start_epoch=1, log_every=5, seed=0,
    )
    train_kaist(train_cfg, device="cpu")
    pth = os.path.join(train_cfg.save_dir, "netG_epoch_002.pth")
    assert os.path.isfile(pth)
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "set02").symlink_to(root / "set02")
    base = Config(img_size=32, test_batch_size=4, n_blocks=2, ngf=16, num_workers=2,
                  test_G_weights=pth)
    result = int8budget.run_budget(base, str(tree), str(tmp_path / "out"), device="cpu")
    assert result["frames"] == 11  # 7 pairs and 4 IR frames without GT
    f, q = result["float"], result["int8"]
    assert abs(result["delta_psnr_db"]) < 0.3, result
    assert abs(result["delta_ssim"]) < 0.01, result
    assert abs(q["mean_mae"] - f["mean_mae"]) < 0.005, result
    assert 0.0 < result["pixel_abs_delta"]["frac_le_4"] <= 1.0


@pytest.mark.parametrize("d_psnr,d_ssim,flags,want", [
    (-0.011, -0.0002, ("--assert-max-dpsnr", "0.02", "--assert-max-dssim", "0.002"), 0),
    (-0.031, -0.0002, ("--assert-max-dpsnr", "0.02", "--assert-max-dssim", "0.002"), 1),
    (0.005, 0.0025, ("--assert-max-dpsnr", "0.02", "--assert-max-dssim", "0.002"), 1),
    (-0.5, -0.01, (), 0),  # no assert flag: a report, not a gate
])
def test_assert_flags_exit_1_on_a_breach(monkeypatch, tmp_path, capsys, d_psnr, d_ssim, flags,
                                         want):
    """``main`` with doctored summaries in place of the two ``run_test``
    runs: it returns 1 (the module's exit code) and names the breach when
    |ΔPSNR| or |ΔSSIM| exceeds its bound, 0 otherwise."""
    summaries = {
        False: dict(count=4, mean_mae=0.05, mean_mse=0.004, mean_psnr=24.0, mean_ssim=0.81),
        True: dict(count=4, mean_mae=0.05, mean_mse=0.004, mean_psnr=24.0 + d_psnr,
                   mean_ssim=0.81 + d_ssim),
    }
    seen = []

    def doctored(cfg, device=None):
        seen.append((cfg.quant_int8, cfg.test_roots, device))
        return summaries[cfg.quant_int8]

    monkeypatch.setattr(int8budget, "run_test", doctored)
    (tmp_path / "tree" / "set02").mkdir(parents=True)
    rc = int8budget.main(["--tree", str(tmp_path / "tree"), "--out", str(tmp_path / "out"),
                          "--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert rc == want
    assert [s[0] for s in seen] == [False, True] and all(s[2] == "cpu" for s in seen)
    assert seen[0][1] == (str(tmp_path / "tree" / "set02"),)
    result = json.loads(out[: out.rindex("}") + 1])
    assert result["delta_psnr_db"] == pytest.approx(d_psnr)
    assert result["delta_ssim"] == pytest.approx(d_ssim)
    assert ("INT8 BUDGET GATE FAILED" in out) == (want == 1)
    assert ("INT8 BUDGET GATE PASSED" in out) == (want == 0 and bool(flags))


@pytest.mark.parametrize("flags,want_batch,want_weights", [
    ((), 3, "from_config.pth"),
    (("--batch", "5", "--weights", "flag.pth"), 5, "flag.pth"),
])
def test_config_sets_the_base_and_flags_override_only_when_given(monkeypatch, tmp_path, flags,
                                                                  want_batch, want_weights):
    """A ``--config`` that sets f32, its own image size, test batch and
    weights reaches both ``run_test`` runs as it is; ``--batch`` and
    ``--weights`` replace the config's value only when they are passed.
    Without ``--tree`` the synthetic tree is written at the config's size."""
    import cv2

    cfg_path = tmp_path / "variant.json"
    cfg_path.write_text(json.dumps({"compute_dtype": "f32", "img_height": 32, "img_width": 48,
                                    "test_batch_size": 3, "norm": "batch",
                                    "test_G_weights": "from_config.pth"}))
    seen = []

    def doctored(cfg, device=None):
        seen.append(cfg)
        return dict(count=2, mean_mae=0.05, mean_mse=0.004, mean_psnr=24.0, mean_ssim=0.81)

    monkeypatch.setattr(int8budget, "run_test", doctored)
    out = tmp_path / "out"
    rc = int8budget.main(["--config", str(cfg_path), "--out", str(out), "--frames", "2",
                          "--device", "cpu", *flags])
    assert rc == 0
    assert [c.quant_int8 for c in seen] == [False, True]
    for c in seen:
        assert (c.compute_dtype, c.resolved_hw, c.norm) == ("f32", (32, 48), "batch")
        assert (c.test_batch_size, c.test_G_weights) == (want_batch, want_weights)
    frames = sorted((out / "tree" / "set02" / "V000" / "lwir").iterdir())
    assert len(frames) == 2
    assert cv2.imread(str(frames[0]), cv2.IMREAD_GRAYSCALE).shape == (32, 48)
