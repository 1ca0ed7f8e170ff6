"""Spatial training end to end on the CPU, as ``tests/test_train.py``
(``test_train_kaist_spatial_mode``, ``test_train_spatial_requires_gspmd``)
runs the JAX package's: ``train_kaist`` with ``sp_devices=2`` on the
synthetic KAIST tree (every batch cut into 2 H-shards on the CPU, the
spatial val step), then ``python -m ircolor_tpu_torch train --sp-devices 2
--device cpu --resume`` continuing it; ``dp_mode="shard_map"`` with
``sp_devices`` > 1 raises JAX's ``ValueError``."""

import logging
import os

import numpy as np
import pytest
import torch

from ircolor_tpu_torch.cli import main
from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.train.loop import train_kaist
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

_CPU = torch.device("cpu")


def _cfg(root, save, **kw):
    return Config(img_size=32, batch_size=2, epochs=1, save_every=1, n_blocks=1, ngf=8,
                  num_workers=2, train_roots=(str(root / "set00"),), save_dir=str(save),
                  lr_decay_start_epoch=1, **kw)


def test_train_kaist_spatial_then_cli_resume(kaist_tree, tmp_path, caplog):
    caplog.set_level(logging.INFO)
    root, _ = kaist_tree
    save = tmp_path / "sp_ckpt"
    cfg = _cfg(root, save, sp_devices=2)
    summary = train_kaist(cfg, device="cpu", max_steps_per_epoch=2)
    assert np.isfinite(summary["best_val_l1"])
    losses = summary["final_epoch_losses"]
    assert np.isfinite(losses["loss_G"]) and np.isfinite(losses["loss_D"])
    assert losses["loss_G_L1"] <= 2.0 * cfg.lambda_L1
    assert summary["steps_total"] == 2
    g = summary["state"].g
    assert g.spatial_mesh == [_CPU, _CPU] and not g.resblocks[0].pallas_block
    assert "H over 2 shards" in caplog.text
    for name in ("netG_epoch_001.pth", "netG_best.pth", os.path.join("state", "0001.pt")):
        assert os.path.isfile(save / name), name

    caplog.clear()
    argv = ["train", "--device", "cpu", "--sp-devices", "2", "--img-size", "32",
            "--batch-size", "2", "--save-every", "1", "--n-blocks", "1", "--ngf", "8",
            "--num-workers", "2", "--train-roots", str(root / "set00"), "--save-dir",
            str(save), "--lr-decay-start-epoch", "1", "--epochs", "2", "--resume"]
    assert main(argv) == 0
    assert "Resumed from epoch 1" in caplog.text and "Epoch [2/2] DONE" in caplog.text
    assert os.path.isfile(save / "netG_epoch_002.pth")


def test_train_spatial_requires_gspmd(kaist_tree, tmp_path):
    root, _ = kaist_tree
    cfg = _cfg(root, tmp_path / "sp_bad", sp_devices=2, dp_mode="shard_map")
    with pytest.raises(ValueError, match="gspmd"):
        train_kaist(cfg, device="cpu")
