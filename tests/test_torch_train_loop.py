"""The port's training loop on the CPU: the device default, the KAIST data
path against the JAX package's, and ``python -m ircolor_tpu_torch train
--device cpu`` end to end with exports that load into both packages and a
``--resume`` that continues."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from ircolor_tpu.compat.torch_import import load_generator_pth
from ircolor_tpu.data import kaist as jkaist
from ircolor_tpu.data.pipeline import BatchLoader as JBatchLoader

from ircolor_tpu_torch.cli import main
from ircolor_tpu_torch.compat import state_dict_from_flax
from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.data import kaist as tkaist
from ircolor_tpu_torch.data.pipeline import BatchLoader
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def test_entry_points_default_to_the_card(tmp_path):
    """Without a card every entry point raises unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from ircolor_tpu_torch.eval.runner import run_test
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel
    from ircolor_tpu_torch.train.loop import train_kaist
    from ircolor_tpu_torch.train.state import create_train_state

    cfg = Config(ngf=8, n_blocks=1, img_size=32, output_dir=str(tmp_path / "out"),
                 test_roots=(str(tmp_path),), train_roots=(str(tmp_path),))
    for call in (lambda: IRColorizationModel(cfg), lambda: run_test(cfg),
                 lambda: create_train_state(cfg, 1), lambda: train_kaist(cfg),
                 lambda: main(["test", "--output-dir", str(tmp_path / "cli")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert IRColorizationModel(cfg, "cpu").device == torch.device("cpu")


def test_kaist_data_matches_jax(kaist_tree):
    root, _ = kaist_tree
    roots = [str(root / "set00"), str(root / "set02")]
    ir, rgb = tkaist.scan_kaist_pairs(roots)
    assert (ir, rgb) == jkaist.scan_kaist_pairs(roots)
    assert tkaist.split_train_val(len(ir), 0.1) == jkaist.split_train_val(len(ir), 0.1)
    tds = tkaist.KAISTPairDataset(ir, rgb, size_hw=(32, 40), augment=True, seed=3)
    jds = jkaist.KAISTPairDataset(ir, rgb, size_hw=(32, 40), augment=True, seed=3)
    # The C++ float assembler (use_native) rounds its normalize differently
    # from the numpy path by an ulp: each side takes the same path.
    for transport, use_native in (("int", True), ("float", False), ("float", True)):
        tl = BatchLoader(tds, 4, shuffle=True, drop_last=True, num_workers=2, seed=3,
                         transport=transport, use_native=use_native)
        jl = JBatchLoader(jds, 4, shuffle=True, drop_last=True, num_workers=2, seed=3,
                          transport=transport, use_native=use_native)
        tl.set_epoch(2)
        jl.set_epoch(2)
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(tl) == len(ir) // 4
        for a, b in zip(got, want):
            for key in ("ir", "rgb"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


def test_cli_train_end_to_end_and_resume(kaist_tree, tmp_path, caplog):
    caplog.set_level(logging.INFO)
    root, _ = kaist_tree
    save = tmp_path / "ckpt"
    jsonl = tmp_path / "log.jsonl"
    args = ["train", "--device", "cpu", "--img-size", "32", "--batch-size", "2",
            "--save-every", "1", "--n-blocks", "1", "--ngf", "8", "--num-workers", "2",
            "--train-roots", str(root / "set00"), "--save-dir", str(save),
            "--lr-decay-start-epoch", "1", "--log-every", "2", "--jsonl-log", str(jsonl)]
    assert main([*args, "--epochs", "1"]) == 0
    out = caplog.text
    assert "Epoch [1/1] Step [1/4] D:" in out and "Epoch [1/1] DONE" in out
    assert "Current LR (G): 0.000000e+00" in out
    for name in ("netG_epoch_001.pth", "netG_best.pth", os.path.join("state", "0001.pt")):
        assert os.path.isfile(save / name), name

    # The export loads into the JAX package and into the port's test mode.
    best = str(save / "netG_best.pth")
    saved = torch.load(best, weights_only=True)
    for key, v in state_dict_from_flax(load_generator_pth(best)).items():
        torch.testing.assert_close(v, saved[key], rtol=0, atol=0, msg=key)
    from ircolor_tpu_torch.eval.runner import run_test

    summary = run_test(Config(img_size=32, ngf=8, n_blocks=1, test_G_weights=best, topk=1,
                              test_roots=(str(root / "set02"),),
                              output_dir=str(tmp_path / "test_out")), device="cpu")
    assert summary["count"] == 7 and np.isfinite(summary["mean_psnr"])

    # --resume continues after the saved epoch instead of starting over.
    caplog.clear()
    assert main([*args, "--epochs", "2", "--resume"]) == 0
    assert "Resumed from epoch 1" in caplog.text
    assert os.path.isfile(save / "netG_epoch_002.pth")
    epochs = [json.loads(line)["epoch"] for line in jsonl.read_text().splitlines()]
    assert epochs == [1, 2]
