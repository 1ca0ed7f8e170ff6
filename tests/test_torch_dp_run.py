"""The data-parallel entry points on the CPU: test mode over a 2-chunk data
mesh against JAX's ``make_infer_fn(dp_mesh=...)`` on 2 fake devices and
against the port's unsharded step, ``run_test`` with ``dp_devices=2`` and
its refusals, ``train_kaist``'s spawn of the ranks, and ``train
--dp-devices 2 --device cpu`` through the CLI on two spawned ranks (a
final validation slice of 0 rows on rank 0; one set of checkpoints; a
resume). Per-image bounds are
``tests/test_torch_runner.py``'s: MAE/MSE 1e-5, PSNR 0.01 dB, SSIM 1e-4,
uint8 at most 1 level apart on ≤ 1% of values."""

import csv
import os

import numpy as np
import pytest
import torch

from ircolor_tpu.config import Config as JConfig
from ircolor_tpu.eval.runner import make_infer_fn as jmake_infer_fn
from ircolor_tpu.models.wrapper import generator_from_config as jgenerator_from_config
from ircolor_tpu.parallel.mesh import make_data_mesh as jmake_data_mesh

from ircolor_tpu_torch.compat import flax_from_state_dict
from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.eval.runner import make_infer_fn, run_test
from ircolor_tpu_torch.models.wrapper import IRColorizationModel
from ircolor_tpu_torch.parallel.launch import spawn
from ircolor_tpu_torch.train import loop
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

import torch_dp_ranks

_CPU = torch.device("cpu")


def _assert_served_alike(pred_a, m_a, pred_b, m_b):
    d = np.abs(np.asarray(pred_a, np.int32) - np.asarray(pred_b, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
    for k, tol in (("mae", 1e-5), ("mse", 1e-5), ("psnr", 0.01), ("ssim", 1e-4)):
        np.testing.assert_allclose(np.asarray(m_a[k]), np.asarray(m_b[k]), rtol=0, atol=tol,
                                   err_msg=k)


def test_dp_test_mode_matches_jax(eight_cpu_devices):
    """f32, 32×32, batch 4 over 2 chunks: each chunk through the whole step
    (decode, generator, uint8, metrics) on its mesh entry. The port's seeded
    weights go to JAX as its param tree."""
    kw = dict(img_size=32, ngf=8, n_blocks=1, test_batch_size=4)
    model = IRColorizationModel(Config(**kw), "cpu")
    jparams = flax_from_state_dict(model.module.state_dict())
    jmodule = jgenerator_from_config(JConfig(**kw))
    rng = np.random.RandomState(0)
    ir = rng.randint(0, 65536, (4, 32, 32, 1)).astype(np.uint16)
    gt = rng.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    jpred, jm = jmake_infer_fn(jmodule, dp_mesh=jmake_data_mesh(2))(jparams, ir, gt)
    infer = make_infer_fn(model.module, dp_mesh=[_CPU, _CPU])
    pred, m = infer(torch.from_numpy(ir), torch.from_numpy(gt))
    assert pred.shape == (4, 32, 32, 3) and pred.dtype == torch.uint8
    assert all(v.shape == (4,) for v in m.values())
    _assert_served_alike(pred.numpy(), {k: v.numpy() for k, v in m.items()}, jpred, jm)
    pred1, m1 = make_infer_fn(model.module)(torch.from_numpy(ir), torch.from_numpy(gt))
    _assert_served_alike(pred.numpy(), {k: v.numpy() for k, v in m.items()}, pred1.numpy(),
                         {k: v.numpy() for k, v in m1.items()})
    with pytest.raises(ValueError, match="must divide"):
        infer(torch.from_numpy(ir[:3]), torch.from_numpy(gt[:3]))


def _rows(path):
    with open(path) as f:
        return {r[0]: [float(x) for x in r[1:]] for r in csv.reader(f)
                if r and not r[0].startswith("#") and r[0] != "file"}


def test_run_test_data_parallel_and_its_refusals(kaist_tree, tmp_path):
    root, _ = kaist_tree
    base = dict(mode="test", img_size=32, test_batch_size=4, ngf=8, n_blocks=1, topk=3,
                test_roots=(str(root / "set02"),), num_workers=2)
    s1 = run_test(Config(output_dir=str(tmp_path / "one"), **base), device="cpu")
    s2 = run_test(Config(output_dir=str(tmp_path / "dp"), dp_devices=2, **base), device="cpu")
    assert s1["count"] == s2["count"] == 7
    r1, r2 = _rows(tmp_path / "one" / "metrics_test.csv"), _rows(tmp_path / "dp" / "metrics_test.csv")
    assert r1.keys() == r2.keys()
    for f in r1:
        for a, b, tol in zip(r1[f], r2[f], (1e-5, 1e-5, 0.01, 1e-4)):  # MAE, MSE, PSNR, SSIM
            assert abs(a - b) <= tol, f
    for bad, msg in ((dict(dp_devices=2, sp_devices=2), "mutually exclusive"),
                     (dict(dp_devices=3), "must divide by dp_devices 3")):
        out = tmp_path / "refused"
        with pytest.raises(ValueError, match=msg):
            run_test(Config(output_dir=str(out), **{**base, **bad}), device="cpu")
        assert not out.exists()


def test_ranks_must_agree_on_the_summary(monkeypatch, tmp_path):
    """Without a process group, ``train_kaist`` spawns a rank a device of
    ``make_train_mesh`` (``dp_devices=2`` on the named CPU: two) and returns
    rank 0's summary, raising where another rank's differs."""
    same = {"best_val_l1": 0.5, "final_epoch_losses": {"loss_D": 1.0}, "epochs_run": 1,
            "steps_total": 4, "wall_s": 1.0}
    cfg = Config(dp_devices=2, batch_size=2, save_dir=str(tmp_path))
    calls = []

    def fake_spawn(other):
        def run(fn, devices, args, **kw):
            calls.append((fn, devices, args))
            return [same, other]
        return run

    monkeypatch.setattr(loop, "spawn", fake_spawn({**same, "wall_s": 2.0}))
    assert loop.train_kaist(cfg, device="cpu") is same
    assert calls == [(loop._train_rank, [_CPU, _CPU], (cfg, None))]
    monkeypatch.setattr(loop, "spawn", fake_spawn({**same, "best_val_l1": 0.4}))
    with pytest.raises(RuntimeError, match="rank 1's summary differs"):
        loop.train_kaist(cfg, device="cpu")


def test_cli_train_data_parallel_and_resume(tmp_path, capfd):
    """The ``train`` CLI on two gloo ranks of one spawn: 10 pairs, 9 to
    train (4 steps of the global batch 2, 1 row a rank), 1 to validate
    (rank 0's slice of it has 0 rows); 1 epoch, then ``--resume`` to 2.
    Rank 0 logs and writes one set of checkpoints; both ranks resume and
    report the same summaries."""
    from ircolor_tpu_torch.data.synthetic import make_kaist_tree

    make_kaist_tree(str(tmp_path / "tree"), {"set00": {"V000": 10}}, size_hw=(32, 32))
    save = tmp_path / "ckpt"
    argv = ["train", "--device", "cpu", "--dp-devices", "2", "--img-size", "32",
            "--batch-size", "2", "--ngf", "8", "--n-blocks", "1", "--lambda-perc", "0",
            "--save-every", "1", "--lr-decay-start-epoch", "1",
            "--train-roots", str(tmp_path / "tree" / "set00"), "--save-dir", str(save),
            "--num-workers", "1"]
    ranks = spawn(torch_dp_ranks.train_cli_then_resume, [_CPU, _CPU], (argv,), timeout_s=240)
    out = capfd.readouterr().out
    assert ranks[0] == ranks[1] and [s["epochs_run"] for s in ranks[0]] == [1, 1]
    assert out.count("train: 9, val: 1") == 2  # rank 0 logs, once a run
    assert out.count("Epoch [1/1] DONE") == 1 and out.count("Epoch [2/2] DONE") == 1
    assert out.count("Resumed from epoch 1") == 1 and "Epoch [1/2]" not in out
    assert sorted(os.listdir(save)) == ["netG_best.msgpack", "netG_best.pth",
                                        "netG_epoch_001.msgpack", "netG_epoch_001.pth",
                                        "netG_epoch_002.msgpack", "netG_epoch_002.pth", "state"]
    assert sorted(os.listdir(save / "state")) == ["0001.pt", "0002.pt"]
