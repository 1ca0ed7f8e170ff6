"""The port's test mode end to end on the CPU: ``run_test`` of both packages
on one synthetic KAIST tree with the same weights, the
``python -m ircolor_tpu_torch test`` CLI, and the package's import
hygiene."""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(path):
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    data = [l for l in lines[1:] if l and not l.startswith("#")]
    summary = [l.split(",")[0] for l in lines if l.startswith("#")]
    return {r[0]: [float(v) for v in r[1:]] for r in csv.reader(data)}, summary, lines[0]


def test_run_test_matches_jax_runner(kaist_tree, tmp_path):
    """Same weights (the JAX init, exported as a reference .pth), same tree,
    f32 at 64×80. Per-image MAE/MSE within 1e-5, PSNR within 0.01 dB, SSIM
    within 1e-4; uint8 outputs at most 1 level apart on ≤ 1% of values
    (f32 convs sum in another order); same Top-K files and CSV layout."""
    import jax

    from ircolor_tpu.compat.torch_import import export_generator_pth
    from ircolor_tpu.config import Config as JConfig
    from ircolor_tpu.eval.runner import run_test as jax_run_test
    from ircolor_tpu.models.wrapper import IRColorizationModel as JModel

    from ircolor_tpu_torch.config import Config
    from ircolor_tpu_torch.eval.runner import run_test

    import cv2

    root, _ = kaist_tree
    base = dict(
        mode="test", img_height=64, img_width=80, test_batch_size=4, ngf=8, n_blocks=2,
        test_roots=(str(root / "set02"),), topk=3, num_workers=2,
    )
    pth = str(tmp_path / "netG.pth")
    export_generator_pth(jax.tree.map(np.asarray, JModel(JConfig(**base)).params), pth)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj = jax_run_test(JConfig(output_dir=out_j, test_G_weights=pth, **base))
    st = run_test(Config(output_dir=out_t, test_G_weights=pth, **base), device="cpu")
    assert sj["count"] == st["count"] == 7

    rj, sumj, headj = _rows(os.path.join(out_j, "metrics_test.csv"))
    rt, sumt, headt = _rows(os.path.join(out_t, "metrics_test.csv"))
    assert headj == headt and sumj == sumt and rj.keys() == rt.keys()
    for f in rj:
        (mae_j, mse_j, psnr_j, ssim_j), (mae_t, mse_t, psnr_t, ssim_t) = rj[f], rt[f]
        assert abs(mae_j - mae_t) <= 1e-5 and abs(mse_j - mse_t) <= 1e-5, f
        assert abs(psnr_j - psnr_t) <= 0.01, f
        assert abs(ssim_j - ssim_t) <= 1e-4, f

    diffs = []
    for dirpath, _, files in os.walk(os.path.join(out_j, "set02")):
        for fn in files:
            a = cv2.imread(os.path.join(dirpath, fn))
            b = cv2.imread(os.path.join(dirpath.replace(out_j, out_t, 1), fn))
            diffs.append(np.abs(a.astype(int) - b.astype(int)))
    d = np.concatenate([x.ravel() for x in diffs])
    assert len(diffs) == 11  # 7 paired frames + 4 unpaired IR-only frames
    assert d.max() <= 1 and (d > 0).mean() <= 0.01

    best = "Best_50_colored_images"
    for sub in ("colored", "collages"):
        assert sorted(os.listdir(os.path.join(out_j, best, sub))) == sorted(
            os.listdir(os.path.join(out_t, best, sub))
        )
    with open(os.path.join(out_j, best, "top_3_ranking.csv")) as fj, open(
        os.path.join(out_t, best, "top_3_ranking.csv")
    ) as ft:
        assert [l.split(",")[1] for l in fj] == [l.split(",")[1] for l in ft]


def test_cli_test_mode_writes_artifacts(kaist_tree, tmp_path):
    root, _ = kaist_tree
    out = str(tmp_path / "cli")
    proc = subprocess.run(
        [sys.executable, "-m", "ircolor_tpu_torch", "test", "--device", "cpu", "--img-size", "64",
         "--test-batch-size", "4", "--ngf", "8", "--n-blocks", "1", "--topk", "2",
         "--test-roots", str(root / "set02"), "--output-dir", out],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert os.path.isfile(os.path.join(out, "set02", "V000", "I00000.png"))
    assert os.path.isfile(os.path.join(out, "set02", "V001", "nested", "I00001.png"))
    assert os.path.isfile(os.path.join(out, "Comparisons", "set02", "V000", "I00000_cmp.png"))
    lines = open(os.path.join(out, "metrics_test.csv")).read().splitlines()
    assert lines[0] == "file,mae,mse,psnr,ssim" and "# Summary" in lines
    assert any(l.startswith("# count,7") for l in lines)
    best = os.path.join(out, "Best_50_colored_images")
    assert len(os.listdir(os.path.join(best, "colored"))) == 2
    assert os.path.isfile(os.path.join(best, "top_2_ranking.csv"))


@pytest.mark.parametrize(
    "mode,extra",
    [("train", ["--device", "cpu", "--sp-devices", "2", "--sp-w-devices", "2"])],
    ids=["train"],
)
def test_cli_unported_modes_raise(mode, extra, tmp_path, caplog):
    """No mode is left unported: ``train --sp-w-devices`` is read as JAX's
    training reads it, not at all (one log line), so the run goes on
    H-sharded over ``--sp-devices`` and stops only at the missing dataset
    (``export``: tests/test_torch_export.py; data-parallel training:
    tests/test_torch_dp_run.py; spatial training:
    tests/test_torch_sp_train_loop.py; 2-D tiling in test mode:
    tests/test_torch_sp2d.py)."""
    import logging

    from ircolor_tpu_torch.cli import main

    caplog.set_level(logging.INFO)
    with pytest.raises(RuntimeError, match="No IR-RGB pairs"):
        main([mode, *extra, "--train-roots", str(tmp_path / "none"),
              "--save-dir", str(tmp_path / "ckpt")])
    assert "sp_w_devices=2 is not used by training" in caplog.text
    assert "H over 2 shards" in caplog.text


def test_import_leaves_jax_cv2_pil_triton_out():
    """``import ircolor_tpu_torch`` and the modules ``chip_smoke.py``
    imports bring in torch only: no JAX, flax or ``msgpack`` (the card's
    machine has none), no cv2, PIL or triton at import."""
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import chip_smoke, ircolor_tpu_torch, ircolor_tpu_torch.cli;"
        "import ircolor_tpu_torch.eval.runner, ircolor_tpu_torch.models.wrapper;"
        "import ircolor_tpu_torch.kernels.build, ircolor_tpu_torch.compat;"
        "import ircolor_tpu_torch.train.loop, ircolor_tpu_torch.losses;"
        "import ircolor_tpu_torch.export.aot, ircolor_tpu_torch.kernels.library;"
        "import ircolor_tpu_torch.compat.msgpack, ircolor_tpu_torch.train.checkpoint;"
        "import ircolor_tpu_torch.utils.timing;"
        "bad = [m for m in ('jax', 'flax', 'msgpack', 'ircolor_tpu', 'cv2', 'PIL', 'triton')"
        " if m in sys.modules];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA device here: the script exits non-zero and prints no result
    line, both in the checkout and from a directory holding only itself."""
    import shutil

    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd, script in ((REPO, "chip_smoke.py"), (str(tmp_path), str(alone))):
        proc = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
