"""The int8 accuracy gate of the port's serving mode (the logic of the JAX
package's ``tools/int8budget.py``).

Runs ``run_test`` twice on the same weights and test tree, float and int8
(``quant_int8`` False, then True; everything else the same), and reports
what a user of the metric summary would see change: ΔPSNR (dB), ΔSSIM,
ΔMAE and ΔMSE of the summaries against the ground truth, and the
histogram of per-pixel uint8 |Δ| between the two modes' saved predictions.
With ``--assert-max-dpsnr`` / ``--assert-max-dssim`` it is a gate: exit 1
when |ΔPSNR| or |ΔSSIM| exceeds its bound. The repository's serving budget
is 0.02 dB and 0.002 SSIM, on a trained checkpoint at 512×640:

    python -m ircolor_tpu_torch.eval.int8budget --weights netG_best.pth \\
        --tree /path/kaist_tree --assert-max-dpsnr 0.02 --assert-max-dssim 0.002

Without ``--tree`` a synthetic tree is written under ``--out``. ``--config``
takes a JSON ``Config`` (a variant: ``"norm": "batch"``, ``"no_antialias":
true``, ...) as the base of both runs; without it the base is bf16 at
512×640, batch 8. ``--height``, ``--width``, ``--batch`` and ``--weights``
override the base only where they are given. It runs on the card unless
``--device cpu``. Reading the test tree and the saved predictions needs
cv2.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Sequence

import numpy as np

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.eval.runner import run_test

_KEYS = ("mean_mae", "mean_mse", "mean_psnr", "mean_ssim")


def summary_deltas(f: dict, q: dict) -> dict:
    """The two summaries and int8 − float of PSNR, SSIM and MAE."""
    return {
        "float": {k: f.get(k) for k in _KEYS},
        "int8": {k: q.get(k) for k in _KEYS},
        "delta_psnr_db": (q.get("mean_psnr") or 0) - (f.get("mean_psnr") or 0),
        "delta_ssim": (q.get("mean_ssim") or 0) - (f.get("mean_ssim") or 0),
        "delta_mae": (q.get("mean_mae") or 0) - (f.get("mean_mae") or 0),
    }


def pixel_delta_histogram(float_dir: str, int8_dir: str, sets: Sequence[str]) -> tuple[int, dict]:
    """(frames, shares of uint8 |Δ| = 0, ≤ 1, ≤ 2, ≤ 4 and the max) over the
    predictions both runs saved under the same relative path in the
    mirrored ``sets`` folders (not the Top-K copies)."""
    import cv2

    def pngs(root):
        return {os.path.relpath(p, root): p for name in sets
                for p in glob.glob(os.path.join(root, name, "**", "*.png"), recursive=True)}

    fl, qt = pngs(float_dir), pngs(int8_dir)
    common = sorted(set(fl) & set(qt))
    hist = np.zeros(256, np.int64)
    for rel in common:
        a = cv2.imread(fl[rel], cv2.IMREAD_COLOR).astype(np.int16)
        b = cv2.imread(qt[rel], cv2.IMREAD_COLOR).astype(np.int16)
        hist += np.bincount(np.abs(a - b).ravel(), minlength=256)
    total = max(int(hist.sum()), 1)
    frac_le = np.cumsum(hist) / total
    return len(common), {
        "frac_0": float(hist[0] / total),
        "frac_le_1": float(frac_le[1]),
        "frac_le_2": float(frac_le[2]),
        "frac_le_4": float(frac_le[4]),
        "max": int(np.max(np.nonzero(hist)[0])) if hist.sum() else 0,
    }


def gate(result: dict, max_dpsnr: float | None, max_dssim: float | None) -> list[str]:
    """The bounds ``result`` breaks (none: an empty list)."""
    failures = []
    if max_dpsnr is not None and abs(result["delta_psnr_db"]) > max_dpsnr:
        failures.append(f"|dPSNR| {abs(result['delta_psnr_db']):.4f} dB > {max_dpsnr}")
    if max_dssim is not None and abs(result["delta_ssim"]) > max_dssim:
        failures.append(f"|dSSIM| {abs(result['delta_ssim']):.5f} > {max_dssim}")
    return failures


def run_budget(base: Config, tree: str, out: str, device: str | None = None) -> dict:
    """Float and int8 ``run_test`` of ``base`` (its weights, sizes and
    batch) on every set under ``tree``; the summary deltas and the pixel
    histogram."""
    roots = tuple(sorted(p for p in glob.glob(os.path.join(tree, "*")) if os.path.isdir(p)))
    summaries = {}
    for mode, quant in (("float", False), ("int8", True)):
        cfg = base.replace(mode="test", quant_int8=quant, test_roots=roots,
                           output_dir=os.path.join(out, mode), topk=0, save_comparisons=False)
        summaries[mode] = run_test(cfg, device=device)
    frames, hist = pixel_delta_histogram(os.path.join(out, "float"), os.path.join(out, "int8"),
                                         [os.path.basename(r) for r in roots])
    f, q = summaries["float"], summaries["int8"]
    if f.get("count") != q.get("count"):
        raise RuntimeError(f"the two runs scored {f.get('count')} and {q.get('count')} frames")
    return {"frames": frames, **summary_deltas(f, q), "pixel_abs_delta": hist}


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ircolor_tpu_torch.eval.int8budget",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", default=None, help="netG .pth (random weights without one)")
    ap.add_argument("--config", default=None, help="JSON Config, the base of both runs")
    ap.add_argument("--tree", default=None, help="KAIST-layout test tree (else synthetic)")
    ap.add_argument("--height", type=int, default=None, help="default 512, or --config's")
    ap.add_argument("--width", type=int, default=None, help="default 640, or --config's")
    ap.add_argument("--frames", type=int, default=24, help="frames of the synthetic tree")
    ap.add_argument("--batch", type=int, default=None, help="default 8, or --config's")
    ap.add_argument("--out", default="int8budget_out")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--assert-max-dpsnr", type=float, default=None)
    ap.add_argument("--assert-max-dssim", type=float, default=None)
    args = ap.parse_args(argv)

    if args.config:
        with open(args.config, encoding="utf-8") as f:
            base = Config.from_json(f.read())
    else:
        base = Config(img_height=512, img_width=640, compute_dtype="bf16", test_batch_size=8)
    passed = {"img_height": args.height, "img_width": args.width,
              "test_batch_size": args.batch, "test_G_weights": args.weights}
    base = base.replace(**{k: v for k, v in passed.items() if v is not None})
    tree = args.tree
    if tree is None:
        from ircolor_tpu_torch.data.synthetic import make_kaist_tree

        tree = os.path.join(args.out, "tree")
        if not os.path.isdir(tree):
            make_kaist_tree(tree, sets={"set02": {"V000": args.frames}}, size_hw=base.resolved_hw)
    result = run_budget(base, tree, args.out, args.device)
    print(json.dumps(result, indent=2, default=float))
    failures = gate(result, args.assert_max_dpsnr, args.assert_max_dssim)
    if failures:
        print("INT8 BUDGET GATE FAILED: " + "; ".join(failures))
        return 1
    if args.assert_max_dpsnr is not None or args.assert_max_dssim is not None:
        print("INT8 BUDGET GATE PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
