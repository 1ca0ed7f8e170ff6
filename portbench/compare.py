"""The numbers that decide ``correct``: what the timed path produced against
what the plain reference computes from the same seeded weights and inputs,
each held to its limit in ``limits/<cell>.json``.

Serving, over the images of the sampled batches:
  u8_image_gap   the largest mean |prediction - reference prediction| of an
                 image, uint8 levels: the generator and the uint8 step
  mae_gap, mse_gap, psnr_gap_db, ssim_gap
                 the largest |program's metric - the reference's| of an
                 image, each side's metric on its own prediction against the
                 same ground truth
Training, over the first steps that set-up ran:
  loss1_gap      the larger |loss - reference loss| / |reference loss| of
                 step 1's loss_D and loss_G (the later steps' losses carry
                 Adam's sign-like first update of round-off: PERF.md)
  grad1_dir_gap  the median leaf's |g - g_ref| / |g_ref| of step 1's
                 gradient (G's or D's, the larger): the gradient's
                 direction, which a batch cut in half moves far
  change_gap     the worst leaf's |norm of its change after the last
                 checked step - the reference's| / max(the reference's
                 norm, the median leaf's): a leaf left unmoved or moved
                 twice reads about 1
                 Leaves whose reference gradient lies under a thousandth of
                 the median leaf's (biases ahead of an instance norm, moved
                 by round-off alone) are left out of both leaf numbers.
A cell's limits name the numbers it compares: a number that its control
does not move three times as far as sound runs do separates nothing, and is
read (``calibrate``) but not compared (PERF.md).
"""

from __future__ import annotations

import math
import statistics

import torch

_NEGLIGIBLE = 1e-3


def _metric_gaps(m: dict, ref_m: dict, reduce) -> dict:
    out = {}
    for key in ("mae", "mse", "psnr", "ssim"):
        a, b = m[key].double(), ref_m[key].double()
        same_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
        gap = torch.where(same_inf, torch.zeros_like(a), (a - b).abs())
        out[key] = float(reduce(gap)) if not torch.isnan(gap).any() else math.inf
    return out


def serve_numbers(pred: torch.Tensor, m: dict, ref_pred: torch.Tensor, ref_m: dict,
                  judged_m: dict | None = None) -> dict:
    """``pred``, ``m``: the program's uint8 predictions and metrics;
    ``ref_pred``, ``ref_m``: the reference's of the same frames;
    ``judged_m``: the reference's metrics of the program's predictions,
    where given, for ``serve_detail``."""
    d = (pred.int() - ref_pred.int()).abs().float()
    gaps = _metric_gaps(m, ref_m, torch.max)
    return {"u8_image_gap": float(d.mean(dim=(1, 2, 3)).max()), "mae_gap": gaps["mae"],
            "mse_gap": gaps["mse"], "psnr_gap_db": gaps["psnr"], "ssim_gap": gaps["ssim"]}


def serve_detail(pred, m, ref_pred, ref_m, judged_m) -> dict:
    """What lies under ``serve_numbers``: the mean |d| of every pixel, the
    metrics' mean gaps over the images, and the gaps of the program's
    metrics from the reference's metrics of the program's own predictions."""
    d = (pred.int() - ref_pred.int()).abs().float()
    return {"u8_mean_abs": float(d.mean()), "mean_gaps": _metric_gaps(m, ref_m, torch.mean),
            "arith_gaps": _metric_gaps(m, judged_m, torch.max)}


def _leaf_gap(prog: dict, ref: dict, counted: list) -> float:
    worst = 0.0
    for net in ("g.", "d."):
        leaves = [k for k in counted if k.startswith(net)]
        if not leaves:
            continue
        median = statistics.median(ref[k] for k in leaves)
        for k in leaves:
            worst = max(worst, abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], median, 1e-30))
    return worst


def counted_leaves(ref_grad1: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's of its net."""
    out = []
    for net in ("g.", "d."):
        leaves = [k for k in ref_grad1 if k.startswith(net)]
        if leaves:
            median = statistics.median(ref_grad1[k] for k in leaves)
            out += [k for k in leaves if ref_grad1[k] >= _NEGLIGIBLE * median]
    return out


def _direction_gap(prog: dict, ref: dict, counted: list) -> float:
    """The median counted leaf's |g - g_ref| / |g_ref| of step 1's gradient,
    the larger of G's and D's."""
    worst = 0.0
    for net in ("g.", "d."):
        gaps = []
        for k in (k for k in counted if k.startswith(net)):
            r = ref[k].float()
            p = prog[k].to(r.device).float() if k in prog else torch.zeros_like(r)
            gaps.append(float((p - r).norm() / r.norm().clamp(min=1e-30)))
        if gaps:
            worst = max(worst, statistics.median(gaps))
    return worst


def train_numbers(prog: dict, ref: dict) -> dict:
    """loss1_gap: step 1's losses; grad1_dir_gap: step 1's gradients'
    directions; change_gap: the worst leaf's change after the checked steps
    (the module docstring)."""
    p1, r1 = prog["losses"][0], ref["losses"][0]
    loss = max(abs(p1[k] - r1[k]) / max(abs(r1[k]), 1e-12) for k in r1)
    if any(not math.isfinite(v) for p in prog["losses"] for v in p.values()):
        loss = math.inf
    counted = counted_leaves(ref["grad1"])
    return {"loss1_gap": loss,
            "grad1_dir_gap": _direction_gap(prog["grad1_full"], ref["grad1_full"], counted),
            "change_gap": _leaf_gap(prog["change"], ref["change"], counted)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that ``limits`` names finite and within its limit,
    {name: [number, limit]}); a limit without a number fails."""
    checks = {k: [numbers.get(k), lim] for k, lim in sorted(limits.items())}
    ok = all(v is not None and math.isfinite(v) and v <= lim for v, lim in checks.values())
    return ok, checks


def train_detail(prog: dict, ref: dict) -> dict:
    """What lies under ``train_numbers``: each step's relative gap of each
    loss, the five worst leaves of the first gradient and of the change
    (leaf, program, reference, gap), and the median counted leaf's gaps."""
    counted = counted_leaves(ref["grad1"])
    out = {"loss_gaps": [{k: abs(p[k] - r[k]) / max(abs(r[k]), 1e-12) for k in r}
                         for p, r in zip(prog["losses"], ref["losses"])],
           "grad1_gap": _leaf_gap(prog["grad1"], ref["grad1"], counted)}
    for key in ("grad1", "change"):
        gaps = []
        for net in ("g.", "d."):
            leaves = [k for k in counted if k.startswith(net)]
            if not leaves:
                continue
            median = statistics.median(ref[key][k] for k in leaves)
            gaps += [(k, prog[key].get(k, 0.0), ref[key][k],
                      abs(prog[key].get(k, 0.0) - ref[key][k]) / max(ref[key][k], median, 1e-30))
                     for k in leaves]
        gaps.sort(key=lambda g: -g[3])
        out[f"{key}_worst"] = gaps[:5]
        out[f"{key}_median_gap"] = statistics.median(g[3] for g in gaps)
    return out
