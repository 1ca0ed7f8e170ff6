"""Data parallelism over several cards, one rank a card (NCCL), at the
flagship (``configs/flagship_512x640.json``): the training step of
``--ranks`` N ranks (global b8, ``dp_mode="shard_map"``) beside one
process's b8 step on cuda:0, and test mode over a data mesh of the first
N cards beside the unsharded b32 step. Each mesh's uint8 predictions and
metrics must match one card's step on the same chunks within the serving
budget (``tools.flagship.within_budget``), or the probe fails. Prints one
line a reading, with the card's name and power limit. Needs N cards:

    python3 -m ircolor_tpu_torch.tools.dp_probe --ranks 2 --ranks 4
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.parallel.launch import spawn
from ircolor_tpu_torch.tools import flagship as fs
from ircolor_tpu_torch.tools.dp_steps import one_process_steps, run_rank

STEPS = 4  # the first held against one process, 3 timed


def log(msg: str) -> None:
    print(msg, flush=True)


def train(ranks: list[int]) -> None:
    cfg = Config.from_json(fs.FLAGSHIP.read_text()).replace(
        mode="train", seed=fs.SEED, dp_mode="shard_map")
    batches = [{"ir": ir, "rgb": gt}
               for ir, gt in fs.synthetic_batches(STEPS, fs.TRAIN_B)]
    one = one_process_steps(cfg.replace(dp_devices=1), torch.device("cuda", 0), batches)
    one_ms = float(np.mean(one["step_ms"][1:]))
    log(f"[dp probe train] one process b{fs.TRAIN_B} on cuda:0: {one_ms:.1f} ms a step, "
        f"{one['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()
    for n in ranks:
        t0 = time.perf_counter()
        outs = spawn(run_rank, [torch.device("cuda", r) for r in range(n)],
                     (cfg.replace(dp_devices=n), batches), timeout_s=600)
        equal = all(o["equal"] == [True] * STEPS for o in outs)
        rel = {k: abs(outs[0]["losses"][0][k] - one["losses"][0][k]) / abs(one["losses"][0][k])
               for k in ("loss_D", "loss_G_L1")}
        step = [float(np.mean(o["step_ms"][1:])) for o in outs]
        comm = [float(np.mean(o["comm_ms"][1:])) for o in outs]
        log(f"[dp probe train] {n} ranks on cuda:0..{n - 1} (NCCL, b{fs.TRAIN_B // n} a rank) "
            f"in {time.perf_counter() - t0:.1f} s: replicas bit-identical {equal}; step-1 "
            f"relative loss_D {rel['loss_D']:.2e}, L1 {rel['loss_G_L1']:.2e}; ms a step "
            + " / ".join(f"{v:.1f}" for v in step) + ", all-reduce "
            + " / ".join(f"{c:.1f} ({c / s:.3f})" for c, s in zip(comm, step))
            + f"; peak {max(o['peak_gib'] for o in outs):.2f} GiB a rank; "
            f"{fs.TRAIN_B * 1e3 / max(step):.2f} frames/s against one process's "
            f"{fs.TRAIN_B * 1e3 / one_ms:.2f}")
        if not equal:
            raise AssertionError(f"{n} ranks: the replicas differ")


def serve(ranks: list[int]) -> None:
    from ircolor_tpu_torch.eval.runner import make_infer_fn
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    cfg = fs.serving_config()
    model = IRColorizationModel(cfg, "cuda:0")
    batches = [(torch.from_numpy(ir).cuda(), torch.from_numpy(gt).cuda())
               for ir, gt in fs.synthetic_batches(3, fs.B)]
    steps = {1: make_infer_fn(model.module)}
    steps.update({n: make_infer_fn(model.module, [torch.device("cuda", r) for r in range(n)])
                  for n in ranks})
    fps: dict = {n: [] for n in steps}
    torch.cuda.synchronize()
    ir, gt = batches[0]
    whole = steps[1](ir, gt)
    for n in ranks:  # the first call also warms the mesh's replicas up
        pred, metrics = steps[n](ir, gt)
        # The reference: one card's step on the same chunks in turn, so the
        # same local batch picks the same cuDNN algorithms (at b8 one conv
        # takes another tile, which these random weights carry to ~2 uint8
        # levels from the b32 step: read out, not held).
        per = fs.B // n
        parts = [steps[1](ir[i:i + per], gt[i:i + per]) for i in range(0, fs.B, per)]
        want = (torch.cat([p for p, _ in parts]),
                {k: torch.cat([m[k] for _, m in parts]) for k in metrics})
        delta = fs.route_delta(pred, metrics, *want)
        same = bool(torch.equal(pred, want[0])) and all(
            torch.equal(metrics[k], want[1][k]) for k in metrics)
        log(f"[dp probe serve] {n} cards vs one card on the same chunks of {per}, int8: "
            f"{delta['text']}; bit-identical: {same}; vs the one-card b{fs.B} step: "
            f"{fs.route_delta(pred, metrics, *whole)['text']}")
        if not fs.within_budget(delta):
            raise AssertionError(f"{n} cards: outside the serving budget: {delta['text']}")
    for n in [*steps, *reversed(list(steps))]:
        for r in range(torch.cuda.device_count()):
            torch.cuda.synchronize(r)
        t0 = time.perf_counter()
        for ir, gt in batches:
            steps[n](ir, gt)
        for r in range(torch.cuda.device_count()):
            torch.cuda.synchronize(r)
        fps[n].append(len(batches) * fs.B / (time.perf_counter() - t0))
    log("[dp probe serve] int8 b32 frames/s (turns there and back): "
        + "; ".join(f"{n} card{'s' if n > 1 else ''} " + " / ".join(f"{v:.2f}" for v in fps[n])
                    for n in steps))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, action="append", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < max(args.ranks):
        print(f"dp_probe: needs {max(args.ranks)} cards", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[card] {smi.splitlines()}")
    train(args.ranks)
    serve(args.ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
