"""Spatial training at the flagship on the card: a train step cell, and a
probe of the H-shards spread over cards.

``train_cell`` builds a train state (its H-shards on ``spatial_mesh``
under ``sp_devices``), the seeded random VGG tower, and runs a few steps
on fixed synthetic batches: the first step's losses, parameters and
gradients on the host, the later steps' wall ms, the wrappers' launch
counts and the peak memory of every card the cell used. ``chip_smoke.py``
(phase 11) runs it with every shard on cuda:0;

    python3 -m ircolor_tpu_torch.tools.sp_probe --shards 2 --shards 4

runs the flagship (bf16 b8, every fused kernel off, as spatial training
routes) unsharded on cuda:0 and then with shard i on cuda:i, each S over S
cards, and prints step ms, frames/s, the peak memory of each card and the
first step's agreement with the unsharded one (phase 11's bounds: the
losses D' does not enter within 2^-10 relative, conv weight gradients
within 1e-2 relative L2), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.kernels import LAUNCHES, reset_launches
from ircolor_tpu_torch.losses.vgg import load_vgg16
from ircolor_tpu_torch.models.wrapper import _DTYPES
from ircolor_tpu_torch.parallel.mesh import shard_batch
from ircolor_tpu_torch.tools.dp_steps import snapshot
from ircolor_tpu_torch.tools.flagship import FLAGSHIP, SEED, TRAIN_B, synthetic_batches
from ircolor_tpu_torch.train.state import SPATIAL_OFF, create_train_state
from ircolor_tpu_torch.train.step import METRIC_KEYS, make_train_step

def flagship_train_config(**overrides) -> Config:
    """The flagship config in train mode with every fused kernel off, as
    spatial training turns them off (``train.state.SPATIAL_OFF``): unsharded,
    it routes as the sharded step does."""
    return Config.from_json(FLAGSHIP.read_text()).replace(
        mode="train", seed=SEED, **{f: False for f in SPATIAL_OFF}, **overrides)


def train_cell(cfg: Config, batches: list, steps: int, spatial_mesh: list | None = None,
               d_params: dict | None = None, update_d: bool = True) -> dict:
    """``steps`` train steps of ``cfg`` on ``batches`` (numpy), the state on
    cuda:0 and, under ``sp_devices``, its H-shards on ``spatial_mesh``
    (default: all on cuda:0). ``d_params``: D's parameters to start from
    (with ``update_d=False``, a G phase on them). Returns the first step's
    losses and ``snapshot`` with the parameters before it (``before``), the
    wall ms a step of the later ones, the launch counts of all the steps,
    the peak GiB of each card used and the last step's losses."""
    dev = torch.device("cuda", 0)
    state = create_train_state(cfg, steps_per_epoch=1000, device=dev,
                               spatial_mesh=spatial_mesh)
    if d_params is not None:
        with torch.no_grad():
            for name, p in state.d.named_parameters():
                p.copy_(torch.from_numpy(d_params[f"d.{name}"]))
    vgg = load_vgg16(None, cfg.seed, _DTYPES[cfg.compute_dtype]).to(dev)
    step = make_train_step(cfg, vgg, update_d=update_d)
    place = state.g.spatial_mesh or dev
    cards = sorted({d.index for d in (state.g.spatial_mesh or [dev])})
    out = {"before": snapshot(state)["params"]}
    for c in cards:
        torch.cuda.synchronize(c)
        torch.cuda.reset_peak_memory_stats(c)
    reset_launches()
    state, m = step(state, shard_batch(batches[0], place))  # step 1, also the warm-up
    out["losses"] = {k: float(v) for k, v in m.items()}
    out.update(snapshot(state))
    for c in cards:
        torch.cuda.synchronize(c)
    t0 = time.perf_counter()
    for b in batches[1:steps]:
        state, m = step(state, shard_batch(b, place))
    for c in cards:
        torch.cuda.synchronize(c)
    out["ms"] = 1e3 * (time.perf_counter() - t0) / max(steps - 1, 1)
    out["launches"] = dict(LAUNCHES)
    out["peak_gib"] = {f"cuda:{c}": torch.cuda.max_memory_allocated(c) / 2**30 for c in cards}
    out["last"] = {k: float(v) for k, v in m.items()}
    del state, vgg, step
    torch.cuda.empty_cache()
    return out


def leaf_distance(got: dict, want: dict, key: str, lr: float) -> tuple[float, float]:
    """One leaf's distance between two first steps (``train_cell``): the
    gradient's relative L2, and the share of its Adam update's entries more
    than lr/4 apart."""
    g, w = got["grads"][key], want["grads"][key]
    rel = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
    off = float((np.abs((got["params"][key] - got["before"][key])
                        - (want["params"][key] - want["before"][key])) > 0.25 * lr).mean())
    return rel, off


def agreement(got: dict, want: dict, lr: float) -> dict:
    """The first step's distance from ``want``'s: each loss's relative
    difference, and over G's and D's conv weights the worst
    ``leaf_distance``."""
    out = {"losses": {k: abs(got["losses"][k] - want["losses"][k])
                      / max(abs(want["losses"][k]), 1e-30) for k in METRIC_KEYS}}
    for tag in ("g.", "d."):
        dist = [leaf_distance(got, want, k, lr) for k, w in want["grads"].items()
                if k.startswith(tag) and k.endswith(".weight") and w is not None]
        out[tag[0]] = {"grad_rel": max(r for r, _ in dist), "update_off": max(o for _, o in dist)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, action="append", default=None,
                    help="an S to run over cards 0..S-1 (repeatable; default 2 and 4)")
    ap.add_argument("--steps", type=int, default=4, help="steps a cell, the first untimed")
    args = ap.parse_args(argv)
    shards = args.shards or [2, 4]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(f"[sp probe] cards: {smi}", flush=True)
    cfg = flagship_train_config()
    batches = [{"ir": ir, "rgb": gt} for ir, gt in synthetic_batches(args.steps, TRAIN_B)]
    one = train_cell(cfg, batches, args.steps)
    print(f"[sp probe] unsharded on cuda:0, b{TRAIN_B} bf16: {one['ms']:.1f} ms a step "
          f"({TRAIN_B * 1e3 / one['ms']:.2f} frames/s), peak {one['peak_gib']}", flush=True)
    rows = []
    for n in shards:
        if n > torch.cuda.device_count():
            print(f"[sp probe] S = {n}: only {torch.cuda.device_count()} cards, skipped")
            continue
        mesh = [torch.device("cuda", i) for i in range(n)]
        cell = train_cell(cfg.replace(sp_devices=n), batches, args.steps, mesh)
        agree = agreement(cell, one, cfg.lr_G)
        row = {"S": n, "cards": n, "ms": cell["ms"], "frames_per_s": TRAIN_B * 1e3 / cell["ms"],
               "peak_gib": cell["peak_gib"], "agreement": agree,
               "launches": {k: v for k, v in cell["launches"].items() if v}}
        rows.append(row)
        print(f"[sp probe] S = {n} over cards 0..{n - 1}: {cell['ms']:.1f} ms a step "
              f"({row['frames_per_s']:.2f} frames/s; unsharded {one['ms']:.1f}), peak memory "
              + ", ".join(f"{k} {v:.2f} GiB" for k, v in cell["peak_gib"].items())
              + f"; agreement {json.dumps(agree)}", flush=True)
        d_free = [k for k in METRIC_KEYS if k not in ("loss_G", "loss_G_GAN")]
        if (any(agree["losses"][k] > 2.0**-10 for k in d_free) or any(cell["launches"].values())
                or max(agree[t]["grad_rel"] for t in "gd") > 1e-2
                or max(agree[t]["update_off"] for t in "gd") > 0.01):
            raise AssertionError(f"sp probe S = {n}: outside phase 11's bounds or a kernel ran")
    print(json.dumps({"unsharded_ms": one["ms"], "unsharded_peak_gib": one["peak_gib"],
                      "cells": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
