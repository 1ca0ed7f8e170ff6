"""A cell of the benchmark cut to a size the CPU runs in seconds: the same
code paths as the chip's cells (the program's kernels on their plain
versions), for the CPU tests."""

from __future__ import annotations

import copy

import torch

from portbench.run import load_cell

SEED = 2**31 + 4242
SERVE = "flagship-serve-int8-b32"
TRAIN = "flagship-train-b8"


def spec(cell: str = SERVE, ngf: int = 8, hw: int = 32, n_blocks: int = 1) -> dict:
    """``cell``'s spec at ``hw``x``hw``, ``ngf``, ``n_blocks``, batch 2."""
    s = load_cell(cell)
    cfg = copy.deepcopy(s["config"])
    cfg.update(height=hw, width=hw)
    cfg["model"].update(ngf=ngf, n_blocks=n_blocks)
    cfg["port_config"].update(img_height=hw, img_width=hw, ngf=ngf, n_blocks=n_blocks)
    tr = dict(s["traffic"], batch=2, pool_batches=4)
    if tr["kind"] == "serve":
        # int8 on: below 256^2 the config would resolve it off. At this
        # size the fused tails' and head's gates close, so the int8 route
        # runs the down and up convs beside the blocks' (models/generator.py
        # ``_quant_convs``).
        cfg["port_config"]["quant_int8"] = True
        tr.update(warmup_batches=1, profile_batches=1, checked_batches=2, reference_chunk=2,
                  int8_sites=["down", "blocks", "up"])
    else:
        # float32, so that a sound tiny run sits far inside the limits that
        # bf16 at full size was given; the faults stand out against it.
        cfg["port_config"]["compute_dtype"] = "f32"
        tr.update(profile_steps=1)
    s.update(config=cfg, traffic=tr)
    return s


def run(s: dict, trace: bool = False, seconds: float = 0.3) -> dict:
    from portbench.run import run_cell

    torch.manual_seed(0)
    result, _ = run_cell(s, SEED, seconds, trace, device="cpu", setup_t0=0.0)
    return result
