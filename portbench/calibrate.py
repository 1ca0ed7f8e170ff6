"""The readings that a cell's limits (``limits/<cell>.json``) are set from:
the program's comparison numbers over many seeds, and over a few the
control's (the reference one precision below the configuration's, put in
the program's place) and, for training, a planted fault's (the reference
trained on half of each batch), at the cell's own sizes, each seed after a
short window, all in one process. One JSON line a reading:

    python3 -m portbench.calibrate --workload flagship-serve-int8-b32 \
        --seeds 11 12 13 --control-seeds 11 12 13 --seconds 3
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import cells
from portbench.trace import Spans
from portbench.run import load_cell


def _readings(spec: dict, cell, control: bool) -> list:
    """(who, numbers) of the program and, with ``control``, of the control
    and, for training, of the planted fault (half of each batch)."""
    out = [("program", cell.check(detail=True))]
    if control:
        name = spec["config"]["control"][cell.kind]
        out.append((name, cell.check(control=name, detail=True)))
        if cell.kind == "train":
            out.append(("half_batch", cell.check(keep=0.5, detail=True)))
    return out


def _emit(workload: str, seed: int, out: list) -> None:
    for who, numbers in out:
        print(json.dumps({"workload": workload, "seed": seed, "who": who, **numbers}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    kind = cells.kind(spec["traffic"]["kind"])
    for seed in args.seeds:
        cell = kind(spec["config"], spec["traffic"], seed, "cuda", Spans())
        cell.setup()
        cell.window(args.seconds)
        cell.release()
        torch.cuda.empty_cache()
        _emit(args.workload, seed, _readings(spec, cell, seed in args.control_seeds))
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
