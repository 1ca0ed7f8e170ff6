"""Operations a frame of the model step, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference on
meta tensors at a configuration's shapes: the generator's forward for
serving, the whole training step (G forward and backward, D on
[real || fake] and its backward, G's loss through D and the VGG tower and
its backward) for training. ``configs/<name>.json`` keeps the figures; a
test holds them to this count.

    python3 -m portbench.flops portbench/configs/flagship_512x640.json
"""

from __future__ import annotations

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import train as ref_train
from portbench.reference.model import networks

_BATCH = 2


def per_frame(config: dict) -> dict[str, int]:
    """{"serve": ops a frame, "train": ops a frame} of ``config`` (a
    ``configs/<name>.json`` object)."""
    model, h, w = config["model"], config["height"], config["width"]
    n = networks(model)
    ir = torch.empty(_BATCH, model["input_nc"], h, w, device="meta")
    rgb = torch.empty(_BATCH, model["output_nc"], h, w, device="meta")
    with FlopCounterMode(display=False) as serve, torch.no_grad():
        n["g"](ir)
    with FlopCounterMode(display=False) as train:
        ref_train.step(n["g"], n["d"], n["vgg"], ir, rgb, config["train_hp"])
    return {"serve": serve.get_total_flops() // _BATCH, "train": train.get_total_flops() // _BATCH}


if __name__ == "__main__":
    for path in sys.argv[1:]:
        with open(path) as f:
            print(path, per_frame(json.load(f)))
