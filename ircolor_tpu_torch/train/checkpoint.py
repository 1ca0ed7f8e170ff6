"""Checkpoints (``ircolor_tpu/train/checkpoint.py``).

* ``netG_epoch_{k:03d}.pth`` / ``netG_best.pth``: the generator's
  state_dict under the reference's names, batch-norm running statistics
  included — loadable by the reference, by the JAX package
  (``compat.torch_import.load_generator_pth``, which reads the convs) and
  by ``run_test``.
* The full train state (G and D with their buffers, both Adam states,
  step, epoch, best and last val L1) as ``<state_dir>/{epoch:04d}.pt`` for
  ``--resume``.

The JAX package's ``.msgpack`` exports are not ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import os
from typing import Any

import torch

from ircolor_tpu_torch.train.state import TrainState


def save_netg_pth(g: torch.nn.Module, path_stem: str) -> str:
    """Write ``<path_stem>.pth`` (floating entries as float32, the batch
    norms' integer counts as they are, on the CPU); returns the path."""
    os.makedirs(os.path.dirname(path_stem) or ".", exist_ok=True)
    path = path_stem + ".pth"
    torch.save({k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu()
                for k, v in g.state_dict().items()}, path)
    return path


def save_full_state(state_dir: str, epoch: int, state: TrainState, extra: dict[str, Any]) -> str:
    os.makedirs(state_dir, exist_ok=True)
    path = os.path.join(state_dir, f"{epoch:04d}.pt")
    payload = {
        "g": state.g.state_dict(),
        "d": state.d.state_dict(),
        "opt_g": state.opt_g.state_dict(),
        "opt_d": state.opt_d.state_dict(),
        "step": state.step,
        "extra": extra,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(state_dir: str) -> int | None:
    """Highest epoch with a saved full state, or None."""
    if not os.path.isdir(state_dir):
        return None
    epochs = [int(f[:-3]) for f in os.listdir(state_dir) if f.endswith(".pt") and f[:-3].isdigit()]
    return max(epochs) if epochs else None


def restore_full_state(state_dir: str, epoch: int, state: TrainState) -> dict[str, Any]:
    """Load ``<state_dir>/{epoch:04d}.pt`` into ``state`` in place; returns
    the saved ``extra`` (epoch, best_val_l1, val_l1)."""
    dev = next(state.g.parameters()).device
    payload = torch.load(os.path.join(state_dir, f"{epoch:04d}.pt"), map_location=dev,
                         weights_only=True)
    state.g.load_state_dict(payload["g"])
    state.d.load_state_dict(payload["d"])
    state.opt_g.load_state_dict(payload["opt_g"])
    state.opt_d.load_state_dict(payload["opt_d"])
    state.step = int(payload["step"])
    return payload["extra"]
