"""Checkpoints (``ircolor_tpu/train/checkpoint.py``).

* ``netG_epoch_{k:03d}.pth`` / ``netG_best.pth``: the generator's
  state_dict under the reference's names, batch-norm running statistics
  included — loadable by the reference, by the JAX package
  (``compat.torch_import.load_generator_pth``, which reads the convs) and
  by ``run_test``.
* ``netG_epoch_{k:03d}.msgpack`` / ``netG_best.msgpack`` beside them: the
  generator's params as the JAX package writes them (flax's msgpack, HWIO
  kernels; ``compat/msgpack.py``, no flax needed), loadable by the JAX
  package's ``load_netg_export`` and by the port (``load_netg_state``).
* The full train state (G and D with their buffers, both Adam states,
  step, epoch, best and last val L1) as ``<state_dir>/{epoch:04d}.pt`` for
  ``--resume``.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from ircolor_tpu_torch.compat import flax_from_state_dict, state_dict_from_flax
from ircolor_tpu_torch.compat.msgpack import msgpack_restore, msgpack_serialize
from ircolor_tpu_torch.train.state import TrainState


def save_netg_pth(g: torch.nn.Module, path_stem: str) -> str:
    """Write ``<path_stem>.pth`` (floating entries as float32, the batch
    norms' integer counts as they are, on the CPU); returns the path."""
    os.makedirs(os.path.dirname(path_stem) or ".", exist_ok=True)
    path = path_stem + ".pth"
    torch.save({k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu()
                for k, v in g.state_dict().items()}, path)
    return path


def save_netg_export(g: torch.nn.Module, path_stem: str) -> list[str]:
    """Write ``<path_stem>.msgpack`` (the JAX package's export of the
    generator's params) and ``<path_stem>.pth``; returns both paths."""
    os.makedirs(os.path.dirname(path_stem) or ".", exist_ok=True)
    params = flax_from_state_dict(g.state_dict(), pad_type=g.padding_type,
                                  use_dropout=g.use_dropout)
    path = path_stem + ".msgpack"
    with open(path, "wb") as f:
        f.write(msgpack_serialize(params))
    return [path, save_netg_pth(g, path_stem)]


def load_netg_export(path: str) -> dict[str, Any]:
    """A ``.msgpack`` generator export's param tree (numpy leaves)."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def load_netg_state(path: str, g: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The state_dict entries of a generator weights file for ``g``: a
    ``.pth`` / ``.pt`` state dict, else a ``.msgpack`` export, as the JAX
    wrapper tells the two apart. An export holds params only: the buffers
    (batch-norm running statistics, blur filters) stay ``g``'s, as JAX's
    ``merge_params`` leaves its ``batch_stats``."""
    if path.endswith((".pth", ".pt")):
        return torch.load(path, map_location="cpu", weights_only=True)
    params = state_dict_from_flax(load_netg_export(path), pad_type=g.padding_type,
                                  use_dropout=g.use_dropout)
    return {**dict(g.named_buffers()), **params}


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
