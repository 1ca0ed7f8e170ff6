"""Weights from the JAX package: its generator, discriminator and VGG param
trees → this package's state_dicts (reference / torchvision names, OIHW).

The caller passes the tree as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, params)``); nothing here imports jax.

  inc_conv / down{1,2}_conv / up{1,2}_conv / outc_conv
      → inc.1 / down{1,2}.0 / up{1,2}_conv.0 / outc.1
  resblock_{i}/conv1, conv2 → resblocks.{i}.conv_block.1, .5
  discriminator conv0..conv{n}, conv_out → model.0, 2, 5, 8, …, last
  VGG conv1_1 … conv3_3 → features.0, 2, 5, 7, 10, 12, 14
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_DIRECT = {
    "inc_conv": "inc.1",
    "down1_conv": "down1.0",
    "down2_conv": "down2.0",
    "up1_conv": "up1_conv.0",
    "up2_conv": "up2_conv.0",
    "outc_conv": "outc.1",
}


def _put(sd: dict, prefix: str, entry: Mapping[str, Any]) -> None:
    kernel = np.asarray(entry["kernel"], dtype=np.float32)  # HWIO
    sd[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    if "bias" in entry:
        sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(entry["bias"], dtype=np.float32).copy())


def state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX generator params (numpy leaves) → port state_dict entries."""
    sd: dict[str, torch.Tensor] = {}
    for src, dst in _DIRECT.items():
        if src in params:
            _put(sd, dst, params[src])
    for key, entry in params.items():
        if key.startswith("resblock_"):
            i = int(key.split("_")[1])
            _put(sd, f"resblocks.{i}.conv_block.1", entry["conv1"])
            _put(sd, f"resblocks.{i}.conv_block.5", entry["conv2"])
    return sd


def discriminator_state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``NLayerDiscriminator`` params → ``model.{idx}`` entries: conv0
    at 0, each later conv three layers on (conv, IN, LeakyReLU), conv_out
    last."""
    n = sum(1 for key in params if key.startswith("conv") and key != "conv_out")
    sd: dict[str, torch.Tensor] = {}
    _put(sd, "model.0", params["conv0"])
    for i in range(1, n):
        _put(sd, f"model.{3 * i - 1}", params[f"conv{i}"])
    _put(sd, f"model.{3 * n - 1}", params["conv_out"])
    return sd


def vgg_state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``VGG16Features`` params → torchvision ``features.{idx}`` entries."""
    from ircolor_tpu_torch.losses.vgg import VGG16_PLAN, VGG16Features

    convs = [i for i, m in enumerate(VGG16Features().features) if isinstance(m, torch.nn.Conv2d)]
    names = [name for name, ch in VGG16_PLAN if ch is not None]
    sd: dict[str, torch.Tensor] = {}
    for idx, name in zip(convs, names):
        _put(sd, f"features.{idx}", params[name])
    return sd
