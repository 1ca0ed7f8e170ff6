"""Weights from the JAX package: its generator, discriminator and VGG param
trees → this package's state_dicts (reference / torchvision names, OIHW).

The caller passes the trees as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, params)``); nothing here imports jax.

  inc_conv / down{1,2}_conv / up{1,2}_conv / outc_conv
      → inc.1 / down{1,2}.0 / up{1,2}_conv.0 / outc.1
  up{1,2}_up (ConvTranspose, ``no_antialias_up``; flax (kh, kw, O, I) with
      ``transpose_kernel=True``) → up{1,2}_up, torch (I, O, kh, kw): the
      same array transposed, no spatial flip (grad-of-conv on both sides)
  resblock_{i}/conv1, conv2 → resblocks.{i}.conv_block.1, .5 (reflect or
      replicate padding; zero padding 0, 3; dropout moves conv2 one on)
  batch norm (``norm="batch"``): {inc,down1,down2,up1,up2}_norm/bn →
      inc.2 / down{1,2}.1 / up{1,2}_conv.1, resblock_{i}/norm{1,2}/bn → the
      module after each conv; params ``scale``, ``bias`` → ``weight``,
      ``bias``, batch_stats ``mean``, ``var`` → ``running_mean``,
      ``running_var`` (``num_batches_tracked`` 0: flax keeps no count)
  discriminator conv0..conv{n}, conv_out → model.0, 2, 5, 8, …, last;
      norm{k}/bn → model.{3k}
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


_NORMS = {
    "inc_norm": "inc.2",
    "down1_norm": "down1.1",
    "down2_norm": "down2.1",
    "up1_norm": "up1_conv.1",
    "up2_norm": "up2_conv.1",
}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _put_bn(sd: dict, prefix: str, params: Mapping[str, Any], stats: Mapping[str, Any] | None,
            key: str) -> None:
    """A flax ``Norm("batch")`` at ``key`` (its ``bn`` scope), if the tree
    has one, as ``BatchNorm`` entries at ``prefix``."""
    if key not in params or "bn" not in params[key]:
        return
    bn = params[key]["bn"]
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = _tensor(bn["scale"]), _tensor(bn["bias"])
    if stats is not None and key in stats:
        sd[f"{prefix}.running_mean"] = _tensor(stats[key]["bn"]["mean"])
        sd[f"{prefix}.running_var"] = _tensor(stats[key]["bn"]["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def state_dict_from_flax(
    params: Mapping[str, Any],
    batch_stats: Mapping[str, Any] | None = None,
    *,
    pad_type: str = "reflect",
    use_dropout: bool = False,
) -> dict[str, torch.Tensor]:
    """JAX generator params (numpy leaves), and its ``batch_stats`` under
    ``norm="batch"``, → port state_dict entries. ``pad_type`` and
    ``use_dropout`` place the block convs (and norms) as the reference's
    ``build_conv_block`` does, as the JAX exporter takes them."""
    sd: dict[str, torch.Tensor] = {}
    for src, dst in _DIRECT.items():
        if src in params:
            _put(sd, dst, params[src])
    for src, dst in _NORMS.items():
        _put_bn(sd, dst, params, batch_stats, src)
    for name in ("up1_up", "up2_up"):
        entry = params.get(name)
        if entry is not None and "kernel" in entry:
            kernel = np.asarray(entry["kernel"], dtype=np.float32)  # (kh, kw, O, I)
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
            if "bias" in entry:
                sd[f"{name}.bias"] = _tensor(entry["bias"])
    padded = pad_type in ("reflect", "replicate")
    conv1 = 1 if padded else 0
    conv2 = conv1 + 3 + int(bool(use_dropout)) + int(padded)
    for key, entry in params.items():
        if key.startswith("resblock_"):
            i = int(key.split("_")[1])
            stats = None if batch_stats is None else batch_stats.get(key)
            for name, idx in (("conv1", conv1), ("conv2", conv2)):
                _put(sd, f"resblocks.{i}.conv_block.{idx}", entry[name])
            for name, idx in (("norm1", conv1 + 1), ("norm2", conv2 + 1)):
                _put_bn(sd, f"resblocks.{i}.conv_block.{idx}", entry, stats, name)
    return sd


def discriminator_state_dict_from_flax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """JAX ``NLayerDiscriminator`` params (and its ``batch_stats`` under
    ``norm="batch"``) → ``model.{idx}`` entries: conv0 at 0, each later
    conv three layers on (conv, norm, LeakyReLU), conv_out last."""
    n = sum(1 for key in params if key.startswith("conv") and key != "conv_out")
    sd: dict[str, torch.Tensor] = {}
    _put(sd, "model.0", params["conv0"])
    for i in range(1, n):
        _put(sd, f"model.{3 * i - 1}", params[f"conv{i}"])
        _put_bn(sd, f"model.{3 * i}", params, batch_stats, f"norm{i}")
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
