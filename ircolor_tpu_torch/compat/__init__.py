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

``flax_from_state_dict`` is the inverse for the generator's params: the
tree that the JAX package's ``.msgpack`` exports hold (``compat/msgpack.py``
reads and writes them).
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
    conv1, conv2 = _block_indices(pad_type, use_dropout)
    for key, entry in params.items():
        if key.startswith("resblock_"):
            i = int(key.split("_")[1])
            stats = None if batch_stats is None else batch_stats.get(key)
            for name, idx in (("conv1", conv1), ("conv2", conv2)):
                _put(sd, f"resblocks.{i}.conv_block.{idx}", entry[name])
            for name, idx in (("norm1", conv1 + 1), ("norm2", conv2 + 1)):
                _put_bn(sd, f"resblocks.{i}.conv_block.{idx}", entry, stats, name)
    return sd


def _block_indices(pad_type: str, use_dropout: bool) -> tuple[int, int]:
    """conv_block indices of a resnet block's two convs (the reference's
    ``build_conv_block``: a pad module before each conv for reflect and
    replicate padding, dropout after the first ReLU)."""
    padded = pad_type in ("reflect", "replicate")
    conv1 = 1 if padded else 0
    return conv1, conv1 + 3 + int(bool(use_dropout)) + int(padded)


def flax_from_state_dict(
    sd: Mapping[str, torch.Tensor], *, pad_type: str = "reflect", use_dropout: bool = False
) -> dict[str, Any]:
    """The inverse of ``state_dict_from_flax`` for the params: port
    generator state_dict entries → the JAX generator's param tree (nested
    dicts of float32 numpy arrays, HWIO kernels). Batch-norm running
    statistics and the blur filters are not params and are left out, as the
    JAX package's ``.msgpack`` export leaves its ``batch_stats`` out."""
    arrays = {k: v.detach().float().cpu().numpy() for k, v in sd.items() if v.is_floating_point()}

    def conv(prefix: str) -> dict | None:
        if f"{prefix}.weight" not in arrays:
            return None
        entry = {"kernel": np.ascontiguousarray(arrays[f"{prefix}.weight"].transpose(2, 3, 1, 0))}
        if f"{prefix}.bias" in arrays:
            entry["bias"] = arrays[f"{prefix}.bias"]
        return entry

    def bn(prefix: str) -> dict | None:
        if f"{prefix}.weight" not in arrays:  # instance norm and "none" hold no params
            return None
        return {"bn": {"scale": arrays[f"{prefix}.weight"], "bias": arrays[f"{prefix}.bias"]}}

    params: dict[str, Any] = {}
    named = [(src, conv(dst)) for src, dst in _DIRECT.items()]
    named += [(src, bn(dst)) for src, dst in _NORMS.items()]
    named += [(name, conv(name)) for name in ("up1_up", "up2_up")]
    conv1, conv2 = _block_indices(pad_type, use_dropout)
    for i in sorted({int(k.split(".")[1]) for k in arrays if k.startswith("resblocks.")}):
        block = {name: entry for name, entry in (
            ("conv1", conv(f"resblocks.{i}.conv_block.{conv1}")),
            ("conv2", conv(f"resblocks.{i}.conv_block.{conv2}")),
            ("norm1", bn(f"resblocks.{i}.conv_block.{conv1 + 1}")),
            ("norm2", bn(f"resblocks.{i}.conv_block.{conv2 + 1}"))) if entry is not None}
        named.append((f"resblock_{i}", block))
    params.update((name, entry) for name, entry in named if entry is not None)
    return params


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
