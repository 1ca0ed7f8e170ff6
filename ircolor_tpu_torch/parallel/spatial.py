"""Spatial (image-axis) sharding of test mode over a 1-D H mesh
(``ircolor_tpu/parallel/spatial.py``).

The JAX package shards the image rows of one batch over a ``('sp',)`` mesh
of chips driven by one controller process: GSPMD partitions the plain
stages, and the fused resnet blocks run under ``shard_map`` with their
neighbours' halo rows and the instance-norm sums reduced across shards. The
port keeps that layout in one process: the mesh is an ordered list of
devices, an activation is a list of H-shards (shard i on device i, rows
``[i·h, (i+1)·h)`` of every image), and the generator's spatial forward
(``models/generator.py``) runs every op per shard with what it needs from
the others:

* ``exchange_halo_rows``: a convolution's or blur's rows from the
  neighbour shards, and at the global edges the image's own padding
  (reflect, zero or replicate) from the edge shard's rows;
* ``all_sum`` / ``all_max``: the instance-norm sums and the int8 per-sample
  amax, reduced in shard order on shard 0's device and sent back.

A device may repeat in the mesh: on one card every shard lives there and a
halo row is a copy on that card; on the CPU, as the tests run it, every
shard is a CPU tensor. Only the 1-D H mesh is ported; 2-D H×W tiling
(``sp_w_devices > 1``), which runs no kernel in the JAX package, is not
(ROADMAP.md).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

PADS = ("reflect", "zero", "replicate")


def make_spatial_mesh(n: int, devices: Sequence | None = None) -> list[torch.device]:
    """An ordered list of ``n`` devices for the H shards: by default the
    first ``n`` visible cards (raises where there are fewer, as the JAX
    mesh does); an explicit ``devices`` list may repeat a device."""
    if n < 1:
        raise ValueError(f"need at least one device for the spatial mesh, got n={n}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(have)]
    devs = [torch.device(d) for d in devices]
    if len(devs) < n:
        raise ValueError(f"need {n} devices for the spatial mesh, have {len(devs)}")
    return devs[:n]


def shard_h(x: torch.Tensor, mesh: Sequence[torch.device]) -> list[torch.Tensor]:
    """NHWC ``x`` → ``len(mesh)`` equal H-shards, shard i contiguous on
    ``mesh[i]``."""
    n, h = len(mesh), x.shape[1]
    if h % n:
        raise ValueError(f"height {h} must divide by the H-shard count {n}")
    return [part.to(dev).contiguous() for part, dev in zip(x.split(h // n, dim=1), mesh)]


def gather_h(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The H-shards joined back into one tensor on shard 0's device."""
    dev = shards[0].device
    return torch.cat([s.to(dev) for s in shards], dim=1)


def exchange_halo_rows(shards: Sequence[torch.Tensor], r: int, pad: str = "reflect"):
    """Each shard's ``r`` rows above and below it as ``[(top, bot), ...]``,
    (B, r, W, C) contiguous tensors on the shard's device: the neighbours'
    edge rows inside the image, and at its top and bottom the global pad
    ``pad`` (``PADS``) made from the edge shard's own rows. With ``r`` 1
    and reflect: the JAX package's ``_exchange_halo_rows``
    (``pallas_resblock.py:1554``)."""
    if pad not in PADS:
        raise ValueError(f"pad must be one of {PADS}, got {pad!r}")
    if min(s.shape[1] for s in shards) <= r:
        raise ValueError(f"every shard needs more than {r} rows for a {r}-row halo")
    out = []
    last = len(shards) - 1
    for i, x in enumerate(shards):
        if i > 0:
            top = shards[i - 1][:, -r:].to(x.device)
        elif pad == "reflect":
            top = x[:, 1 : r + 1].flip(1)
        elif pad == "zero":
            top = x.new_zeros((x.shape[0], r, *x.shape[2:]))
        else:
            top = x[:, :1].expand(-1, r, -1, -1)
        if i < last:
            bot = shards[i + 1][:, :r].to(x.device)
        elif pad == "reflect":
            bot = x[:, -r - 1 : -1].flip(1)
        elif pad == "zero":
            bot = x.new_zeros((x.shape[0], r, *x.shape[2:]))
        else:
            bot = x[:, -1:].expand(-1, r, -1, -1)
        out.append((top.contiguous(), bot.contiguous()))
    return out


def halo_slabs(shards: Sequence[torch.Tensor], r: int, pad: str = "reflect"):
    """Each shard with its ``r`` halo rows above and below: (B, h + 2r, W, C)."""
    return [torch.cat([top, x, bot], dim=1)
            for x, (top, bot) in zip(shards, exchange_halo_rows(shards, r, pad))]


def _reduce(ts: Sequence[torch.Tensor], op) -> list[torch.Tensor]:
    dev = ts[0].device
    acc = ts[0]
    for t in ts[1:]:
        acc = op(acc, t.to(dev))
    return [acc if t.device == dev else acc.to(t.device) for t in ts]


def all_sum(ts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of the shards' tensors, added in shard order on shard 0's
    device, one copy back on each shard's device."""
    return _reduce(ts, torch.add)


def all_max(ts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``all_sum`` with the elementwise maximum."""
    return _reduce(ts, torch.maximum)


def check_spatial_compat(module, mesh: Sequence) -> None:
    """Raise where ``module`` would miscompute under the H mesh
    (``spatial.py:86-134``): the norm-blur tail and the 7×7 head kernels
    reflect at the image's edges and have no spatial form, so they must be
    off; the generator's ``spatial_mesh`` must be this mesh. A W mesh axis
    (a mesh of rows of devices) is not ported."""
    if any(isinstance(d, (list, tuple)) for d in mesh):
        raise NotImplementedError("2-D H×W spatial tiling is not ported yet (ROADMAP.md, Queue 1)")
    if getattr(module, "pallas_norm_blur", False) or getattr(module, "pallas_head", False):
        raise ValueError(
            "spatial sharding with pallas_norm_blur=True or pallas_head=True produces "
            "wrong shard-seam pixels (the kernels reflect at the shard's own edges) — "
            "rebuild the generator with both False (the test runner does this)"
        )
    sp = getattr(module, "spatial_mesh", None)
    if sp is not None and list(sp) != list(mesh):
        raise ValueError("the generator's spatial_mesh is not this mesh")
