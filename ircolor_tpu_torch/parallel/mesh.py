"""The data-parallel layout of the port (``ircolor_tpu/parallel/mesh.py``).

JAX runs data parallelism in one process over a 1-D ``('data',)`` mesh of
devices. The port runs one process per rank, each on one device, joined by
a ``torch.distributed`` process group; its mesh is the list of the ranks'
devices, rank i on entry i.

* ``data_world_size``: JAX's count rule (``make_data_mesh`` and
  ``_pick_devices``) as plain Python over counts.
* ``make_data_mesh`` / ``make_train_mesh``: the ranks' devices for a config:
  every rank on the one device named (``"cpu"``, ``"cuda:i"``), else (no
  device, or ``"cuda"``) rank i on card i, over the count the rule gives.
  Spatial training (``sp_devices`` S > 1) makes JAX's ``('data', 'sp')``
  mesh (``train_data_extent``): a rank holds S H-shards, on the named
  device S times or on cards r·S … r·S + S − 1 (``rank_shard_devices``).
* ``backend_for``: NCCL where every rank has a card of its own, else gloo
  (on the CPU, or ranks sharing a card: NCCL refuses two ranks on one).
* ``initialize_multihost``: the process group from explicit arguments or
  from ``RANK`` / ``WORLD_SIZE`` (``MASTER_ADDR`` / ``MASTER_PORT``), with a
  timeout, so that a lost rank fails instead of hanging.
* ``warmup_mesh_collectives``: one tiny all-reduce right after init.
* ``shard_batch``: a rank's slice of the batch onto its device, or cut on
  H onto its shard devices.
"""

from __future__ import annotations

import datetime
import os
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ircolor_tpu_torch.models.wrapper import resolve_device
from ircolor_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# How long a collective waits for the other ranks before it fails.
PG_TIMEOUT_S = 120.0


def data_world_size(n_devices: int, n_visible: int, batch_size: int | None = None,
                    nproc: int = 1) -> int:
    """The data-parallel device count of ``make_data_mesh``: ``n_devices``
    where it is > 0 (at most ``n_visible``); else every visible device,
    shrunk, where ``batch_size`` is given, to the largest count that divides
    the batch. Over ``nproc`` processes (hosts) the count stays a multiple
    of ``nproc``, so that each keeps an equal share."""
    if n_devices > 0:
        if n_devices > n_visible:
            raise ValueError(
                f"requested {n_devices} data-parallel devices but only "
                f"{n_visible} are visible"
            )
        if nproc > 1 and n_devices != n_visible and n_devices % nproc:
            raise ValueError(
                f"a {n_devices}-device data mesh cannot span {nproc} processes evenly"
            )
        return n_devices
    n = n_visible
    if batch_size is not None:
        while n > 1 and (batch_size % n != 0 or n % nproc != 0):
            n -= 1
        if n % nproc != 0:
            raise ValueError(
                f"global batch {batch_size} cannot be data-sharded over "
                f"{nproc} processes (needs a mesh size that is a multiple "
                f"of the process count and divides the batch)"
            )
    return n


def make_data_mesh(n_devices: int = 0, batch_size: int | None = None,
                   device: str | torch.device | None = None) -> list[torch.device]:
    """The ranks' devices: ``max(n_devices, 1)`` copies of ``device`` where
    it names one (``"cpu"``, ``"cuda:i"``), else the first
    ``data_world_size(n_devices, <visible cards>, batch_size)`` cards.
    Raises without a card unless the CPU is named."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return [dev] * max(n_devices, 1)
    n = data_world_size(n_devices, torch.cuda.device_count(), batch_size)
    return [torch.device("cuda", i) for i in range(n)]


def train_data_extent(dp_devices: int, sp_devices: int, n_visible: int,
                      batch_size: int | None = None) -> int:
    """The 'data' extent of JAX's ``('data', 'sp')`` train mesh
    (``make_train_mesh``): ``dp_devices`` where it is > 0, else the visible
    devices over ``sp_devices``, shrunk to the largest count that divides
    the batch; at least 1. Raises where ``extent × sp_devices`` devices
    are not visible."""
    if dp_devices > 0:
        dp = dp_devices
    else:
        dp = n_visible // sp_devices
        if batch_size is not None:
            while dp > 1 and batch_size % dp != 0:
                dp -= 1
    dp = max(dp, 1)
    if dp * sp_devices > n_visible:
        raise ValueError(f"need {dp}×{sp_devices} devices for the (data, sp) train mesh, "
                         f"have {n_visible}")
    return dp


def rank_shard_devices(sp_devices: int, device: str | torch.device | None = None,
                       rank: int = 0) -> list[torch.device]:
    """The ``sp_devices`` devices of data rank ``rank``'s H-shards: the one
    device named (``"cpu"``, ``"cuda:i"``) ``sp_devices`` times, else cards
    ``rank·S`` … ``rank·S + S − 1`` (raises where they are not visible)."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return [dev] * sp_devices
    first = rank * sp_devices
    if first + sp_devices > torch.cuda.device_count():
        raise ValueError(f"need cards {first}..{first + sp_devices - 1} for rank {rank}'s "
                         f"H-shards, have {torch.cuda.device_count()}")
    return [torch.device("cuda", first + i) for i in range(sp_devices)]


def make_train_mesh(dp_devices: int = 0, sp_devices: int = 1, batch_size: int | None = None,
                    device: str | torch.device | None = None) -> list:
    """The training ranks' devices (``make_data_mesh``); with ``sp_devices``
    > 1 the ``('data', 'sp')`` mesh: a list, a data rank each, of that
    rank's ``rank_shard_devices``. The data extent is JAX's
    (``train_data_extent``) over the visible cards, or ``max(dp_devices,
    1)`` ranks where ``device`` names one device, which every shard of
    every rank then shares."""
    if sp_devices <= 1:
        return make_data_mesh(dp_devices, batch_size, device)
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        dp = max(dp_devices, 1)
    else:
        dp = train_data_extent(dp_devices, sp_devices, torch.cuda.device_count(), batch_size)
    return [rank_shard_devices(sp_devices, device, r) for r in range(dp)]


def backend_for(devices: Sequence[torch.device]) -> str:
    """``"nccl"`` where every rank has a card of its own, else ``"gloo"``."""
    cards = [d for d in devices if d.type == "cuda"]
    return "nccl" if len(cards) == len(devices) and len(set(cards)) == len(cards) else "gloo"


def initialize_multihost(*, init_method: str | None = None, world_size: int | None = None,
                         rank: int | None = None, devices: Sequence[torch.device] | None = None,
                         device: str | torch.device | None = None,
                         timeout_s: float = PG_TIMEOUT_S) -> torch.device | None:
    """Start the process group and return this rank's device. From the
    explicit ``init_method``, ``world_size``, ``rank`` and ``devices`` (the
    ranks' devices), or else from the environment a launcher sets (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): every rank on
    ``device`` where it names one, else each on the card of its
    ``LOCAL_RANK``. None, and nothing done, where neither is given. A group
    that is already up is kept. A failed init raises, as does a collective
    that waits ``timeout_s``."""
    if init_method is None:
        if "RANK" not in os.environ:
            return None
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        named = None if device is None else torch.device(device)
        if named is not None and (named.type == "cpu" or named.index is not None):
            devices = [named] * world_size
            dev = named
        else:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        init_method = "env://"
    elif world_size is None or rank is None or devices is None or len(devices) != world_size:
        raise ValueError("initialize_multihost: init_method needs world_size, rank and "
                         "the ranks' devices")
    else:
        dev = devices[rank]
    backend = "nccl" if devices is None else backend_for(devices)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    log.info("[DP] rank %d of %d on %s: backend %s (%s)", rank, world_size, dev, backend,
             "a card a rank" if backend == "nccl" else "CPU or shared cards")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def world() -> tuple[int, int]:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def warmup_mesh_collectives(device: torch.device) -> None:
    """One tiny all-reduce while the ranks are still in lockstep (before the
    state's init and the first step, whose time may differ by rank); raises
    unless it sums to the world size."""
    _, n = world()
    if n == 1:
        return
    x = torch.ones(1, device=device)
    dist.all_reduce(x)
    if float(x) != n:
        raise RuntimeError(f"warm-up all-reduce gave {float(x)}, expected {n}")


def _to(v: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array on ``device``: to a card from pinned memory without
    blocking the host."""
    if device.type != "cuda":
        return torch.from_numpy(np.ascontiguousarray(v))
    return torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(device, non_blocking=True)


def shard_batch(batch: Mapping[str, np.ndarray], device) -> dict:
    """This rank's batch (the loader yields its slice) on its device. With
    a list of devices (a rank's H-shard devices, spatial training) NHWC
    arrays are cut on H as well, shard i (the rows after shard i − 1's, H
    divided equally) on device i, and other arrays (the val mask) stay
    whole on the first: JAX's ``P('data', 'sp')`` and ``P('data')``."""
    if not isinstance(device, (list, tuple)):
        return {k: _to(v, device) for k, v in batch.items()}
    mesh = [torch.device(d) for d in device]
    out = {}
    for k, v in batch.items():
        if v.ndim != 4:
            out[k] = _to(v, mesh[0])
            continue
        if v.shape[1] % len(mesh):
            raise ValueError(f"height {v.shape[1]} must divide by the H-shard count {len(mesh)}")
        rows = v.shape[1] // len(mesh)
        out[k] = [_to(v[:, i * rows:(i + 1) * rows], d) for i, d in enumerate(mesh)]
    return out
