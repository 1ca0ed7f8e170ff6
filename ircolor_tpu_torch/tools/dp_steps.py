"""Data-parallel train steps on fixed batches: the rank body that holds the
port's data-parallel step (``train.step_shardmap``) against the
one-process step, called through ``parallel.launch.spawn`` by the CPU
tests (``tests/test_torch_dp_step.py``), the card tests and
``chip_smoke.py`` (phase 10b):

    from ircolor_tpu_torch.parallel.launch import spawn
    from ircolor_tpu_torch.tools.dp_steps import run_rank
    out = spawn(run_rank, ["cuda:0", "cuda:0"], (cfg, batches))

Each rank builds the train state from ``cfg.seed`` (or loads ``weights``),
takes its contiguous slice of every global batch and runs one step a
batch, checking after each that the ranks' parameters and buffers are
equal bit for bit. Under ``sp_devices`` S > 1 (data × spatial) a rank's
slice is cut into S H-shards, all on its device. TF32 is off, as for the
plain float32 references.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.kernels import LAUNCHES, reset_launches
from ircolor_tpu_torch.losses.vgg import VGG16Features, load_vgg16
from ircolor_tpu_torch.models.wrapper import _DTYPES
from ircolor_tpu_torch.parallel.mesh import shard_batch, world
from ircolor_tpu_torch.train import step_shardmap
from ircolor_tpu_torch.train.state import TrainState, create_train_state
from ircolor_tpu_torch.train.step import make_train_step
from ircolor_tpu_torch.utils.timing import synchronize


def setup(cfg: Config, device: torch.device, weights: dict | None = None,
          vgg_weights: dict | None = None) -> tuple[TrainState, VGG16Features | None]:
    """The train state (``weights``: G's and D's state_dicts as numpy, where
    given) and the VGG tower (``vgg_weights``, else the seeded random tower;
    None where ``lambda_perc`` is 0), as the one-process reference builds
    them too."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state = create_train_state(cfg, steps_per_epoch=10, device=device)
    if weights is not None:
        for net, sd in ((state.g, weights["g"]), (state.d, weights["d"])):
            net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    vgg = None
    if cfg.lambda_perc != 0.0:
        vgg = load_vgg16(None, cfg.seed, _DTYPES[cfg.compute_dtype])
        if vgg_weights is not None:
            vgg.load_state_dict({k: torch.from_numpy(v) for k, v in vgg_weights.items()})
        vgg = vgg.to(device)
    return state, vgg


def snapshot(state: TrainState) -> dict[str, Any]:
    """A copy of G's and D's parameters and gradients as numpy, by
    ``g.``/``d.`` name."""
    params, grads = {}, {}
    for tag, net in (("g", state.g), ("d", state.d)):
        for name, p in net.named_parameters():
            params[f"{tag}.{name}"] = p.detach().float().cpu().numpy().copy()
            grads[f"{tag}.{name}"] = (None if p.grad is None
                                      else p.grad.float().cpu().numpy().copy())
    return {"params": params, "grads": grads}


ROUTING = ("pallas_block", "pallas_norm_blur", "pallas_head", "pallas_encdec_bwd")


def routing(state: TrainState) -> dict[str, bool]:
    """The kernel routing the train state's generator was built with."""
    g = state.g
    return {"pallas_block": bool(g.resblocks[0].pallas_block),
            **{f: bool(getattr(g, f)) for f in ROUTING[1:]}}


def run_rank(rank: int, device: torch.device, cfg: Config, batches: list[dict[str, np.ndarray]],
             weights: dict | None = None, vgg_weights: dict | None = None) -> dict[str, Any]:
    """One step a global batch on this rank's slice. Returns the averaged
    losses of each step, whether the replicas were equal after each, the
    host ms of each step (ending in a synchronize) and of its collectives,
    the kernel launches over all steps, the peak device memory (GiB, on a
    card), the state's kernel ``routing`` and, on rank 0, ``snapshot``
    after the first step."""
    _, n = world()
    state, vgg = setup(cfg, device, weights, vgg_weights)
    comm: list = []
    step = step_shardmap.make_train_step_shardmap(cfg, vgg, comm_s=comm)
    out: dict[str, Any] = {"losses": [], "equal": [], "step_ms": [], "comm_ms": [],
                           "routing": routing(state)}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    place = state.g.spatial_mesh or device
    for i, batch in enumerate(batches):
        per = batch["ir"].shape[0] // n
        mine = shard_batch({k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}, place)
        comm.clear()
        synchronize(device)
        t0 = time.perf_counter()
        state, metrics = step(state, mine)
        synchronize(device)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["comm_ms"].append(sum(comm) * 1e3)
        out["losses"].append({k: float(v) for k, v in metrics.items()})
        if i == 0 and rank == 0:
            out["first"] = snapshot(state)
        out["equal"].append(step_shardmap.replicas_equal(state.g, state.d))
    out["launches"] = dict(LAUNCHES)
    out["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                       if device.type == "cuda" else None)
    return out


def run_rank_each(rank: int, device: torch.device, runs: list[tuple]) -> list[dict[str, Any]]:
    """``run_rank(rank, device, *args)`` for each ``args`` of ``runs`` in
    turn, each from a fresh state: several configurations in one spawn."""
    outs = []
    for args in runs:
        outs.append(run_rank(rank, device, *args))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return outs


def one_process_steps(cfg: Config, device: torch.device, batches: list[dict[str, np.ndarray]],
                      weights: dict | None = None, vgg_weights: dict | None = None
                      ) -> dict[str, Any]:
    """The same steps in this process on the whole global batches (the
    reference of ``run_rank``): losses, step ms, peak GiB, launches, the
    parameters before the first step and the first step's ``snapshot``."""
    state, vgg = setup(cfg, device, weights, vgg_weights)
    step = make_train_step(cfg, vgg)
    out: dict[str, Any] = {"losses": [], "step_ms": [], "before": snapshot(state)["params"]}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    place = state.g.spatial_mesh or device
    for i, batch in enumerate(batches):
        whole = shard_batch(batch, place)
        synchronize(device)
        t0 = time.perf_counter()
        state, metrics = step(state, whole)
        synchronize(device)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            out["first"] = snapshot(state)
    out["launches"] = dict(LAUNCHES)
    out["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                       if device.type == "cuda" else None)
    return out


def collective_probe(rank: int, device: torch.device) -> dict[str, Any]:
    """One all-reduce of a vector on ``device``: the group's backend, its
    size and the summed value (``sum(rank + 1)``)."""
    x = torch.full((1024,), float(rank + 1), device=device)
    dist.all_reduce(x)
    synchronize(device)
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "sum": float(x[0]), "same": bool((x == x[0]).all())}
