"""The data-parallel train and val steps (``ircolor_tpu/train/step_shardmap.py``).

Each rank runs the port's step (``train.step.make_train_step``) on its
slice of the global batch, with explicit collectives where the JAX
shard_map step takes its ``pmean``: D's gradients are averaged over the
ranks before D's Adam step, G's before G's, and the 7 loss scalars in one
packed all-reduce. Every rank then applies the same update to the same
parameters, so the replicas stay equal, bit for bit. ``dp_mode="gspmd"``
runs the same step and the same kernels (``train.state.train_config``),
whose averages are JAX's GSPMD step's; under ``norm="batch"`` its batch
statistics are the global batch's (``models.common.BatchNorm``'s ``sync``).
The shard_map form refuses batch norm, as in JAX.

The gradients go through one flat buffer a model and dtype, not a call a
parameter; a parameter without a gradient (the block conv biases on the
fused route) stays without one on every rank. Only ``broadcast`` and
``all_reduce`` are used, which gloo carries for CUDA tensors too (two
ranks on one card). G and D are not wrapped in ``DistributedDataParallel``:
D runs two or three forwards a step and takes no gradient in the G phase,
which its hooks do not fit.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch
import torch.distributed as dist

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.losses.vgg import VGG16Features
from ircolor_tpu_torch.train.step import METRIC_KEYS, make_train_step, make_val_step
from ircolor_tpu_torch.utils.timing import synchronize


def _by_dtype(tensors) -> list[list[torch.Tensor]]:
    groups: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


def _flat(group: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in group])


def _unflat(flat: torch.Tensor, group: list[torch.Tensor]) -> None:
    offset = 0
    for t in group:
        t.copy_(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()


def _check_same_layout(group: list[torch.Tensor], what: str) -> None:
    """Raise unless every rank reduces the same number of tensors and
    elements (a rank whose route left other gradients out would otherwise
    sum mismatched buffers)."""
    n, numel = len(group), sum(t.numel() for t in group)
    t = torch.tensor([n, numel, -n, -numel], dtype=torch.float64, device=group[0].device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if int(t[0]) != n or int(t[1]) != numel or int(t[2]) != -n or int(t[3]) != -numel:
        raise RuntimeError(f"{what}: ranks differ in the gradients they reduce "
                           f"({n} tensors, {numel} elements here)")


def all_reduce_mean_grads(module: torch.nn.Module, checked: set) -> None:
    """Average ``module``'s gradients over the ranks in place, one flat
    all-reduce a dtype. The first call for a module checks that the ranks'
    layouts agree (``checked`` holds the modules done)."""
    world = dist.get_world_size()
    for group in _by_dtype(p.grad for p in module.parameters() if p.grad is not None):
        if id(module) not in checked:
            _check_same_layout(group, type(module).__name__)
        flat = _flat(group)
        dist.all_reduce(flat)
        _unflat(flat.div_(world), group)
    checked.add(id(module))


def broadcast_replicas(*modules: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers onto every rank, one broadcast a
    module and dtype."""
    for m in modules:
        for group in _by_dtype(t.data for t in (*m.parameters(), *m.buffers())):
            flat = _flat(group)
            dist.broadcast(flat, 0)
            _unflat(flat, group)


def replicas_equal(*modules: torch.nn.Module) -> bool:
    """Whether every rank holds rank 0's parameters and buffers bit for bit
    (the same answer on every rank)."""
    same = True
    for m in modules:
        for group in _by_dtype(t.detach() for t in (*m.parameters(), *m.buffers())):
            mine = _flat(group)
            ref = mine.clone()
            dist.broadcast(ref, 0)
            same &= bool(torch.equal(mine, ref))
    flag = torch.tensor([1.0 if same else 0.0], device=next(modules[0].parameters()).device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item() == 1.0)


def all_reduce_mean_metrics(metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The step's 7 loss scalars averaged over the ranks, in one all-reduce."""
    packed = torch.stack([metrics[k].float() for k in METRIC_KEYS])
    dist.all_reduce(packed)
    packed /= dist.get_world_size()
    return dict(zip(METRIC_KEYS, packed.unbind()))


@contextmanager
def _timed(comm_s: list | None, device: torch.device):
    """Append the host seconds of the block, synchronized before and after,
    to ``comm_s`` (nothing without it)."""
    if comm_s is None:
        yield
        return
    synchronize(device)
    t0 = time.perf_counter()
    yield
    synchronize(device)
    comm_s.append(time.perf_counter() - t0)


def make_train_step_shardmap(cfg: Config, vgg: VGG16Features | None,
                             comm_s: list | None = None):
    """``step(state, batch) → (state, metrics)`` on this rank's slice of the
    global batch, with the gradients and losses averaged over the ranks of
    the process group. Where ``comm_s`` is given, each of the step's
    collectives is timed on the host, the device synchronized before and
    after it, and its seconds appended there (``tools.dp_steps`` reads the
    all-reduce's share of a step so)."""
    if cfg.norm == "batch" and cfg.dp_mode == "shard_map":
        raise NotImplementedError("shard_map train step supports instance/none norms only")
    checked: set = set()

    def reduce_grads(module: torch.nn.Module) -> None:
        with _timed(comm_s, next(module.parameters()).device):
            all_reduce_mean_grads(module, checked)

    inner = make_train_step(cfg, vgg, reduce_grads=reduce_grads)

    def step(state, batch):
        state, metrics = inner(state, batch)
        with _timed(comm_s, next(iter(metrics.values())).device):
            metrics = all_reduce_mean_metrics(metrics)
        return state, metrics

    return step


def make_val_sum_step_shardmap(g: torch.nn.Module):
    """``(batch, mask) → (Σ l1·mask, Σ mask)`` summed over the ranks: every
    rank gets the same two numbers (``train.step.make_val_sum_step``'s
    contract), also a rank whose slice is all padding."""
    val = make_val_step(g)

    def val_sum(batch: dict[str, torch.Tensor], mask: torch.Tensor):
        per = val(batch)
        sums = torch.stack([(per * mask).sum(), mask.sum()])
        dist.all_reduce(sums)
        return sums[0], sums[1]

    return val_sum
