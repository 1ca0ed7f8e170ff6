"""Rank bodies for the launcher tests (``tests/test_torch_dp_mesh.py``) and
the data-parallel CLI run (``tests/test_torch_dp_run.py``).

``parallel.launch.spawn`` sends its function to the rank processes by
import path, and those processes import its module: this one imports torch
and the port only, so that no rank imports JAX.
"""

import os
import time

import torch
import torch.distributed as dist


def sum_of_ranks(rank, device):
    """The all-reduced sum of the ranks, with what the rank was given."""
    x = torch.tensor([float(rank)], device=device)
    dist.all_reduce(x)
    return {"sum": float(x), "device": str(device), "threads": torch.get_num_threads(),
            "world": dist.get_world_size(), "backend": dist.get_backend()}


def rank1_raises_rank2_exits(rank, device):
    if rank == 1:
        raise ValueError("rank 1 gives up")
    if rank == 2:
        os._exit(3)
    dist.barrier()  # waits for ranks 1 and 2, which never come
    return rank


def hangs(rank, device):
    time.sleep(3600)


def train_cli_then_resume(rank, device, argv):
    """``python -m ircolor_tpu_torch train <argv>`` as this rank of the
    group: 1 epoch, then ``--resume`` to 2. Returns the summaries that
    ``train_kaist`` gave the CLI, without the state."""
    from ircolor_tpu_torch import cli
    from ircolor_tpu_torch.train import loop

    summaries, train_kaist = [], loop.train_kaist

    def kept(*args, **kwargs):
        out = train_kaist(*args, **kwargs)
        summaries.append({k: out[k] for k in loop._AGREED})
        return out

    loop.train_kaist = kept  # the CLI imports it from the module when it runs
    for more in (["--epochs", "1"], ["--epochs", "2", "--resume"]):
        assert cli.main([*argv, *more]) == 0
    return summaries
