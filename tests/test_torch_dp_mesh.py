"""The port's data-parallel layout against the JAX package's, on the CPU:
the device-count rule against ``make_data_mesh`` / ``_pick_devices`` on the
8 fake CPU devices, the training routing against JAX's
``create_train_state`` for gspmd and shard_map over one and several
devices, the backend rule, and the launcher: ranks that sum, a rank that
raises or dies, a run past its time limit and a rendezvous that never
completes all end in an error, with every rank stopped."""

import re
import time

import pytest
import torch

import jax

from ircolor_tpu.config import Config as JConfig
from ircolor_tpu.parallel import mesh as jmesh
from ircolor_tpu.train.state import create_train_state as jcreate

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.parallel import launch
from ircolor_tpu_torch.parallel.mesh import (
    backend_for,
    data_world_size,
    initialize_multihost,
    make_data_mesh,
    make_train_mesh,
)
from ircolor_tpu_torch.train.state import train_config
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

import torch_dp_ranks

_CPU = torch.device("cpu")


def test_world_size_rule_matches_jax(eight_cpu_devices):
    for dp in (0, 1, 2, 3, 4, 8):
        for batch in (None, 1, 2, 3, 4, 5, 6, 8, 12, 16):
            want = jmesh.make_data_mesh(dp, batch_size=batch).devices.size
            assert data_world_size(dp, 8, batch) == want, (dp, batch)
    with pytest.raises(ValueError, match="requested 9 data-parallel devices but only 8"):
        jmesh.make_data_mesh(9)
    with pytest.raises(ValueError, match="requested 9 data-parallel devices but only 8"):
        data_world_size(9, 8)


def test_world_size_rule_over_processes_matches_jax(monkeypatch):
    """Two processes of 4 devices (JAX's ``_pick_devices`` test topology):
    the count stays a multiple of the process count, with JAX's errors."""

    class FakeDev:
        def __init__(self, i, proc):
            self.id, self.process_index = i, proc

    devs = [FakeDev(i, i // 4) for i in range(8)]
    monkeypatch.setattr(jmesh.jax, "process_count", lambda: 2)
    monkeypatch.setattr(jmesh, "Mesh", lambda devices, axes: devices)  # fake devices: no Mesh
    for n in range(1, 9):
        try:
            want = len(jmesh._pick_devices(devs, n))
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc)):
                data_world_size(n, 8, nproc=2)
        else:
            assert data_world_size(n, 8, nproc=2) == want
    for batch in range(1, 17):
        try:
            want = len(jmesh.make_data_mesh(0, devs, batch_size=batch))
        except ValueError as exc:
            with pytest.raises(ValueError, match="cannot be data-sharded over 2 processes"):
                data_world_size(0, 8, batch, nproc=2)
            assert "cannot be data-sharded" in str(exc)
        else:
            assert data_world_size(0, 8, batch, nproc=2) == want


def test_mesh_devices_and_backend_rule():
    assert make_data_mesh(3, device="cpu") == [_CPU] * 3
    assert make_data_mesh(0, batch_size=6, device="cpu") == [_CPU]
    # Spatial training's ('data', 'sp') mesh: a list of shard devices a rank.
    assert make_train_mesh(2, 2, device="cpu") == [[_CPU] * 2] * 2
    if not torch.cuda.is_available():
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_data_mesh(2, device=dev)
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert backend_for([_CPU, _CPU]) == "gloo"
    assert backend_for([cuda[0], cuda[0]]) == "gloo"  # NCCL refuses two ranks on a card
    assert backend_for([cuda[0], _CPU]) == "gloo"
    assert backend_for(cuda) == backend_for(cuda[:1]) == "nccl"


def test_initialize_multihost_needs_arguments_or_environment(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() is None
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="needs world_size"):
        initialize_multihost(init_method="file:///nowhere", world_size=2, rank=0)


def _jax_routing(kw: dict) -> dict:
    """The kernel flags of JAX's training generator for ``kw``."""
    built = {}

    def traced():  # eval_shape traces the init only: no compile, no run
        state, *built["rest"] = jcreate(JConfig(**kw), steps_per_epoch=1)
        return state

    jax.eval_shape(traced)
    return {f: getattr(built["rest"][0], f) for f in _FLAGS}


_FLAGS = ("pallas_block", "pallas_norm_blur", "pallas_head", "pallas_encdec_bwd")


@pytest.mark.parametrize("dp_mode", ["gspmd", "shard_map"])
@pytest.mark.parametrize("dp_devices", [1, 0])
def test_train_routing_matches_jax(eight_cpu_devices, dp_mode, dp_devices):
    """JAX's routing, on one device and on 8 (``dp_devices=0``, batch 8),
    but for JAX's multi-device gspmd gate: there JAX turns every fused
    kernel of the step off (GSPMD cannot partition a ``pallas_call``) and
    the port keeps JAX's shard_map routing, its ranks running whole
    kernels (``test_torch_dp_step.py`` builds them in a group of two)."""
    kw = dict(img_size=32, batch_size=8, n_blocks=1, ngf=8, dp_mode=dp_mode,
              dp_devices=dp_devices, pallas_norm_blur_train=True, pallas_head_train=True,
              pallas_encdec_bwd=True)
    want = _jax_routing(kw)
    world = data_world_size(dp_devices, len(jax.devices()), 8)
    if world > 1 and dp_mode == "gspmd":
        assert not any(want.values())  # JAX's gate
        want = _jax_routing({**kw, "dp_mode": "shard_map"})
    cfg = train_config(Config(**kw))
    assert {f: getattr(cfg, f) for f in _FLAGS} == want
    assert all(want.values())


@pytest.fixture(scope="module")
def failed_ranks():
    """One spawn of three ranks: rank 1 raises, rank 2 exits with code 3,
    rank 0 waits for them at a barrier. The parent's error."""
    with pytest.raises(RuntimeError) as info:
        launch.spawn(torch_dp_ranks.rank1_raises_rank2_exits, [_CPU] * 3, timeout_s=90)
    return str(info.value)


def test_spawned_ranks_sum_on_their_devices():
    out = launch.spawn(torch_dp_ranks.sum_of_ranks, [_CPU, _CPU, _CPU], timeout_s=90)
    assert [o["sum"] for o in out] == [3.0] * 3
    assert {(o["device"], o["world"], o["backend"]) for o in out} == {("cpu", 3, "gloo")}
    assert {o["threads"] for o in out} == {1}  # the parent's one thread, shared


@pytest.mark.parametrize("err", ["rank 1 failed.*gives up", "rank 2 exited with code 3"])
def test_a_failed_rank_fails_the_parent(failed_ranks, err):
    assert re.search(f"(?s){err}", failed_ranks), failed_ranks


def test_ranks_past_the_time_limit_are_killed():
    with pytest.raises(TimeoutError, match="still running after 1"):
        launch.spawn(torch_dp_ranks.hangs, [_CPU, _CPU], timeout_s=1)
    assert not [p for p in __import__("multiprocessing").active_children() if p.is_alive()]


def test_lost_rendezvous_times_out(tmp_path):
    """Rank 0 of 2, its peer never coming: the init fails at its timeout
    and leaves no process group."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?i)timeout|timed out"):
        initialize_multihost(init_method=f"file://{tmp_path}/store", world_size=2, rank=0,
                             devices=[_CPU] * 2, timeout_s=1)
    assert time.monotonic() - t0 < 30
    assert not torch.distributed.is_initialized()
