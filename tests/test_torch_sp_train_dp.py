"""Data × spatial training on the CPU: two gloo ranks (``parallel.launch.
spawn``, ``tools.dp_steps.run_rank``), each holding its two images of the
global batch of 4 as 2 H-shards, against one process's unsharded 4-image
step from the same seeded weights, in float32 (ngf 8, one block, 32×32,
every loss term on, the seeded random VGG tower). The bounds are
``tests/test_torch_train_step.py``'s: the losses within 1e-5 relative,
every live leaf's gradient within 1e-4 relative L2, the first Adam update
within lr/4 on all but 1% of each leaf's entries; the ranks' parameters
equal bit for bit after every step.

As in ``tests/test_torch_dp_step.py`` the G phase is held on the ranks'
own D': the reference G phase is one process's step with ``update_d=False``
from the initial G and the ranks' D after its Adam step (D's
rounding-level gradient entries may step either way, and the G phase reads
D' at first order)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.losses.vgg import load_vgg16
from ircolor_tpu_torch.parallel.launch import spawn
from ircolor_tpu_torch.parallel.mesh import shard_batch
from ircolor_tpu_torch.tools.dp_steps import one_process_steps, run_rank, snapshot
from ircolor_tpu_torch.train.state import create_train_state
from ircolor_tpu_torch.train.step import METRIC_KEYS, make_train_step
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_train_step import _live_leaves

_LR = 2e-4
_KW = dict(img_size=32, batch_size=4, n_blocks=1, ngf=8, dp_devices=2, sp_devices=2,
           batch_transport="float")
_CPU = torch.device("cpu")
_G_PHASE = tuple(k for k in METRIC_KEYS if k != "loss_D")


def _batches(n=2):
    rng = np.random.RandomState(1)  # tests/test_torch_dp_step.py's batches
    return [{"ir": rng.rand(4, 32, 32, 1).astype(np.float32) * 2 - 1,
             "rgb": rng.rand(4, 32, 32, 3).astype(np.float32) * 2 - 1} for _ in range(n)]


def _g_phase(cfg, batch, d_params):
    """One process's G phase on the global batch against ``d_params`` (D'):
    the step with ``update_d=False`` from the seeded initial G."""
    state = create_train_state(cfg, steps_per_epoch=10, device="cpu")
    with torch.no_grad():
        for name, p in state.d.named_parameters():
            p.copy_(torch.from_numpy(d_params[f"d.{name}"]))
    before = snapshot(state)["params"]
    vgg = load_vgg16(None, cfg.seed)
    state, m = make_train_step(cfg, vgg, update_d=False)(state, shard_batch(batch, _CPU))
    return {"losses": {k: float(v) for k, v in m.items()}, "before": before, **snapshot(state)}


@pytest.fixture(scope="module")
def runs():
    batches = _batches()
    cfg = Config(**_KW)
    one_cfg = cfg.replace(dp_devices=1, sp_devices=1)
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(spawn, run_rank, [_CPU, _CPU], (cfg, batches), timeout_s=150)
        one = one_process_steps(one_cfg, _CPU, batches)
        ranks = spawned.result()
    g_ref = _g_phase(one_cfg, batches[0], ranks[0]["first"]["params"])
    return {"ranks": ranks, "one": one, "g_ref": g_ref}


def _assert_leaves(tag, got, before, want_after, want_grads):
    ref = {k: torch.from_numpy(v) for k, v in want_grads.items()
           if k.startswith(tag) and v is not None}
    n_live = 0
    for key in _live_leaves(ref):
        g = got["grads"][key]
        assert g is not None, key
        rel = np.linalg.norm(g - want_grads[key]) / np.linalg.norm(want_grads[key])
        assert rel <= 1e-4, (key, rel)
        d_want = want_after[key] - before[key]
        d_got = got["params"][key] - before[key]
        assert np.abs(d_want).max() > 0.5 * _LR, key
        off = int((np.abs(d_got - d_want) > 0.25 * _LR).sum())
        assert off <= 0.01 * d_want.size, (key, off, d_want.size)
        n_live += 1
    return n_live


def test_two_ranks_of_two_shards_match_one_process(runs):
    """D's phase against one process's step, G's against one process's G
    phase on the ranks' D'."""
    ranks, one, g_ref = runs["ranks"], runs["one"], runs["g_ref"]
    got = ranks[0]["first"]
    np.testing.assert_allclose(ranks[0]["losses"][0]["loss_D"], one["losses"][0]["loss_D"],
                               rtol=1e-5, atol=1e-7)
    for k in _G_PHASE:
        np.testing.assert_allclose(ranks[0]["losses"][0][k], g_ref["losses"][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    n_d = _assert_leaves("d.", got, one["before"], one["first"]["params"], one["first"]["grads"])
    n_g = _assert_leaves("g.", got, g_ref["before"], g_ref["params"], g_ref["grads"])
    assert n_d >= 4 and n_g >= 8, (n_d, n_g)


def test_ranks_of_shards_stay_equal(runs):
    ranks = runs["ranks"]
    assert [o["equal"] for o in ranks] == [[True, True]] * 2
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["routing"] == {f: False for f in ranks[0]["routing"]}
