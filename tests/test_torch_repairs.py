"""Three faults of the port against the JAX package, each pinned by a CPU
test: int8 in a module in training mode, ``conv_precision`` on the f32
path, and ``sp_w_devices > 1`` without ``sp_devices``."""

import numpy as np
import pytest
import torch

from ircolor_tpu.ops.conv import _PRECISIONS as JAX_PRECISIONS

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.eval.runner import run_test
from ircolor_tpu_torch.models import generator as tgen
from ircolor_tpu_torch.models import wrapper
from ircolor_tpu_torch.train.state import create_train_state
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _pair():
    """The same f32 weights in an int8 module and a float one."""
    torch.manual_seed(0)
    q = tgen.ResnetUNetGenerator(ngf=8, n_blocks=1, quant_int8=True)
    q.init_weights("normal", 0.02, torch.Generator().manual_seed(3))
    f = tgen.ResnetUNetGenerator(ngf=8, n_blocks=1)
    f.load_state_dict(q.state_dict())
    ramp = np.linspace(-1, 1, 32 * 32, dtype=np.float32).reshape(1, 32, 32, 1)
    return q, f, torch.from_numpy(ramp)


def test_int8_module_in_training_mode_runs_float():
    """The JAX generator gates int8 on ``not train`` (``quant_int8 and not
    train``): in ``.train()`` the int8 module is the float one, output to
    2e-5 (the f32 bound) and gradients to 1e-5 relative L2; in ``.eval()``
    it still takes the int8 route and differs."""
    q, f, x = _pair()
    q.train()
    f.train()
    assert not q._quant_convs(x) and not q.resblocks[0].quant
    yq, yf = q(x), f(x)
    np.testing.assert_allclose(yq.detach().numpy(), yf.detach().numpy(), atol=2e-5)
    cot = torch.from_numpy(np.random.RandomState(1).randn(*yq.shape).astype(np.float32))
    (yq * cot).sum().backward()
    (yf * cot).sum().backward()
    for (name, pq), pf in zip(q.named_parameters(), f.parameters()):
        num = float((pq.grad - pf.grad).norm())
        assert num <= 1e-5 * max(float(pf.grad.norm()), 1e-30), name
    q.eval()
    f.eval()
    assert q._quant_convs(x) and q.resblocks[0].quant
    with torch.no_grad():
        d = float((q(x) - f(x)).abs().max())
    assert d > 1e-4, d  # the int8 rounding shows


@pytest.fixture()
def tf32_flags():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("name, tf32", [("highest", False), ("high", True), ("default", True)])
def test_conv_precision_sets_tf32_on_f32(tf32_flags, name, tf32):
    """The JAX package's names, each honoured on f32: ``highest`` keeps
    TF32 off, ``high`` and ``default`` allow it for cuDNN convs and
    matmuls. bf16 leaves both flags as they were, as JAX reads the name on
    f32 only."""
    assert set(wrapper._PRECISIONS) == set(JAX_PRECISIONS)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = not tf32
    wrapper.generator_from_config(Config(ngf=8, n_blocks=1, conv_precision=name))
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
    wrapper.generator_from_config(
        Config(ngf=8, n_blocks=1, conv_precision="highest", compute_dtype="bf16"))
    assert torch.backends.cudnn.allow_tf32 is tf32


def test_unknown_conv_precision_raises(tf32_flags):
    cfg = Config(ngf=8, n_blocks=1, conv_precision="bogus")
    with pytest.raises(KeyError, match="bogus"):
        wrapper.generator_from_config(cfg)
    with pytest.raises(KeyError, match="bogus"):
        create_train_state(cfg, steps_per_epoch=1, device="cpu")


def test_sp_w_devices_without_sp_devices_raises(tmp_path):
    """JAX's ``run_test`` refuses ``sp_w_devices > 1`` with ``sp_devices <=
    1`` (``ValueError``); so do the port's test-mode entry points, before
    they build anything. Training does not read the flag, as JAX's
    (``train/loop.py:135-143``): the state is the unsharded one. With
    ``sp_devices`` the 2-D generator builds."""
    cfg = Config(ngf=8, n_blocks=1, sp_w_devices=2, output_dir=str(tmp_path / "out"),
                 test_roots=(str(tmp_path / "none"),))
    for call in (lambda: wrapper.generator_from_config(cfg),
                 lambda: run_test(cfg, device="cpu")):
        with pytest.raises(ValueError, match="sp_w_devices=2 requires sp_devices > 1"):
            call()
    assert not (tmp_path / "out").exists()
    assert create_train_state(cfg, steps_per_epoch=1, device="cpu").g.spatial_mesh is None
    assert wrapper.generator_from_config(cfg.replace(sp_devices=4)).spatial_mesh is None
