"""The port's generator against the JAX generator on shared weights, in
float32 on the CPU: the plain (XLA) route, the kernel route (the JAX
kernels in interpret mode, the port's kernel entry points on their plain
versions) in float and int8, and weights crossing both ways."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.compat.torch_import import export_generator_pth
from ircolor_tpu.models import generator as jgen
from ircolor_tpu.ops import pallas_blur, pallas_head, pallas_resblock

from ircolor_tpu_torch.compat import state_dict_from_flax
from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.models import generator as tgen
from ircolor_tpu_torch.models.wrapper import IRColorizationModel, load_state_permissive
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

_BUFFERS = ("down1_down.filt", "down2_down.filt", "up1_up.filt", "up2_up.filt")


def _jax_params(module, hw):
    # One jitted init: eager init compiles every initializer on its own.
    params = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 1)))["params"]
    return jax.tree.map(np.asarray, params)


def _port(params, **kw):
    g = tgen.ResnetUNetGenerator(**kw)
    missing, unexpected = g.load_state_dict(state_dict_from_flax(params), strict=False)
    assert sorted(missing) == sorted(_BUFFERS) and not unexpected
    return g.eval()


def test_param_count_matches_reference():
    g = tgen.ResnetUNetGenerator()
    assert sum(p.numel() for p in g.parameters()) == 11_556_227


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_plain_route_matches_jax_f32(n_blocks):
    """ngf=8 at 64×80: every fused gate is off (f32), both packages run
    their plain ops. Bound of docs/PARITY.md for the f32 path: 2e-5."""
    hw = (64, 80)
    jm = jgen.ResnetUNetGenerator(ngf=8, n_blocks=n_blocks)
    params = _jax_params(jm, hw)
    x = np.random.RandomState(n_blocks).uniform(-1, 1, (2, *hw, 1)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = _port(params, ngf=8, n_blocks=n_blocks)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *hw, 3)
    np.testing.assert_allclose(got, want, atol=2e-5)


def _kernel_route_pair(monkeypatch, quant):
    """JAX and port generators, B=2, 32×64, ngf=64, 1 block, both routed
    through blocks, tails and head (monkeypatched as tests/test_models.py
    does); returns (port output, JAX output, port kernel-entry calls)."""
    monkeypatch.setattr(jgen, "_pallas_available", lambda: True)
    monkeypatch.setattr(jgen, "_fused_dtype_ok", lambda d: True)
    for name, fn in (
        ("resnet_block_pallas", pallas_resblock.resnet_block_pallas),
        ("resnet_block_pallas_q", pallas_resblock.resnet_block_pallas_q),
        ("norm_relu_blur_down", pallas_blur.norm_relu_blur_down),
        ("outc_head", pallas_head.outc_head),
    ):
        monkeypatch.setattr(jgen, name, functools.partial(fn, interpret=True))
    calls = {}
    monkeypatch.setattr(tgen, "_fused_dtype_ok", lambda d: True)
    for name in ("resnet_block_pallas", "resnet_block_pallas_q", "norm_relu_blur_down", "outc_head"):
        def counted(*a, _fn=getattr(tgen, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tgen, name, counted)
    flags = dict(
        n_blocks=1, pallas_block=True, pallas_block_min_area=0, pallas_block_min_launch=0,
        pallas_norm_blur=True, pallas_head=True, quant_int8=quant,
    )
    hw = (32, 64)
    jm = jgen.ResnetUNetGenerator(**flags)
    params = _jax_params(jm, hw)
    x = np.random.RandomState(7).uniform(-1, 1, (2, *hw, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = _port(params, **flags)(torch.from_numpy(x)).numpy()
    return got, want, calls


def test_kernel_route_matches_jax_f32(monkeypatch):
    got, want, calls = _kernel_route_pair(monkeypatch, quant=False)
    assert calls == {"resnet_block_pallas": 1, "norm_relu_blur_down": 2, "outc_head": 1}
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_kernel_route_int8_matches_jax(monkeypatch):
    """int8 blocks. The block input here is ReLU'd and blurred (non-negative)
    on an 8×16 plane, where |mean| ≫ std and the one-pass f32 IN moments of
    the JAX kernel lose digits to cancellation; the next conv's fixed-grid
    rounding turns that into flips (test_torch_kernels pins the port's block
    to float64 moments). Bound: at most 2.5 steps of the served uint8 grid
    (2/255 of the [−1, 1] output) anywhere, 0.25 of a step on average."""
    got, want, calls = _kernel_route_pair(monkeypatch, quant=True)
    assert calls == {"resnet_block_pallas_q": 1, "norm_relu_blur_down": 2, "outc_head": 1}
    d = np.abs(got - want)
    step = 2.0 / 255.0
    assert float(d.max()) <= 2.5 * step
    assert float(d.mean()) <= 0.25 * step


def test_pinned_golden_digest():
    """The committed digest of the reference generator under pinned numpy
    weights (tests/goldens/generator_pinned.npz, the JAX package's
    tests/test_models.py:test_generator_pinned_golden_digest) at its 5e-5
    bound; the reference's state_dict loads into the port strictly."""
    import os

    from torch_golden import GoldGenerator

    sd = GoldGenerator(n_blocks=9).state_dict()
    pinned = {
        key: t if key.endswith(".filt") else torch.from_numpy(
            np.random.RandomState(1000 + i).randn(*t.shape).astype(np.float32) * 0.02)
        for i, (key, t) in enumerate(sd.items())
    }
    g = tgen.ResnetUNetGenerator()
    g.load_state_dict(pinned, strict=True)
    ir = np.random.RandomState(123).rand(2, 64, 64, 1).astype(np.float32) * 2 - 1
    with torch.inference_mode():
        out = g.eval()(torch.from_numpy(ir)).numpy()
    golden = np.load(os.path.join(os.path.dirname(__file__), "goldens", "generator_pinned.npz"))
    np.testing.assert_allclose(out, golden["out"], atol=5e-5)


def test_weights_cross_both_ways(tmp_path):
    """state_dict_from_flax on a JAX tree gives the port the same state as
    loading the .pth that the JAX package's exporter writes."""
    jm = jgen.ResnetUNetGenerator(ngf=8, n_blocks=2)
    params = _jax_params(jm, (32, 32))
    pth = str(tmp_path / "netG.pth")
    export_generator_pth(params, pth)
    a = tgen.ResnetUNetGenerator(ngf=8, n_blocks=2)
    a.load_state_dict(torch.load(pth, weights_only=True), strict=True)
    b = _port(params, ngf=8, n_blocks=2)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=k)
    # The permissive wrapper load: {'state_dict': ...} unwrap, extras ignored.
    m = IRColorizationModel(Config(ngf=8, n_blocks=2, img_size=32), "cpu")
    load_state_permissive(m.module, {"state_dict": {**sa, "extra.weight": torch.zeros(1)}})
    for k, v in m.module.state_dict().items():
        torch.testing.assert_close(v, sa[k], rtol=0, atol=0, msg=k)


def test_unported_modes_raise():
    """Only 2-D H×W tiling is left unported among the multi-device modes
    (spatial test mode and training, data parallelism run), and the
    variants under ``sp_devices`` in training; the variants the JAX
    ``Config`` reaches build (``tests/test_torch_variants.py`` holds them
    against JAX), and an unknown norm raises as in JAX."""
    from ircolor_tpu_torch.train.state import create_train_state

    assert IRColorizationModel(Config(ngf=8, n_blocks=1, dp_devices=2), "cpu").module
    with pytest.raises(NotImplementedError, match="sp_w_devices"):
        IRColorizationModel(Config(sp_devices=2, sp_w_devices=2), "cpu")
    with pytest.raises(NotImplementedError, match="sp_w_devices"):
        create_train_state(Config(sp_devices=2, sp_w_devices=2), steps_per_epoch=1, device="cpu")
    state = create_train_state(Config(sp_devices=2, ngf=8, n_blocks=1), steps_per_epoch=1,
                               device="cpu")  # spatial training builds, its kernels off
    assert state.g.spatial_mesh == [torch.device("cpu")] * 2 and state.g.training
    assert not (state.g.resblocks[0].pallas_block or state.g.pallas_norm_blur
                or state.g.pallas_head or state.g.pallas_encdec_bwd)
    for variant in (dict(norm="batch"), dict(no_antialias=True), dict(use_pallas=True)):
        with pytest.raises(NotImplementedError, match="sp_devices > 1"):
            create_train_state(Config(sp_devices=2, ngf=8, n_blocks=1, **variant),
                               steps_per_epoch=1, device="cpu")
    assert IRColorizationModel(Config(ngf=8, n_blocks=1, sp_devices=2), "cpu").module
    with pytest.raises(NotImplementedError, match="Normalization type"):
        tgen.ResnetUNetGenerator(norm="group")
    assert tgen.ResnetUNetGenerator(norm="batch").norm == "batch"
    assert IRColorizationModel(Config(no_antialias=True, img_size=32), "cpu").module.no_antialias
