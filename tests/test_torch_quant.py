"""The port's int8 route outside the fused blocks against the JAX package's
XLA int8 route, on the CPU: the quantizers, ``conv2d_int8`` and
``conv2d_int8_fixed`` (the port's int8 conv kernel on its plain version),
the int8 concat-conv legs, the whole generator on the batch-1 int8 route,
and the opt-in end-of-network int8 (fixed-scale up2, int8 head) with the
JAX kernels in interpret mode. Inputs are made with numpy from a seed."""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from ircolor_tpu.compat.torch_import import load_generator_pth
from ircolor_tpu.models import generator as jgen
from ircolor_tpu.models.common import ConcatConv3x3
from ircolor_tpu.ops import pallas_blur, pallas_head, pallas_resblock
from ircolor_tpu.ops import quant as jquant

from ircolor_tpu_torch.eval.metrics import batched_metrics, quantize_to_uint8_01
from ircolor_tpu_torch.kernels import LAUNCHES
from ircolor_tpu_torch.models import common as tcommon
from ircolor_tpu_torch.models import generator as tgen
from ircolor_tpu_torch.ops import quant as tquant
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _jconv(x, w):
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    return jax.lax.conv_general_dilated(x, w, (1, 1), ((1, 1), (1, 1)), dimension_numbers=dn)


def _assert_same_grid(got_q, got_s, want_q, want_s):
    """int8 tensors identical on ≥ 99.99% of elements, a flip never more
    than one step; scales identical."""
    d = np.abs(got_q.numpy().astype(np.int32) - np.asarray(want_q).astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.9999
    np.testing.assert_array_equal(got_s.numpy().ravel(), np.asarray(want_s).ravel())


def test_quantizers_match_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 16, 20, 32) * rng.uniform(0.1, 3.0, (3, 1, 1, 1))).astype(np.float32)
    _assert_same_grid(*tquant.quantize_dynamic(t(x)), *jquant.quantize_dynamic(jnp.asarray(x)))
    w = (rng.randn(3, 3, 32, 48) * 0.05).astype(np.float32)
    _assert_same_grid(*tquant.quantize_weight_per_channel(t(w)),
                      *jquant.quantize_weight_per_channel(jnp.asarray(w)))


def test_conv2d_int8_exact_for_int_valued_operands():
    """Operands on their int8 grids (tests/test_quant.py's inputs) come out
    of the port's conv equal to the JAX int8 conv and to the float conv
    within that test's bound."""
    rng = np.random.RandomState(0)
    xi = rng.randint(-127, 128, (2, 9, 11, 32)).astype(np.float32)
    xi[0, 0, 0, 0], xi[1, 0, 0, 0] = 127, 127
    x = (xi * np.array([0.031, 0.17], np.float32).reshape(2, 1, 1, 1)).astype(np.float32)
    wi = rng.randint(-127, 128, (3, 3, 32, 64)).astype(np.float32)
    wi[0, 0, 0, :] = 127
    w = (wi * rng.uniform(0.01, 0.2, 64).astype(np.float32)).astype(np.float32)
    got = tquant.conv2d_int8(t(x), t(w)).numpy()
    want = np.asarray(jquant.conv2d_int8(jnp.asarray(x), jnp.asarray(w), padding=((1, 1), (1, 1))))
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(_jconv(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=1e-2)


def _step_bound(got, want, x_got_q, x_want_q, step):
    """Outputs whose 3×3 receptive field saw no quantization flip agree to
    1e-6 relative; the others within one quant step (``step`` broadcast to
    the output)."""
    flips = torch.from_numpy(
        (np.asarray(x_got_q).astype(np.int32) != np.asarray(x_want_q).astype(np.int32))
        .any(axis=-1).astype(np.float32))
    touched = F.max_pool2d(flips[:, None], 3, stride=1, padding=1)[:, 0].numpy() > 0
    d = np.abs(got - want)
    clean = d[~touched] <= 1e-6 * np.abs(want[~touched]) + 1e-30
    assert clean.all()
    assert (d / step).max() <= 1.0


@pytest.mark.parametrize("fixed", [False, True])
def test_conv2d_int8_random_inputs_match_jax(fixed):
    rng = np.random.RandomState(1 + fixed)
    x = (np.abs(rng.randn(2, 12, 14, 64)) if fixed else rng.randn(2, 12, 14, 64)).astype(np.float32)
    w = (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    xj, wj, bj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias)
    if fixed:
        got = tquant.conv2d_int8_fixed(t(x), t(w), bias=t(bias)).numpy()
        want = np.asarray(jquant.conv2d_int8_fixed(xj, wj, padding=((1, 1), (1, 1)), bias=bj))
        qg, qw = tquant.quantize_fixed(t(x)), jnp.clip(jnp.round(xj * (127.0 / 6.0)), -127, 127)
        sx = np.full((2, 1, 1, 1), 6.0 / 127.0, np.float32)
    else:
        got = tquant.conv2d_int8(t(x), t(w), bias=t(bias)).numpy()
        want = np.asarray(jquant.conv2d_int8(xj, wj, padding=((1, 1), (1, 1)), bias=bj))
        qg, s = tquant.quantize_dynamic(t(x))
        qw = jquant.quantize_dynamic(xj)[0]
        sx = s.numpy()
    sw = tquant.quantize_weight_per_channel(t(w))[1].numpy()
    _step_bound(got, want, qg, qw, 127.0 * sx * sw)


@pytest.mark.parametrize("quant", ["dynamic", "fixed"])
def test_concat_conv3x3_int8_legs_match_jax(quant):
    """Each leg quantizes its own input and its own half of the weight; the
    legs are float32 terms summed before the bias and the cast."""
    rng = np.random.RandomState(3)
    a = np.abs(rng.randn(2, 10, 12, 64)).astype(np.float32)
    b = np.abs(rng.randn(2, 10, 12, 32)).astype(np.float32)
    jm = ConcatConv3x3(32, quant_int8=quant == "dynamic", quant_fixed=quant == "fixed")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b))["params"]
    params = {**params, "bias": jnp.asarray(rng.randn(32).astype(np.float32) * 0.1)}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(a), jnp.asarray(b)))
    conv = torch.nn.Conv2d(96, 32, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(t(np.asarray(params["kernel"]).transpose(3, 2, 0, 1)))
        conv.bias.copy_(t(np.asarray(params["bias"])))
    with torch.inference_mode():
        got = tcommon.concat_conv3x3(conv, t(a), t(b), torch.float32, quant=quant)
        # The JAX order, bit for bit: (leg a + leg b) + bias, each leg f32.
        fn = {"dynamic": tquant.conv2d_int8, "fixed": tquant.conv2d_int8_fixed}[quant]
        k = conv.weight.permute(2, 3, 1, 0)
        legs = fn(t(a), k[:, :, :64], out_dtype=torch.float32) + fn(
            t(b), k[:, :, 64:], out_dtype=torch.float32)
        assert torch.equal(got, legs + conv.bias)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# --- the whole generator ----------------------------------------------------


def _weights_both(tmp_path, ngf, n_blocks):
    """Random generator weights from a torch seed, as the port's state_dict
    and as the JAX parameter tree read from the same reference-layout .pth
    (cheaper than a JAX init, which compiles every op)."""
    g = tgen.ResnetUNetGenerator(ngf=ngf, n_blocks=n_blocks)
    g.init_weights("normal", 0.02, torch.Generator().manual_seed(0))
    path = str(tmp_path / "netG.pth")
    torch.save(g.state_dict(), path)
    return g.state_dict(), load_generator_pth(path)


def _port(state, **kw):
    g = tgen.ResnetUNetGenerator(**kw)
    g.load_state_dict(state, strict=True)
    return g.eval()


def _metrics(fake, gt01):
    pred = quantize_to_uint8_01((torch.from_numpy(np.array(fake, np.float32)) + 1.0) / 2.0)
    return batched_metrics(pred, gt01), pred


def _assert_serving_budget(got, want, seed):
    """The int8 serving budget on the uint8 prediction (docs/PARITY.md):
    |ΔPSNR| ≤ 0.02 dB and |ΔSSIM| ≤ 0.002 per image, against a smooth
    target made from a seed; a mean uint8 difference of at most 2 levels
    (the serving bound of chip_smoke.py's phase 4)."""
    b, h, w, _ = want.shape
    rng = np.random.RandomState(seed)
    gt = F.interpolate(torch.from_numpy(rng.rand(b, 3, h // 8, w // 8).astype(np.float32)),
                       size=(h, w), mode="bilinear").permute(0, 2, 3, 1)
    mg, pg = _metrics(got, gt)
    mw, pw = _metrics(want, gt)
    assert float((mg["psnr"] - mw["psnr"]).abs().max()) <= 0.02
    assert float((mg["ssim"] - mw["ssim"]).abs().max()) <= 0.002
    assert float((pg - pw).abs().mean()) * 255 <= 2.0


@pytest.mark.parametrize("opt_in", [False, True])
def test_generator_b1_int8_route_matches_jax(tmp_path, monkeypatch, opt_in):
    """ngf 8, 2 blocks, 64×80, B=1, f32, with the serving flags: no fused
    gate engages, so both packages run every heavy conv on the dynamic int8
    route (JAX by its QuantConv on the CPU, the port by ``conv3x3_int8``) —
    with ``quant_fixed_u2`` and ``quant_head`` set too (``opt_in``), which
    take effect only where the fused kernels engage."""
    hw = (64, 80)
    flags = dict(ngf=8, n_blocks=2, quant_int8=True, pallas_block=True,
                 pallas_norm_blur=True, pallas_norm_blur_min_area=18000,
                 pallas_norm_blur_min_launch=600000, pallas_head=True,
                 pallas_head_min_area=100000, pallas_head_min_launch=600000,
                 quant_fixed_u2=opt_in, quant_head=opt_in)
    state, params = _weights_both(tmp_path, 8, 2)
    jm = jgen.ResnetUNetGenerator(**flags)
    x = np.random.RandomState(11).uniform(-1, 1, (1, *hw, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    g = _port(state, **flags)
    assert g._quant_convs(torch.from_numpy(x))
    calls = []
    real = tquant.conv3x3_int8

    def counted(xq, *a, **kw):
        calls.append(xq.shape[-1])
        return real(xq, *a, **kw)

    monkeypatch.setattr(tquant, "conv3x3_int8", counted)
    for name, mod in (("conv2d_int8_fixed", tcommon), ("outc_head_q", tgen)):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **kw: calls.append(_n))
    with torch.inference_mode():
        got = g(torch.from_numpy(x)).float().numpy()
    # down1, down2, 2 blocks × 2, up1 × 2 legs, up2 × 2 legs.
    assert calls == [8, 16, 32, 32, 32, 32, 32, 16, 16, 8]
    _assert_serving_budget(got, want, seed=12)


def test_generator_opt_in_int8_routes_match_jax(monkeypatch, tmp_path):
    """``quant_fixed_u2`` and ``quant_head`` where the fused kernels engage
    (B=2, the small-batch band, 16×64, ngf 64; the JAX kernels in
    interpret mode, as tests/test_quant.py runs them): both packages take
    the fixed-scale up2 conv (2 legs) and the int8 head exactly where the
    other does, and no dynamic int8 enc/dec conv."""
    monkeypatch.setattr(jgen, "_pallas_available", lambda: True)
    monkeypatch.setattr(jgen, "_fused_dtype_ok", lambda d: True)
    monkeypatch.setattr(tgen, "_fused_dtype_ok", lambda d: True)
    for name, fn in (
        ("resnet_block_pallas_q", pallas_resblock.resnet_block_pallas_q),
        ("norm_relu_blur_down", pallas_blur.norm_relu_blur_down),
        ("outc_head", pallas_head.outc_head),
        ("outc_head_q", pallas_head.outc_head_q),
    ):
        monkeypatch.setattr(jgen, name, functools.partial(fn, interpret=True))
    calls = {"jax": {}, "port": {}}

    def count(side, mod, name):
        real = getattr(mod, name)

        def counted(*a, **kw):
            calls[side][name] = calls[side].get(name, 0) + 1
            return real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)

    for name in ("conv2d_int8", "conv2d_int8_fixed"):
        count("jax", jquant, name)
        count("port", tcommon, name)
    for name in ("outc_head", "outc_head_q"):
        count("jax", jgen, name)
        count("port", tgen, name)
    flags = dict(n_blocks=1, pallas_block=True, pallas_block_min_area=0, pallas_block_min_launch=0,
                 pallas_norm_blur=True, pallas_head=True, quant_int8=True, quant_fixed_u2=True,
                 quant_head=True)
    hw = (16, 64)
    state, params = _weights_both(tmp_path, 64, 1)
    jm = jgen.ResnetUNetGenerator(**flags)
    x = np.random.RandomState(7).uniform(-1, 1, (2, *hw, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = _port(state, **flags)(torch.from_numpy(x)).numpy()
    assert calls["jax"] == calls["port"] == {"conv2d_int8_fixed": 2, "outc_head_q": 1}
    _assert_serving_budget(got, want, seed=8)


def test_cpu_int8_route_launches_nothing():
    before = dict(LAUNCHES)
    xq = torch.randint(-127, 128, (1, 8, 16, 32), dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, 32, 64), dtype=torch.int8)
    tquant.conv3x3_int8(xq, wq, torch.ones(1, 64), pad="reflect")
    assert LAUNCHES == before
    with pytest.raises(ValueError):
        tquant.conv3x3_int8(xq, wq, torch.ones(1, 64), pad="replicate")
