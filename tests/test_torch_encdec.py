"""The port's encoder/decoder segment backward against the JAX package's, on
the CPU: ``conv_in_relu_fused`` against the JAX ``custom_vjp`` (its Pallas
kernels in interpret mode), the dgrad/wgrad kernels' segment modes against
the JAX kernels, the routing gate, and the generator with
``pallas_encdec_bwd`` on shared weights."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.models import generator as jgen
from ircolor_tpu.ops import pallas_encdec as je
from ircolor_tpu.ops import pallas_resblock as jr

from ircolor_tpu_torch.compat import state_dict_from_flax
from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.kernels import LAUNCHES
from ircolor_tpu_torch.kernels import encdec as te
from ircolor_tpu_torch.kernels import resblock as tr
from ircolor_tpu_torch.models import generator as tgen
from ircolor_tpu_torch.models.wrapper import generator_from_config
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

_BUFFERS = {"down1_down.filt", "down2_down.filt", "up1_up.filt", "up2_up.filt"}
_SEGMENT_BIASES = ("down1.0.bias", "down2.0.bias", "up1_conv.0.bias")


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# The JAX test's shapes (tests/test_pallas_encdec.py): one leg, two output
# widths, and the decoder's two-leg concat.
@pytest.mark.parametrize("wgrad_mode", ["xla", "fused"])
@pytest.mark.parametrize(
    "cins,cout,hw", [((16,), 8, (16, 16)), ((16,), 32, (8, 24)), ((24, 8), 16, (16, 16))]
)
def test_segment_matches_jax(wgrad_mode, cins, cout, hw):
    b = 2
    zs = tuple(_rand((b, *hw, c), 7 + i) for i, c in enumerate(cins))
    k = _rand((3, 3, sum(cins), cout), 3, 0.2)
    cot = _rand((b, *hw, cout), 11)

    @jax.jit  # one trace of the primal and the custom_vjp backward
    def jfn(zs_, k_, cot_):
        out, vjp = jax.vjp(lambda a, kk: je.conv_in_relu_fused(wgrad_mode, 8, True, a, kk), zs_, k_)
        return out, vjp(cot_)

    want_out, (want_dzs, want_dk) = jfn(tuple(jnp.asarray(z) for z in zs), jnp.asarray(k),
                                        jnp.asarray(cot))

    tzs = tuple(torch.from_numpy(z).requires_grad_() for z in zs)
    tk = torch.from_numpy(k).requires_grad_()
    before = dict(LAUNCHES)
    out = te.conv_in_relu_fused(wgrad_mode, tzs, tk)
    (out * torch.from_numpy(cot)).sum().backward()
    assert LAUNCHES == before  # CPU tensors: the plain versions
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=2e-5, rtol=1e-4)
    for got, want in zip(tzs, want_dzs):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(want_dk), atol=3e-3, rtol=1e-3)


def _bwd_inputs(seed, b, h, w, c, cin):
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return dict(p=arr(b, h, w, c), comp=arr(b, h, w, c), aux=arr(b, h, w, cin),
                z=arr(b, h, w, cin), k=arr(3, 3, cin, c, scale=0.2), m=arr(b, c, scale=0.1),
                inv=np.abs(arr(b, c)) + 0.5, gm=arr(b, c, scale=0.1), gy=arr(b, c, scale=0.1))


def _both(d, *names):
    return [jnp.asarray(d[n]) for n in names], [torch.from_numpy(d[n]) for n in names]


# H 4..16 (a tile holding both image edges, several tiles), W 16/24; C = 8
# cotangent channels, Cin = 16 output channels of the dgrad.
@pytest.mark.parametrize("hw", [(4, 16), (12, 24), (16, 16)])
@pytest.mark.parametrize("form", ["segment", "zero_residual", "reflect_mask_p"])
def test_dgrad_modes_match_jax(hw, form):
    """The segment form (zero halos, p masked on load, no aux, dy emitted)
    and the modes combined otherwise, against the JAX kernel."""
    d = _bwd_inputs(hw[0] + 20, 2, *hw, 8, 16)
    aux = None if form == "segment" else "aux"
    names = ("p", "comp") + ((aux,) if aux else ()) + ("k", "m", "inv", "gm", "gy")
    jargs, targs = _both(d, *names)
    if aux is None:
        jargs.insert(2, None)
        targs.insert(2, None)
    kw = dict(pad="reflect" if form == "reflect_mask_p" else "zero",
              mask_p=form != "zero_residual")
    want = jr.conv3x3_dgrad_fused(*jargs, **kw, tile_h=4, interpret=True)
    got = tr.conv3x3_dgrad_fused(*targs, **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    no_dy = tr.conv3x3_dgrad_fused(*targs, emit_dy=False, **kw)
    assert no_dy[1] is None
    torch.testing.assert_close(no_dy[0], got[0], rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(8, 16), (12, 24)])
@pytest.mark.parametrize("mask_p", [False, True])
def test_wgrad_zero_pad_matches_jax(hw, mask_p):
    d = _bwd_inputs(30 + hw[0], 2, *hw, 8, 16)
    for key in ("p", "comp"):  # keep |dk| near 1 so atol 1e-4 is a relative bound too
        d[key] = d[key] * np.float32(0.25)
    jargs, targs = _both(d, "z", "p", "comp", "m", "inv", "gm", "gy")
    want = jr.conv3x3_wgrad_fused(*jargs, pad="zero", mask_p=mask_p, tile_h=4, interpret=True)
    got = tr.conv3x3_wgrad_fused(*targs, pad="zero", mask_p=mask_p)
    assert got.shape == (3, 3, 16, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_seg_tile_h_equals_jax():
    for h, w, c in ((512, 640, 128), (256, 320, 256), (256, 320, 128), (100, 320, 128),
                    (7, 320, 128), (32, 32, 128), (16, 16, 256), (64, 4096, 384)):
        assert te.seg_tile_h(h, w, c) == je.seg_tile_h(h, w, c), (h, w, c)


def test_generator_gradient_matches_jax(monkeypatch):
    """The generator-level gradient of sum|G(x)| (ngf 64, no blocks, f32,
    16×16) with the port's segment route on, against JAX autodiff of the
    same generator, leaf by leaf within 2e-3 relative L2: the JAX test's
    bound for its segment route against autodiff (the segments' one-pass IN
    moments against XLA's two-pass; ``test_segment_matches_jax`` holds the
    segment itself to the JAX segment). The segments' conv biases get no
    gradient from the port (the segments do not read them); they and the
    other conv biases under IN have a true gradient of 0 and rounding noise
    on the JAX side: as in the JAX test, only their smallness is compared."""
    monkeypatch.setattr(tgen, "_fused_dtype_ok", lambda d: True)
    modes = []

    def counted(wgrad_mode, zs, k):
        modes.append(wgrad_mode)
        return te.conv_in_relu_fused(wgrad_mode, zs, k)

    monkeypatch.setattr(tgen, "conv_in_relu_fused", counted)
    jm = jgen.ResnetUNetGenerator(ngf=64, n_blocks=0)
    x = np.random.RandomState(5).randn(2, 16, 16, 1).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    g = tgen.ResnetUNetGenerator(ngf=64, n_blocks=0, pallas_encdec_bwd=True)
    missing, unexpected = g.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)),
                                            strict=False)
    assert set(missing) == _BUFFERS and not unexpected
    want = jax.jit(jax.grad(lambda p: jnp.sum(jnp.abs(jm.apply({"params": p}, jnp.asarray(x),
                                                               train=True)))))(params)
    torch.abs(g.train()(torch.from_numpy(x))).sum().backward()
    assert modes == ["xla", "fused", "fused"]  # down1 (64-channel leg), down2, up1
    want_sd = state_dict_from_flax(jax.tree.map(np.asarray, want))
    for name, p in g.named_parameters():
        if name in _SEGMENT_BIASES:
            assert p.grad is None and float(want_sd[name].norm()) < 1e-2, name
            continue
        if float(want_sd[name].norm()) < 1e-2:
            assert float(p.grad.norm()) < 1e-2, name
            continue
        rel = float((p.grad - want_sd[name]).norm() / want_sd[name].norm())
        assert rel < 2e-3, (name, rel)


def test_encdec_flag_reaches_the_generator(monkeypatch):
    """``Config.pallas_encdec_bwd`` reaches the generator: a bf16 generator
    in training mode takes the segment route for down1, down2 and up1 (not
    in eval mode), and their conv biases get no gradient, as in the JAX
    package."""
    modes = []

    def counted(wgrad_mode, zs, k):
        modes.append(wgrad_mode)
        return te.conv_in_relu_fused(wgrad_mode, zs, k)

    monkeypatch.setattr(tgen, "conv_in_relu_fused", counted, raising=False)
    cfg = Config(img_size=32, ngf=64, n_blocks=0, compute_dtype="bf16", pallas_encdec_bwd=True)
    g = generator_from_config(cfg)
    x = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32))
    with torch.no_grad():
        g.eval()(x)
    assert modes == []  # the segment is a training route
    out = g.train()(x)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())
    out.float().abs().sum().backward()
    assert modes == ["xla", "fused", "fused"]
    grads = dict(g.named_parameters())
    for name in _SEGMENT_BIASES:
        assert grads[name].grad is None, name
    for name in ("down1.0.weight", "down2.0.weight", "up1_conv.0.weight", "inc.1.weight"):
        assert grads[name].grad is not None and bool(torch.isfinite(grads[name].grad).all()), name


def test_jax_params_with_both_flags_load_strictly():
    """The JAX parameter tree is the same with ``use_pallas`` and
    ``pallas_encdec_bwd`` on: it loads into the port strictly."""
    jm = jgen.ResnetUNetGenerator(ngf=8, n_blocks=2, use_pallas=True, pallas_encdec_bwd=True)
    params = jax.jit(functools.partial(jm.init, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))["params"]
    g = tgen.ResnetUNetGenerator(ngf=8, n_blocks=2, use_pallas=True, pallas_encdec_bwd=True)
    sd = {**state_dict_from_flax(jax.tree.map(np.asarray, params)),
          **{k: v for k, v in g.state_dict().items() if k in _BUFFERS}}
    g.load_state_dict(sd, strict=True)
