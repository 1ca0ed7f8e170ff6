"""The generator's variants on a 1-D H mesh (spatial test mode), on the CPU,
every shard a CPU tensor:

  - the f32 spatial forward of each variant at img 64, ngf 8, 2 blocks, on
    2 and 4 H-shards, against the JAX generator's forward on the same
    weights (one ``jax.jit`` trace a variant, shared by both shard counts),
    within 2e-5 (``tests/test_torch_spatial.py``'s f32 bound): batch norm
    (eval, running statistics crossed over), no norm, ``no_antialias``,
    ``no_antialias_up`` and both, the blocks' replicate and zero pads,
    dropout in eval, ``use_pallas`` (JAX: kernel 11 in interpret mode
    behind a patched ``_pallas_available``; the port: row 11h's plain
    versions, every instance norm);
  - the same variants on unequal shards (H = 40 over 4: 10-row shards, 5
    after down1, 3/2/3/2 at the bottleneck, the ConvTranspose's 6/4/6/4
    rows re-cut to the skip's 5/5/5/5) against the port's unsharded
    forward, within 2e-5; the int8 route under batch norm + no_antialias
    (+ no_antialias_up) in bf16, where the sharding may add a quarter of a
    uint8 step on average (``tests/test_torch_spatial_int8.py``'s bound),
    the stride-2 int8 conv on each shard's slab;
  - row 11h's plain version against kernel 11's on the whole plane, on
    equal, unequal and empty shards, forward (f32 1e-5 relative, bf16 one
    ulp) and backward (1e-5 relative L2), and its gate on the global shape.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.models import generator as jgen
from ircolor_tpu.ops import pallas_kernels as jk

from ircolor_tpu_torch.kernels import instance_norm as tin
from ircolor_tpu_torch.ops import quant as tquant
from ircolor_tpu_torch.parallel import spatial
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_variants import _jax_variables, _port, _variables

_CPU = torch.device("cpu")
_HW = (64, 64)

VARIANTS = {
    "batch": dict(norm="batch"),
    "none": dict(norm="none"),
    "no_antialias": dict(no_antialias=True),
    "no_antialias_up": dict(no_antialias_up=True),
    "no_aa_both": dict(no_antialias=True, no_antialias_up=True),
    "replicate": dict(padding_type="replicate"),
    "zero": dict(padding_type="zero"),
    "dropout": dict(use_dropout=True),
    "use_pallas": dict(use_pallas=True),
}
_REFS: dict = {}


def _reference(name: str):
    """(params, stats, input, JAX's output) of a variant, computed once."""
    if name not in _REFS:
        kw = dict(ngf=8, n_blocks=2, **VARIANTS[name])
        with pytest.MonkeyPatch.context() as mp:
            if name == "use_pallas":
                mp.setattr(jgen, "_pallas_available", lambda: True)
                mp.setattr(jgen, "instance_norm_auto",
                           functools.partial(jk.instance_norm_auto, interpret=True))
            jm = jgen.ResnetUNetGenerator(**kw)
            params, stats = _jax_variables(jm, perturb="all")
            x = np.random.RandomState(3).uniform(-1, 1, (2, *_HW, 1)).astype(np.float32)
            want = np.asarray(jax.jit(jm.apply)(_variables(params, stats), jnp.asarray(x)))
        _REFS[name] = (params, stats, x, want)
    return _REFS[name]


def _sharded(g, x: torch.Tensor, n: int) -> torch.Tensor:
    g.spatial_mesh = [_CPU] * n
    try:
        with torch.inference_mode():
            return spatial.gather_h(g(spatial.shard_h(x, g.spatial_mesh)))
    finally:
        g.spatial_mesh = None


def _count_11h(monkeypatch) -> list:
    calls = []
    real = tin._run_in_spatial

    def counted(xs, relu, residuals):
        calls.append("residual" if residuals is not None else "relu")
        return real(xs, relu, residuals)

    monkeypatch.setattr(tin, "_run_in_spatial", counted)
    return calls


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_spatial_forward_matches_jax(name, n, monkeypatch):
    params, stats, x, want = _reference(name)
    kw = dict(ngf=8, n_blocks=2, **VARIANTS[name])
    g = _port(params, stats, **kw).eval()
    calls = _count_11h(monkeypatch)
    got = _sharded(g, torch.from_numpy(x), n).numpy()
    assert got.shape == want.shape == (2, *_HW, 3)
    if name == "use_pallas":  # inc, down1, down2, up1, up2, each block's two halves
        assert sorted(calls) == ["relu"] * 7 + ["residual"] * 2
    else:
        assert not calls
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_unequal_shard_heights_follow_the_blur_pools_rule():
    """At H = 40 over 4 shards the stride-2 convs' owner rule gives the
    blur-pool's stage heights, and the ConvTranspose doubles each shard."""
    assert spatial.check_stage_heights(40, 4, 2) == [[10] * 4, [5] * 4, [3, 2, 3, 2]]
    assert spatial.window_heights([10] * 4, 3, 2, 1) == [5] * 4
    assert spatial.window_heights([5] * 4, 3, 2, 1) == [3, 2, 3, 2]
    layer = torch.nn.ConvTranspose2d(4, 4, 3, 2, 1, output_padding=1)
    xs = [torch.zeros(1, h, 6, 4) for h in (3, 2, 3, 2)]
    from ircolor_tpu_torch.models.common import conv_transpose_spatial

    ys = conv_transpose_spatial(layer, xs, torch.float32)
    assert [y.shape[1] for y in ys] == [6, 4, 6, 4]
    assert [y.shape[1] for y in spatial.reshard_rows(ys, [5] * 4)] == [5] * 4


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_on_unequal_shards_matches_unsharded(name, monkeypatch):
    params, stats, _, _ = _reference(name)
    g = _port(params, stats, ngf=8, n_blocks=2, **VARIANTS[name]).eval()
    x = torch.from_numpy(np.random.RandomState(5).uniform(-1, 1, (2, 40, 32, 1))
                         .astype(np.float32))
    with torch.inference_mode():
        want = g(x)
    calls = _count_11h(monkeypatch)
    got = _sharded(g, x, 4)
    assert (len(calls) == 9) == (name == "use_pallas")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


@pytest.mark.parametrize("up", [False, True], ids=["no_aa", "no_aa_both"])
def test_int8_batch_no_antialias_on_unequal_shards(up, monkeypatch):
    """bf16 int8 serving under batch norm + no_antialias (+ the
    ConvTranspose ups): every conv but inc, outc and the ups on the int8
    route, the down convs at stride 2 on each shard's slab; against the
    unsharded forward, a quarter of a uint8 step on average and 2.5 steps
    at most (the IN-free route sums the same integers: it is exact but for
    the batch norm's f32 glue)."""
    kw = dict(norm="batch", no_antialias=True, no_antialias_up=up)
    params, stats = _jax_variables(jgen.ResnetUNetGenerator(ngf=16, n_blocks=2, **kw),
                                   perturb="norms")
    g = _port(params, stats, ngf=16, n_blocks=2, dtype=torch.bfloat16, quant_int8=True,
              **kw).eval()
    strides = []
    real = tquant.conv3x3_int8

    def counted(xq, *a, **k):
        strides.append(k.get("stride", 1))
        return real(xq, *a, **k)

    x = torch.from_numpy(np.random.RandomState(6).uniform(-1, 1, (2, 40, 32, 1))
                         .astype(np.float32))
    with torch.inference_mode():
        want = g(x).float()
    monkeypatch.setattr(tquant, "conv3x3_int8", counted)
    got = _sharded(g, x, 4).float()
    assert strides.count(2) == 2 * 4 and strides.count(1) == 8 * 4
    d = (got - want).abs()
    step = 2.0 / 255.0
    assert float(want.std()) > 0.1
    assert float(d.mean()) <= 0.25 * step and float(d.max()) <= 2.5 * step, (
        float(d.mean()) / step, float(d.max()) / step)


# --- row 11h's plain version ------------------------------------------------


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0**-126))) - 7).clamp(min=1e-6)
    return float(((got.float() - w).abs() / ulp).max())


@pytest.mark.parametrize("heights", [(8, 8, 8, 8), (13, 1, 8, 10), (5, 0, 19, 8)],
                         ids=["equal", "unequal", "empty"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_11h_plain_matches_kernel_11_plain(heights, dtype):
    rng = np.random.RandomState(sum(heights))
    x = torch.from_numpy(rng.randn(2, sum(heights), 12, 24).astype(np.float32) * 3 + 1).to(dtype)
    r = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).to(dtype)
    xs, rs = list(x.split(list(heights), 1)), list(r.split(list(heights), 1))
    for relu in (False, True):
        got = torch.cat(tin.run_in_spatial(xs, relu), 1)
        want = tin.fused_instance_norm_plain(x, relu)
        if dtype == torch.float32:
            assert float(((got - want).abs() / want.abs().clamp(min=1.0)).max()) <= 1e-5
        else:
            assert _bf16_ulps(got, want) <= 1
    got = torch.cat(tin.run_in_spatial(xs, residuals=rs), 1)
    want = tin.fused_instance_norm_residual_plain(x, r)
    if dtype == torch.float32:
        assert float(((got - want).abs() / want.abs().clamp(min=1.0)).max()) <= 1e-5
    else:
        assert _bf16_ulps(got, want) <= 1
    if dtype == torch.bfloat16:
        return
    g = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
    for relu, res in ((True, False), (False, True)):
        xa, ra = x.clone().requires_grad_(), r.clone().requires_grad_()
        want = (tin.fused_instance_norm_residual(xa, ra) if res
                else tin.fused_instance_norm(xa, relu))
        want_g = torch.autograd.grad((want * g).sum(), [xa, ra] if res else [xa])
        xb, rb = x.clone().requires_grad_(), r.clone().requires_grad_()
        xbs, rbs = list(xb.split(list(heights), 1)), list(rb.split(list(heights), 1))
        ys = (tin.fused_instance_norm_residual_spatial(xbs, rbs) if res
              else tin.fused_instance_norm_spatial(xbs, relu))
        got_g = torch.autograd.grad((torch.cat(ys, 1) * g).sum(), [xb, rb] if res else [xb])
        for a, b in zip(got_g, want_g):
            assert float((a - b).norm() / b.norm()) <= 1e-5


def test_11h_gate_reads_the_global_shape(monkeypatch):
    """``pallas_fits`` on the shards' summed height: a plane whose shards
    each fit but whole does not takes the plain two-pass ops."""
    from ircolor_tpu_torch.ops.norm import instance_norm

    c = 256
    h = next(h for h in range(8, 512, 8)
             if not tin.pallas_fits((1, h, 64, c), torch.float32)
             and tin.pallas_fits((1, h // 2, 64, c), torch.float32))
    xs = [torch.randn(1, h // 2, 64, c, generator=torch.Generator().manual_seed(i))
          for i in range(2)]
    calls = _count_11h(monkeypatch)
    ys = tin.instance_norm_auto_spatial(xs, relu=True)
    assert not calls
    want = torch.relu(instance_norm(torch.cat(xs, 1)))
    assert float((torch.cat(ys, 1) - want).abs().max()) <= 1e-5
    assert len(tin.instance_norm_auto_spatial([x[:, :4] for x in xs], relu=True)) == 2
    assert calls == ["relu"]
