"""The port's spatial test mode (a 1-D H mesh, ``ircolor_tpu_torch/parallel``)
on the CPU, every shard a CPU tensor: the halo forms of the block convs
against the reflect form and against the JAX kernels' halo forms
(interpret mode), the spatial blocks and the spatial generator against the
JAX package's under ``shard_map`` on the fake CPU mesh and against the
port's unsharded forward, the shard-aware ops across their seams, and
``run_test`` with ``sp_devices=2`` against one device. Inputs come from
numpy seeds. The kernels themselves are held against these plain versions
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ircolor_tpu.ops import pallas_resblock

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.kernels import resblock
from ircolor_tpu_torch.models import generator as tgen
from ircolor_tpu_torch.ops import blurpool, norm, padding, quant
from ircolor_tpu_torch.parallel import spatial
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _mesh(n):
    return [CPU] * n


def _reflect_rows(x):
    return (x[:, 1:2].contiguous(), x[:, -2:-1].contiguous())


def _conv_case(seed, b=2, h=16, w=16, c=8, cout=12):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, cout) * 0.1).astype(np.float32)
    return rng, x, k


def _q_args(x, k, form):
    """(int8 kernel, sc, keyword arguments) of a conv1 or conv2 int8 call."""
    from ircolor_tpu_torch.ops.quant import _QCLIP, quantize_weight_per_channel

    kq, sw = quantize_weight_per_channel(k)
    b = x.shape[0]
    if form == "conv1":
        amax = x.abs().amax(dim=(1, 2, 3))
        return kq, (amax / 127.0)[:, None] * sw[None, :], dict(qscale=127.0 / amax)
    m, i = norm.instance_norm_stats(x)
    return kq, ((_QCLIP / 127.0) * sw[None, :]).expand(b, -1), dict(mean=m, inv=i)


# --- the halo forms of rows 1 and 2 --------------------------------------


@pytest.mark.parametrize("form", ["raw", "norm", "conv1", "conv2"])
@pytest.mark.parametrize("halo", ["separate", "provided"])
def test_halo_forms_equal_reflect_form_bit_for_bit(halo, form):
    """With the reflect rows as halo rows (or a reflect slab) the halo forms
    give the reflect form's output and statistics bit for bit (JAX's
    tests/test_pallas_resblock.py:318-352), and so do the plain versions of
    the operand passes the kernels run (the card's output is theirs); the
    ``sums`` keyword returns the Σy, Σy² that the moments come from."""
    _, x, k = _conv_case(9)
    x, k = t(x), t(k)
    kw = dict(halo=halo, halo_rows=_reflect_rows(x)) if halo == "separate" else dict(
        halo=halo)
    xin = x[:, resblock._reflect_rows(x.shape[1])] if halo == "provided" else x
    if form in ("raw", "norm"):
        args = () if form == "raw" else norm.instance_norm_stats(x)
        want = resblock.conv3x3_reflect_fused(x, k, *args)
        got = resblock.conv3x3_reflect_fused(xin, k, *args, **kw)
        out, sums = resblock.conv3x3_reflect_fused(xin, k, *args, sums=True, **kw)
        pw, pg = (resblock._conv_pass_plain(x, *args),
                  resblock._conv_pass_plain(xin, *args, **kw))
    else:
        kq, sc, qkw = _q_args(x, k, form)
        want = resblock.conv3x3_reflect_fused_q(x, kq, sc, **qkw)
        got = resblock.conv3x3_reflect_fused_q(xin, kq, sc, **qkw, **kw)
        out, sums = resblock.conv3x3_reflect_fused_q(xin, kq, sc, **qkw, sums=True, **kw)
        pw, pg = resblock._q_pass_plain(x, **qkw), resblock._q_pass_plain(xin, **qkw, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(pg, pw)
    n = x.shape[1] * x.shape[2]
    assert torch.equal(out, want[0]) and sums.shape == (2, 2, k.shape[-1])
    m, i = resblock._moments(sums[:, 0], sums[:, 1], n)
    assert torch.equal(m, want[1]) and torch.equal(i, want[2])


@pytest.mark.parametrize("halo", ["separate", "provided"])
@pytest.mark.parametrize("norm_in", [False, True])
def test_bf16_halo_forms_match_jax(halo, norm_in):
    """Halo rows that are not the reflect rows (a neighbour's): the port's
    halo forms against JAX's in interpret mode, at the bounds of
    tests/test_torch_kernels.py:51-53."""
    rng, x, k = _conv_case(3)
    top, bot = (rng.randn(2, 1, 16, 8).astype(np.float32) for _ in range(2))
    args_j, args_t = (), ()
    if norm_in:
        m, i = norm.instance_norm_stats(t(x))
        args_j, args_t = (jnp.asarray(m.numpy()), jnp.asarray(i.numpy())), (m, i)
    if halo == "separate":
        xj, kw_j = jnp.asarray(x), dict(halo_rows=(jnp.asarray(top), jnp.asarray(bot)))
        xt, kw_t = t(x), dict(halo_rows=(t(top), t(bot)))
    else:
        slab = np.concatenate([top, x, bot], axis=1)
        xj, kw_j, xt, kw_t = jnp.asarray(slab), {}, t(slab), {}
    want, wm, wi = pallas_resblock.conv3x3_reflect_fused(
        xj, jnp.asarray(k), *args_j, tile_h=4, halo=halo, interpret=True, **kw_j)
    got, gm, gi = resblock.conv3x3_reflect_fused(xt, t(k), *args_t, halo=halo, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-4)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("halo", ["separate", "provided"])
@pytest.mark.parametrize("form", ["conv1", "conv2"])
def test_int8_halo_forms_match_jax(halo, form):
    """The int8 halo forms against JAX's (both quantize the halo rows like
    the rest; the integer products are exact on both sides): the bounds of
    tests/test_torch_kernels.py's int8 conv, 1e-5."""
    from ircolor_tpu.ops.quant import quantize_weight_per_channel as jax_qw

    rng, x, k = _conv_case(4, c=32, cout=32)
    top, bot = (rng.randn(2, 1, 16, 32).astype(np.float32) for _ in range(2))
    kq, sc, kw = _q_args(t(x), t(k), form)
    kq_j, _ = jax_qw(jnp.asarray(k))
    kw_j = {key: jnp.asarray(v.numpy()) for key, v in kw.items()}
    sc = sc.contiguous()
    if halo == "separate":
        xj, hj = jnp.asarray(x), dict(halo_rows=(jnp.asarray(top), jnp.asarray(bot)))
        xt, ht = t(x), dict(halo_rows=(t(top), t(bot)))
    else:
        slab = np.concatenate([top, x, bot], axis=1)
        xj, hj, xt, ht = jnp.asarray(slab), {}, t(slab), {}
    want, wm, wi = pallas_resblock.conv3x3_reflect_fused_q(
        xj, kq_j, jnp.asarray(sc.numpy()), tile_h=4, halo=halo, interpret=True, **kw_j, **hj)
    got, gm, gi = resblock.conv3x3_reflect_fused_q(xt, kq, sc, halo=halo, **kw, **ht)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-5)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=1e-4)


def test_halo_form_arguments_are_checked():
    x = torch.zeros(1, 4, 4, 8)
    k = torch.zeros(3, 3, 8, 8)
    for kw in (dict(halo="bogus"), dict(halo="separate"),
               dict(halo="reflect", halo_rows=_reflect_rows(x)),
               dict(halo="separate", halo_rows=(x[:, :2], x[:, -1:]))):
        with pytest.raises(ValueError):
            resblock.conv3x3_reflect_fused(x, k, **kw)


# --- the spatial blocks ---------------------------------------------------


def _jax_spatial_block(blk, x, k1, k2, devices, n):
    mesh = Mesh(np.asarray(devices[:n]), ("sp",))
    fn = jax.jit(jax.shard_map(
        functools.partial(blk, axis="sp", tile_h=4, interpret=True), mesh=mesh,
        in_specs=(P(None, "sp", None, None), P(), P()), out_specs=P(None, "sp", None, None),
        check_vma=False))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "sp", None, None)))
    return np.asarray(fn(xs, jnp.asarray(k1), jnp.asarray(k2)))


@pytest.mark.parametrize("quant_int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("n", [2, 4])
def test_spatial_blocks_match_jax_and_unsharded(eight_cpu_devices, n, quant_int8):
    """``resnet_block_pallas(_q)_spatial`` over n CPU shards against the JAX
    package's under ``shard_map`` (tests/test_pallas_resblock.py:359-390)
    and against the port's unsharded block: atol 1e-5. Each shard's conv
    is launched in its halo form (counted apart on the card)."""
    rng = np.random.RandomState(7 + quant_int8)
    x = rng.randn(2, 32, 16, 8).astype(np.float32)
    k1, k2 = ((rng.randn(3, 3, 8, 8) * 0.1).astype(np.float32) for _ in range(2))
    jblk = (pallas_resblock.resnet_block_pallas_q_spatial if quant_int8
            else pallas_resblock.resnet_block_pallas_spatial)
    want = _jax_spatial_block(jblk, x, k1, k2, eight_cpu_devices, n)
    tblk = resblock.resnet_block_pallas_q_spatial if quant_int8 else \
        resblock.resnet_block_pallas_spatial
    calls = []
    name = "conv3x3_reflect_fused_q" if quant_int8 else "conv3x3_reflect_fused"
    orig = getattr(resblock, name)

    def counted(*a, **kw):
        calls.append(kw["halo"])
        return orig(*a, **kw)

    setattr(resblock, name, counted)
    try:
        got = spatial.gather_h(tblk(spatial.shard_h(t(x), _mesh(n)), t(k1), t(k2)))
    finally:
        setattr(resblock, name, orig)
    assert calls == ["separate"] * (2 * n)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    one = resblock.resnet_block_pallas_q if quant_int8 else resblock.resnet_block_pallas
    np.testing.assert_allclose(got.numpy(), one(t(x), t(k1), t(k2)).numpy(), atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_exchange_halo_rows_is_jax_exchange_with_reflect_edges(n):
    """r = 1, reflect: JAX's ``_exchange_halo_rows`` — the neighbours' edge
    rows inside, rows 1 and H−2 of the image at its edges — and for every
    r and pad the slabs are the rows of the padded image."""
    x = torch.arange(2 * 16 * 8 * 2, dtype=torch.float32).reshape(2, 16, 8, 2)
    xs = spatial.shard_h(x, _mesh(n))
    h = 16 // n
    for i, (top, bot) in enumerate(spatial.exchange_halo_rows(xs, 1)):
        assert torch.equal(top, x[:, abs(i * h - 1) : abs(i * h - 1) + 1])
        last = (i + 1) * h if i < n - 1 else 14
        assert torch.equal(bot, x[:, last : last + 1])
    for pad in spatial.PADS:
        full = padding.pad2d(x, 3, pad)
        for i, slab in enumerate(padding.pad2d_spatial(xs, 3, pad)):
            assert torch.equal(slab, full[:, i * h : i * h + h + 6])


def test_reductions_run_in_shard_order_and_come_back_to_each_shard():
    ts = [torch.full((2,), float(v)) for v in (1.0, 1e8, -1e8, 3.0)]
    for got in spatial.all_sum(ts):
        assert torch.equal(got, ((ts[0] + ts[1]) + ts[2]) + ts[3])
    for got in spatial.all_max(ts):
        assert torch.equal(got, torch.full((2,), 1e8))


def test_launcher_guard_finds_the_shards_tensor_and_runs_cpu_calls_as_they_are():
    """``on_input_card``, the guard that runs every ctypes launcher on its
    input's own card (a shard of a mesh over several cards): it takes the
    first tensor, in a list argument too, runs a CPU call as it is, and
    refuses a call with no tensor."""
    from ircolor_tpu_torch.kernels import on_input_card

    @on_input_card
    def launcher(mode, xs, k=None):
        return mode, xs[0] + 1, k

    x = torch.zeros(2)
    mode, y, k = launcher("m", [x], k=3)
    assert (mode, k) == ("m", 3) and torch.equal(y, torch.ones(2))
    assert torch.equal(launcher("m", (x,))[1], torch.ones(2))
    with pytest.raises(TypeError, match="no tensor"):
        launcher("m", [])
    assert resblock._conv_pass.__wrapped__ is not None  # the launchers carry it


# --- the shard-aware ops ---------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_shard_aware_ops_match_unsharded(n):
    """Across the seams, f32: the AA upsample (the grid's sources and
    weights from global positions), the blur-pool (stride-2 phase kept
    global), both IN statistics and the int8 conv's global amax give the
    unsharded op's result within 1e-6 (the upsample, the blur-pool and the
    int8 conv bit for bit)."""
    rng = np.random.RandomState(n)
    x = t(rng.randn(2, 32, 20, 16))
    xs = spatial.shard_h(x, _mesh(n))
    up = spatial.gather_h(blurpool.blur_upsample_aa_spatial(xs))
    np.testing.assert_allclose(up.numpy(), blurpool.blur_upsample_aa(x).numpy(), atol=1e-6)
    assert torch.equal(up, blurpool.blur_upsample_aa(x))
    assert torch.equal(spatial.gather_h(blurpool.blur_downsample_spatial(xs)),
                       blurpool.blur_downsample(x))
    for got, want in ((norm.instance_norm_spatial(xs), norm.instance_norm(x)),
                      (norm.instance_norm_onepass_spatial(xs), norm.instance_norm_onepass(x))):
        np.testing.assert_allclose(spatial.gather_h(got).numpy(), want.numpy(), atol=1e-6)
    k, bias = t(rng.randn(3, 3, 16, 8) * 0.1), t(rng.randn(8))
    for pad in ("zero", "reflect"):
        got = spatial.gather_h(quant.conv2d_int8_spatial(xs, k, pad=pad, bias=bias))
        assert torch.equal(got, quant.conv2d_int8(x, k, pad=pad, bias=bias))


# --- the generator and the runner -------------------------------------------


def test_spatial_generator_matches_jax_and_unsharded(eight_cpu_devices, monkeypatch):
    """tests/test_parallel.py:466-525 for the port: img 64, ngf 32, 2
    blocks, 4 shards, the fused blocks on their halo forms (gates opened,
    f32 routed as the kernels' dtype) against the JAX generator under its
    spatial mesh and against the port's unsharded forward: atol 2e-4,
    JAX's bound for this comparison."""
    from ircolor_tpu.models import generator as jgen
    from ircolor_tpu.models.wrapper import generator_from_config as jgen_from_config
    from ircolor_tpu.config import Config as JConfig
    from ircolor_tpu.parallel.mesh import replicated_sharding
    from ircolor_tpu.parallel.spatial import make_spatial_mesh, spatial_sharding

    from ircolor_tpu_torch.compat import state_dict_from_flax

    monkeypatch.setattr(jgen, "_pallas_available", lambda: True)
    monkeypatch.setattr(jgen, "_fused_dtype_ok", lambda d: True)
    monkeypatch.setattr(jgen, "resnet_block_pallas", functools.partial(
        pallas_resblock.resnet_block_pallas, interpret=True))
    monkeypatch.setattr(jgen, "resnet_block_pallas_spatial", functools.partial(
        pallas_resblock.resnet_block_pallas_spatial, interpret=True))
    monkeypatch.setattr(tgen, "_fused_dtype_ok", lambda d: True)
    calls = []
    monkeypatch.setattr(tgen, "resnet_block_pallas_spatial",
                        lambda *a: calls.append(1) or resblock.resnet_block_pallas_spatial(*a))

    jm = jgen_from_config(JConfig(img_size=64, n_blocks=2, ngf=32, pallas_norm_blur=False,
                                  pallas_head=False))
    ir = np.random.RandomState(3).rand(2, 64, 64, 1).astype(np.float32) * 2 - 1
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ir[:1]))["params"]
    mesh = make_spatial_mesh(4)
    spat = jm.clone(pallas_block_min_area=0, pallas_block_min_launch=0, spatial_mesh=mesh)
    sh = spatial_sharding(mesh)
    want = np.asarray(jax.jit(lambda p, x: spat.apply({"params": p}, x), out_shardings=sh)(
        jax.device_put(params, replicated_sharding(mesh)), jax.device_put(jnp.asarray(ir), sh)))

    g = tgen.ResnetUNetGenerator(ngf=32, n_blocks=2, pallas_block=True, pallas_block_min_area=0,
                                 pallas_block_min_launch=0)
    g.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)), strict=False)
    g.eval()
    with torch.inference_mode():
        one = g(t(ir)).numpy()
        g.spatial_mesh = _mesh(4)
        got = spatial.gather_h(g(spatial.shard_h(t(ir), g.spatial_mesh))).numpy()
    assert len(calls) == 2
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, one, atol=2e-4)


@pytest.mark.parametrize("quant_int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("n", [2, 4])
def test_spatial_generator_unfused_route_matches_unsharded(n, quant_int8):
    """f32, where no fused gate engages: the spatial forward's plain ops
    with their halos (the blocks' reflect convs, and under int8 the int8
    conv at every site on its halo'd int8 slab with the global amax)
    against the unsharded forward. Float: atol 2e-4. int8: the bound of
    tests/test_torch_generator.py's int8 route, at most 2.5 steps of the
    served uint8 grid anywhere and a quarter of a step on average (the IN
    moments summed in another order move a value across a rounding
    boundary here and there)."""
    torch.manual_seed(5)
    g = tgen.ResnetUNetGenerator(ngf=16, n_blocks=2, quant_int8=quant_int8).eval()
    x = torch.rand(2, 32, 24, 1) * 2 - 1
    with torch.inference_mode():
        want = g(x)
        g.spatial_mesh = _mesh(n)
        got = spatial.gather_h(g(spatial.shard_h(x, g.spatial_mesh)))
    d = (got - want).abs()
    if not quant_int8:
        assert float(d.max()) <= 2e-4
    else:
        step = 2.0 / 255.0
        assert float(d.max()) <= 2.5 * step and float(d.mean()) <= 0.25 * step


def test_run_test_spatial_matches_one_device(kaist_tree, tmp_path, monkeypatch):
    """``run_test(device="cpu")`` with ``sp_devices=2`` against one device
    on the same tree and weights (tests/test_eval.py:360-426): |ΔPSNR| <
    0.1, |ΔSSIM| < 1e-3, the same count; the spatial blocks engaged (the
    fused gate opened at the 8×8 test bottleneck, f32 routed as the
    kernels' dtype)."""
    from ircolor_tpu_torch.eval.runner import run_test
    from ircolor_tpu_torch.models import wrapper

    orig = wrapper.generator_from_config

    def opened(cfg, **kw):
        g = orig(cfg, **kw)
        for block in g.resblocks:
            block.pallas_block_min_area = block.pallas_block_min_launch = 0
        return g

    monkeypatch.setattr(wrapper, "generator_from_config", opened)
    monkeypatch.setattr(tgen, "_fused_dtype_ok", lambda d: True)
    calls = []
    monkeypatch.setattr(tgen, "resnet_block_pallas_spatial",
                        lambda *a: calls.append(1) or resblock.resnet_block_pallas_spatial(*a))
    root, _ = kaist_tree
    base = dict(mode="test", img_size=32, test_batch_size=4, n_blocks=1,
                test_roots=(str(root / "set02"),), topk=2, num_workers=2,
                save_comparisons=False)
    s1 = run_test(Config(output_dir=str(tmp_path / "one"), **base), device="cpu")
    s2 = run_test(Config(output_dir=str(tmp_path / "sp"), sp_devices=2, **base), device="cpu")
    assert calls, "the spatial fused block never engaged under sp_devices=2"
    assert s2["count"] == s1["count"] > 0
    assert abs(s2["mean_psnr"] - s1["mean_psnr"]) < 0.1
    assert abs(s2["mean_ssim"] - s1["mean_ssim"]) < 1e-3


def test_spatial_mode_refuses_what_is_not_ported(tmp_path):
    """A mesh on cards that are not there, a height the shards cannot
    split, the variants under the mesh and a training forward with a fused
    kernel on raise (with them off it trains); the runner's rebuild turns
    the tails and the head off."""
    from ircolor_tpu_torch.eval.runner import spatial_generator
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    with pytest.raises(ValueError, match="devices"):
        spatial.make_spatial_mesh(2)  # no card here
    assert spatial.make_spatial_mesh(3, ["cpu"] * 4) == _mesh(3)
    cfg = Config(img_size=32, ngf=8, n_blocks=1, sp_devices=2)
    m = IRColorizationModel(cfg, "cpu")
    with pytest.raises(ValueError, match="devices"):
        spatial_generator(cfg, m.module)
    with pytest.raises(ValueError, match="divide"):
        spatial_generator(cfg.replace(img_size=33), m.module, "cpu")
    g = spatial_generator(cfg, m.module, "cpu")
    assert g.spatial_mesh == _mesh(2) and not (g.pallas_norm_blur or g.pallas_head)
    assert m.module.spatial_mesh is None  # a copy: the unsharded module is unchanged
    xs = spatial.shard_h(torch.zeros(1, 32, 32, 1), g.spatial_mesh)
    for attr, value in (("norm", "batch"), ("no_antialias", True), ("no_antialias_up", True),
                        ("use_pallas", True)):
        bad = spatial_generator(cfg, m.module, "cpu")
        setattr(bad, attr, value)
        with torch.inference_mode(), pytest.raises(NotImplementedError, match="ROADMAP"):
            bad(xs)
    # In training the forward runs with the fused kernels off (as
    # train.state.train_config leaves them) and keeps its graph; the block
    # kernels' halo forms have no backward, so they raise.
    g.train()
    with pytest.raises(ValueError, match="no fused kernel"):
        g(xs)
    for block in g.resblocks:
        block.pallas_block = False
    ys = g(xs)
    assert [y.shape for y in ys] == [(1, 16, 32, 3)] * 2 and all(y.requires_grad for y in ys)
    g.eval().pallas_head = True
    with pytest.raises(ValueError, match="pallas_head"):
        g(xs)
