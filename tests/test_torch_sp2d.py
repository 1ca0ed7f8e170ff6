"""The port's 2-D H×W spatial tiling in test mode (``--sp-w-devices``) on the
CPU, every tile a CPU tensor: the halo and slab helpers against ``np.pad``
of the whole image (corners apart from edges), row 11h's tile form (its
plain version) against kernel 11's plain version on the whole plane and its
launch plan at tile shapes, the 2-D generator against the JAX package's
GSPMD forward on the fake 4×2 CPU mesh and against the port's unsharded
forward, the int8 route and the model variants on tiles, and ``run_test``
over 2-D meshes against one device. Inputs come from numpy seeds. The
kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.kernels import instance_norm as tin
from ircolor_tpu_torch.models import generator as tgen
from ircolor_tpu_torch.models.common import BatchNorm
from ircolor_tpu_torch.ops.padding import pad2d_spatial
from ircolor_tpu_torch.parallel import spatial
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
_NP_PADS = {"reflect": "reflect", "zero": "constant", "replicate": "edge"}
# (rows of each H-shard, columns of each W-tile): a 2×2 grid with a
# 1-column tile and a 4×2 grid with a 1-row shard, both unequal.
GRIDS = {"2x2": ((4, 5), (6, 1)), "4x2": ((2, 3, 1, 3), (3, 4))}


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _cut(x, rows, cols):
    """NHWC ``x`` as the grid of tiles of ``rows`` × ``cols``."""
    return [list(r.split(list(cols), dim=2)) for r in x.split(list(rows), dim=1)]


def _mesh(sh, sw):
    return spatial.make_spatial_mesh(sh * sw, [CPU] * (sh * sw), sw)


# --- (a) the halo and slab helpers -------------------------------------------


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("pad", ["reflect", "zero", "replicate"])
def test_halo_slabs_are_np_pad_corners_apart_from_edges(pad, grid):
    """Each tile's slab with r = 2 (past a 1-column or 1-row neighbour) is
    its window of ``np.pad`` of the whole image: checked apart in its four
    corners, its four edges and its middle; ``pad2d_spatial`` is the same
    slab; the grid re-cut, shard-tiled and gathered round-trips."""
    rows, cols = GRIDS[grid]
    x = np.random.RandomState(len(rows)).randn(2, sum(rows), sum(cols), 3).astype(np.float32)
    r = 2
    want = np.pad(x, ((0, 0), (r, r), (r, r), (0, 0)), mode=_NP_PADS[pad])
    tiles = _cut(t(x), rows, cols)
    slabs = spatial.halo_slabs(tiles, r, pad)
    padded = pad2d_spatial(tiles, r, pad)
    r0 = 0
    for i, h in enumerate(rows):
        c0 = 0
        for j, w in enumerate(cols):
            got, win = slabs[i][j].numpy(), want[:, r0 : r0 + h + 2 * r, c0 : c0 + w + 2 * r]
            assert got.shape == win.shape
            for name, (ys, xs) in {
                "corner tl": (slice(0, r), slice(0, r)), "corner tr": (slice(0, r), slice(-r, None)),
                "corner bl": (slice(-r, None), slice(0, r)),
                "corner br": (slice(-r, None), slice(-r, None)),
                "edge top": (slice(0, r), slice(r, -r)), "edge bottom": (slice(-r, None), slice(r, -r)),
                "edge left": (slice(r, -r), slice(0, r)), "edge right": (slice(r, -r), slice(-r, None)),
                "middle": (slice(r, -r), slice(r, -r)),
            }.items():
                np.testing.assert_array_equal(got[:, ys, xs], win[:, ys, xs], err_msg=f"{i},{j} {name}")
            assert torch.equal(padded[i][j], slabs[i][j])
            c0 += w
        r0 += h
    assert torch.equal(spatial.gather_hw(tiles), t(x))
    again = spatial.reshard_hw(tiles, rows[::-1], cols[::-1])
    assert [row[0].shape[1] for row in again] == list(rows[::-1])
    assert torch.equal(spatial.gather_hw(again), t(x))


@pytest.mark.parametrize("grid", list(GRIDS))
def test_window_slabs_at_stride_2_in_both_axes(grid):
    """A 3×3 zero-padded window at stride 2: each tile keeps the output
    rows and columns the owner rule gives it in each axis, and its 2-D
    slab convolved VALID at stride 2 gives them (the unsharded conv's,
    bit for bit); the W form alone (``axis`` 2) on one tile row is the
    slab of ``np.pad`` in W."""
    rows, cols = GRIDS[grid]
    rng = np.random.RandomState(7)
    x = rng.randn(1, sum(rows), sum(cols), 4).astype(np.float32)
    k = t(rng.randn(5, 4, 3, 3))
    tiles = _cut(t(x), rows, cols)
    want = F.conv2d(t(x).permute(0, 3, 1, 2), k, stride=2, padding=1)
    hs = spatial.window_heights(rows, 3, 2, 1)
    ws = spatial.window_heights(cols, 3, 2, 1)
    slabs = spatial.window_slabs(tiles, 3, 2, 1)
    o_r = 0
    for i, n in enumerate(hs):
        o_c = 0
        for j, m in enumerate(ws):
            slab = slabs[i][j]
            if not n or not m:
                assert slab is None
            else:
                got = F.conv2d(slab.permute(0, 3, 1, 2), k, stride=2)
                assert torch.equal(got, want[:, :, o_r : o_r + n, o_c : o_c + m]), (i, j)
            o_c += m
        o_r += n
    wide = spatial.window_slabs(tiles[0], 3, 2, 1, axis=2)
    padw = np.pad(x[:, : rows[0]], ((0, 0), (0, 0), (1, 1), (0, 0)))
    o_c = 0
    for slab, m in zip(wide, ws):
        if m:
            np.testing.assert_array_equal(slab.numpy(), padw[:, :, 2 * o_c : 2 * (o_c + m) + 1])
        o_c += m


# --- (b) row 11h's tile form ---------------------------------------------------


def _in_close(got, want):
    """Within one bf16 ulp of ``want`` (f32: 1e-5 relative)."""
    g, w = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
        return bool(((g - w).abs() <= ulp).all())
    return bool(((g - w).abs() <= 1e-5 * w.abs().clamp_min(1.0)).all())


@pytest.mark.parametrize("mode", ["bf16 relu", "bf16 residual", "f32 relu"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_row_11h_tile_form_matches_kernel_11_on_the_plane(grid, mode):
    """The tile form's plain version (stats a tile, the merge in tile
    order, apply) against kernel 11's plain version on the gathered plane:
    within one bf16 ulp (f32 1e-5); ``instance_norm_auto_spatial`` gives
    the same tiles; a grid that needs a gradient raises (the tile form
    serves only, as 2-D tiling does)."""
    rows, cols = GRIDS[grid]
    dtype = torch.float32 if mode.startswith("f32") else torch.bfloat16
    rng = np.random.RandomState(3)
    x = (t(rng.randn(2, sum(rows), sum(cols), 24)) * 3 + 1).to(dtype)
    r = t(rng.randn(*x.shape)).to(dtype)
    xs, rs = _cut(x, rows, cols), _cut(r, rows, cols)
    if mode.endswith("residual"):
        got = tin.run_in_spatial(xs, residuals=rs)
        want = tin.run_in_res(x, r)
        auto = tin.instance_norm_auto_spatial(xs, residuals=rs)
    else:
        got = tin.run_in_spatial(xs, relu=True)
        want = tin.run_in(x, relu=True)
        auto = tin.instance_norm_auto_spatial(xs, relu=True)
    assert _in_close(spatial.gather_hw(got), want)
    assert torch.equal(spatial.gather_hw(auto), spatial.gather_hw(got))
    leaves = [[a.clone().requires_grad_() for a in row] for row in xs]
    with pytest.raises(NotImplementedError, match="no backward"):
        tin.fused_instance_norm_spatial(leaves, relu=True)


_CARD0, _CARD1 = torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("shape,devices,form", [
    ((2, 2), (_CARD0,) * 4, "cluster"),
    ((4, 2), (_CARD0,) * 8, "cluster"),
    ((3, 4), (_CARD0,) * 12, "per_shard"),   # 12 tiles: over the portable cluster size
    ((2, 2), (_CARD0, _CARD1) * 2, "per_shard"),
    ((2, 2), (CPU,) * 4, "plain"),
], ids=["2x2-one-card", "4x2-one-card", "3x4-one-card", "2x2-two-cards", "cpu"])
def test_halo_plan_form_at_tile_shapes(shape, devices, form):
    """The form by where the tiles are (≤ 8 tiles on one card: one cluster
    of Sh·Sw CTAs); each rank's rows and columns; a CTA stages its tile's
    slice plane where it fits. On the 256² bottleneck (64×64×256 bf16,
    the plane the gate admits) 64-byte slices: 64 KB a CTA at 2×2, 32 KB
    at 4×2."""
    sh, sw = shape
    heights, widths = (64 // sh,) * (sh * sw), (64 // sw,) * (sh * sw)
    plan = tin.tile_plan(heights, widths, 256, torch.bfloat16, devices)
    assert plan.form == form and plan.cols == widths and plan.rows == heights
    assert plan.cluster == (sh * sw if form == "cluster" else 0)
    if form == "cluster":
        assert plan.slice_bytes == 64
        assert plan.staged == (heights[0] * widths[0] * 64,) * (sh * sw)
        assert plan.smem == tin._shard_head_bytes(torch.bfloat16, 64) + plan.stage_cap <= 232448
    one = tin.halo_plan((64,), 160, 256, torch.bfloat16, (_CARD0,))  # the 1-D form is unchanged
    assert one.cols == (160,) and one.starts == (0,) and one.staged == (0,)  # 320 KB: unstaged


# --- (c)-(e) the 2-D generator --------------------------------------------------


def test_2d_generator_matches_jax_gspmd_and_unsharded(eight_cpu_devices):
    """tests/test_parallel.py:370-400 for the port: img 32, ngf 16, 2
    blocks, f32, ``lanepack=False``, the fake 4×2 CPU mesh under
    ``spatial_sharding(mesh, module)``, against the port's 2-D forward on
    the same weights and input, and the port's unsharded forward: atol
    2e-4 both."""
    import warnings

    from ircolor_tpu.config import Config as JConfig
    from ircolor_tpu.models.wrapper import generator_from_config as jgen_from_config
    from ircolor_tpu.parallel.mesh import replicated_sharding
    from ircolor_tpu.parallel.spatial import make_spatial_mesh, spatial_sharding

    from ircolor_tpu_torch.compat import state_dict_from_flax

    jm = jgen_from_config(JConfig(img_size=32, n_blocks=2, ngf=16, lanepack=False))
    ir = np.random.RandomState(1).rand(2, 32, 32, 1).astype(np.float32) * 2 - 1
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ir[:1]))["params"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the 2-D tiling lanepack advisory
        mesh = make_spatial_mesh(8, w_devices=2)
    sh = spatial_sharding(mesh, jm)
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x), out_shardings=sh)(
        jax.device_put(params, replicated_sharding(mesh)), jax.device_put(jnp.asarray(ir), sh)))

    g = tgen.ResnetUNetGenerator(ngf=16, n_blocks=2)
    g.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)), strict=False)
    g.eval()
    with torch.inference_mode():
        one = g(t(ir)).numpy()
        g.spatial_mesh = _mesh(4, 2)
        tiles = g(spatial.shard_hw(t(ir), g.spatial_mesh))
    assert [len(row) for row in tiles] == [2] * 4
    got = spatial.gather_hw(tiles).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, one, atol=2e-4)


def _mean_abs_u8(a, b) -> float:
    """Mean |Δ| of two generator outputs in [−1, 1] after the serving
    path's uint8 rounding, in uint8 levels."""
    from ircolor_tpu_torch.eval.metrics import quantize_to_uint8_01

    pa, pb = (quantize_to_uint8_01((y.float() + 1.0) / 2.0) for y in (a, b))
    return float((pa - pb).abs().mean()) * 255


@pytest.mark.parametrize("norm", ["instance", "batch", "batch no_antialias"])
@pytest.mark.parametrize("grid", [(2, 2), (4, 2)])
def test_2d_int8_unfused_route_matches_unsharded(grid, norm, monkeypatch):
    """int8 serving on tiles: every enc/dec and block conv on the int8
    conv's 2-D slabs (halo rows, columns and corners of int8 values, the
    per-sample amax over every tile before any tile quantizes; stride 2 by
    the owner rule in both axes under no_antialias), one call a tile a
    site. Where no float statistic crosses the tiles (batch norm on its
    running statistics) the route is the unsharded int8 route bit for
    bit. Under instance norm the statistics are summed in another order,
    and a last-bit difference flips an int8 rounding that the random net
    carries downstream (at 2×2 here one flip at down1's input, from a
    7e-7 difference of inc's statistics, moves the output by up to 5 steps
    of the uint8 grid, 0.44 on average): so it is held, as
    ``tests/test_torch_variants.py`` holds the int8 routes, to the
    unsharded route's own rounding spread, the mean uint8 |Δ| that a 2^-9
    nudge of its input moves it by."""
    from ircolor_tpu_torch.ops import quant as tquant

    calls = []
    real = tquant.conv3x3_int8
    monkeypatch.setattr(tquant, "conv3x3_int8", lambda *a, **k: calls.append(1) or real(*a, **k))
    torch.manual_seed(5)
    kw = dict(norm="batch", no_antialias="no_antialias" in norm) if norm != "instance" else {}
    g = tgen.ResnetUNetGenerator(ngf=16, n_blocks=2, quant_int8=True, **kw).eval()
    for m in g.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.uniform_(-0.5, 0.5)
            m.running_var.uniform_(0.5, 2.0)
    rs = np.random.RandomState(5)
    x = t(rs.rand(2, 32, 24, 1) * 2 - 1)
    nudged = x + t(rs.uniform(-1, 1, x.shape)) * 2.0**-9
    with torch.inference_mode():
        want = g(x)
        spread = _mean_abs_u8(g(nudged), want)
        calls.clear()
        g.spatial_mesh = _mesh(*grid)
        got = spatial.gather_hw(g(spatial.shard_hw(x, g.spatial_mesh)))
    # down1, down2, 2 blocks × 2, up1 and up2 × 2 legs: 10 sites, one call a tile.
    assert len(calls) == 10 * grid[0] * grid[1]
    if norm != "instance":
        assert torch.equal(got, want)
    else:
        assert spread > 0.5 and _mean_abs_u8(got, want) <= spread, spread


VARIANTS = {
    "batch": dict(norm="batch"),
    "none": dict(norm="none"),
    "no_antialias": dict(no_antialias=True),
    "no_antialias_up": dict(no_antialias_up=True),
    "use_pallas": dict(use_pallas=True),
    "replicate": dict(padding_type="replicate"),
    "zero": dict(padding_type="zero"),
    "dropout": dict(use_dropout=True),
    "odd planes": dict(),
    "odd planes no_antialias_up": dict(no_antialias_up=True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_2d_variants_match_unsharded(variant):
    """Each variant on a 2×2 grid against its unsharded forward, f32 atol
    2e-4: batch norm on its running statistics, no norm, the stride-2 down
    convs, the ConvTranspose ups, ``use_pallas`` (row 11h's tile form at
    every instance norm), the blocks' replicate and zero pads, dropout in
    training (the mask drawn in the whole shape, each tile its window).
    W 36 leaves unequal tiles after the second stage (5 and 4 columns);
    the odd planes (42×26) need the bilinear fix-up in both axes, cut at
    the skip's tiles."""
    kw = VARIANTS[variant]
    hw = (42, 26) if variant.startswith("odd") else (32, 36)
    torch.manual_seed(9)
    g = tgen.ResnetUNetGenerator(ngf=8, n_blocks=1, **kw)
    if kw.get("norm") == "batch":
        for m in g.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    g.train() if variant == "dropout" else g.eval()
    x = t(np.random.RandomState(2).rand(2, *hw, 1) * 2 - 1)
    gens = []
    if variant == "dropout":
        for block in g.resblocks:
            block.dropout_generator = torch.Generator().manual_seed(4)
            gens.append(block.dropout_generator)
    with torch.no_grad():
        want = g(x)
        for gen in gens:
            gen.manual_seed(4)
        g.spatial_mesh = _mesh(2, 2)
        tiles = g(spatial.shard_hw(x, g.spatial_mesh))
    if variant == "odd planes":
        assert [row[0].shape[1] for row in tiles] == [21, 21]
        assert [x_.shape[2] for x_ in tiles[0]] == [13, 13]
    got = spatial.gather_hw(tiles)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)


# --- (f) the runner -------------------------------------------------------------


def test_run_test_2d_matches_one_device(kaist_tree, tmp_path):
    """``run_test(device="cpu")`` with ``sp_devices=4, sp_w_devices=2`` at
    img 32 and with ``sp_devices=8, sp_w_devices=2`` at img 40 (H 40 over
    4 H-shards: 40 % 8 ≠ 0 is fine) against one device, to JAX's bounds
    (tests/test_eval.py:428-480): the same count, |ΔPSNR| < 0.1, |ΔSSIM| <
    1e-3."""
    from ircolor_tpu_torch.eval.runner import run_test

    root, _ = kaist_tree
    base = dict(mode="test", test_batch_size=4, n_blocks=1, ngf=8,
                test_roots=(str(root / "set02"),), topk=2, num_workers=2,
                save_comparisons=False)
    for size, n in ((32, 4), (40, 8)):
        s1 = run_test(Config(output_dir=str(tmp_path / f"one{size}"), img_size=size, **base),
                      device="cpu")
        s2 = run_test(Config(output_dir=str(tmp_path / f"sp{size}"), img_size=size, sp_devices=n,
                             sp_w_devices=2, **base), device="cpu")
        assert s2["count"] == s1["count"] > 0
        assert abs(s2["mean_psnr"] - s1["mean_psnr"]) < 0.1
        assert abs(s2["mean_ssim"] - s1["mean_ssim"]) < 1e-3


def test_2d_mesh_divisors_and_rebuild():
    """JAX's divisor checks and messages (``runner.py:224-239``, and the
    mesh's own), the runner's rebuild (tails, head and fused blocks off on
    a 2-D mesh; the module left as it was), the mesh's shape, and a
    mesh with no cards behind it."""
    from ircolor_tpu_torch.eval.runner import spatial_generator
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    cfg = Config(img_size=32, ngf=8, n_blocks=1, sp_devices=8, sp_w_devices=2,
                 pallas_block=True, pallas_norm_blur=True, pallas_head=True)
    m = IRColorizationModel(cfg, "cpu")
    with pytest.raises(ValueError, match="img height 34 must divide by the H-shard count 4"):
        spatial_generator(cfg.replace(img_size=34), m.module, "cpu")
    with pytest.raises(ValueError, match="img width 33 must divide by sp_w_devices=2"):
        spatial_generator(cfg.replace(img_size=None, img_height=32, img_width=33), m.module, "cpu")
    with pytest.raises(ValueError, match="6 devices do not tile into w_devices=4"):
        spatial_generator(cfg.replace(sp_devices=6, sp_w_devices=4), m.module, "cpu")
    with pytest.raises(ValueError, match="devices"):
        spatial_generator(cfg, m.module)  # no card here
    g = spatial_generator(cfg, m.module, "cpu")
    assert g.spatial_mesh == [[CPU, CPU]] * 4
    assert not (g.pallas_norm_blur or g.pallas_head or any(b.pallas_block for b in g.resblocks))
    assert m.module.spatial_mesh is None and m.module.resblocks[0].pallas_block
    assert spatial.make_spatial_mesh(4, ["cpu"] * 4, 1) == [CPU] * 4
    with pytest.raises(ValueError, match="pallas_block"):
        spatial.check_spatial_compat(m.module.__class__(ngf=8, n_blocks=1, pallas_block=True),
                                     _mesh(2, 2))
    with pytest.raises(ValueError, match="W-tile count"):
        spatial.shard_hw(torch.zeros(1, 8, 9, 1), _mesh(2, 2))


# --- training reads sp_w_devices as JAX does -----------------------------------


@pytest.mark.parametrize("sp", [1, 2], ids=["unsharded", "sp2"])
def test_training_ignores_sp_w_devices(sp, caplog):
    """JAX's training builds its mesh from ``dp_devices`` and
    ``sp_devices`` alone (``train/loop.py:135-143``): a 1-step state built
    with ``sp_w_devices=2`` has the mesh and the losses of the one built
    without it (H-sharded over ``sp_devices``, or unsharded), and one log
    line says the flag is not used."""
    import logging

    from ircolor_tpu_torch.parallel.mesh import shard_batch
    from ircolor_tpu_torch.train.state import create_train_state
    from ircolor_tpu_torch.train.step import METRIC_KEYS, make_train_step

    caplog.set_level(logging.INFO)
    rng = np.random.RandomState(0)
    batch = shard_batch({"ir": rng.rand(2, 32, 32, 1).astype(np.float32) * 2 - 1,
                         "rgb": rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1},
                        [CPU] * sp if sp > 1 else CPU)
    out = {}
    for w in (1, 2):
        cfg = Config(img_size=32, batch_size=2, ngf=8, n_blocks=1, lambda_perc=0.0,
                     batch_transport="float", sp_devices=sp, sp_w_devices=w)
        state = create_train_state(cfg, steps_per_epoch=10, device="cpu")
        _, m = make_train_step(cfg, None)(state, batch)
        out[w] = (state.g.spatial_mesh, [float(m[k]) for k in METRIC_KEYS])
    assert out[2] == out[1]
    assert out[1][0] == (None if sp == 1 else [CPU] * 2)
    assert caplog.text.count("sp_w_devices=2 is not used by training") == 1
