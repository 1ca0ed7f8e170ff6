"""Spatial test mode at every height the JAX package runs, and the named
error of ``.msgpack`` generator weights, on the CPU.

JAX asks only that the image height divide by the H-shard count
(``ircolor_tpu/eval/runner.py:227-232``): its stride-2 stages may leave a
shard an odd number of rows, or shards of unequal heights, and its fused
blocks stay off where the bottleneck's rows do not divide
(``ircolor_tpu/models/generator.py:245``). The port's shard-aware ops take
such shards: each stride-2 stage gives shard k the output rows r with 2r
among its input rows (``parallel.spatial.stride2_heights``), every op
finds a shard's global rows from the heights of the shards before it, and
the upsample is cut as the skip's shards.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.models import generator as tgen
from ircolor_tpu_torch.ops import blurpool, padding, resize
from ircolor_tpu_torch.parallel import spatial
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _mesh(n):
    return [torch.device("cpu")] * n


def _split(x, heights):
    return list(x.split(list(heights), dim=1))


@pytest.mark.parametrize("heights", [[3, 2, 3, 2], [2, 1, 3, 2], [5, 4], [1, 2, 3]])
def test_shard_aware_ops_take_unequal_shards(heights):
    """On shards of unequal and odd heights, bit for bit the unsharded op's
    rows: the halo slabs of every pad at r = 1 and 3 (a halo reaching past
    a 1-row neighbour too), the blur-pool (shard k keeps the rows r with 2r
    among its rows), the AA upsample cut as a skip's shards, and the
    bilinear fix-up across shards where the planes differ."""
    rng = np.random.RandomState(sum(heights))
    hh = sum(heights)
    x = torch.from_numpy(rng.randn(2, hh, 9, 4).astype(np.float32))
    xs = _split(x, heights)
    starts = np.cumsum([0, *heights])
    for r in (1, 3):
        for pad in spatial.PADS:
            full = padding.pad2d(x, r, pad)
            for i, slab in enumerate(padding.pad2d_spatial(xs, r, pad)):
                assert torch.equal(slab, full[:, starts[i] : starts[i + 1] + 2 * r]), (r, pad, i)
    down = blurpool.blur_downsample_spatial(xs)
    assert [d.shape[1] for d in down] == spatial.stride2_heights(heights)
    assert torch.equal(spatial.gather_h(down), blurpool.blur_downsample(x))
    # x as the skip of the stage below it: the upsample of that stage's
    # output, cut as x's shards (rows 2 · ceil(H / 2) against H).
    low = blurpool.blur_downsample(x)
    lows = _split(low, spatial.stride2_heights(heights))
    want = blurpool.blur_upsample_aa(low)
    if want.shape[1] == hh:
        ups = blurpool.blur_upsample_aa_spatial(lows, out_heights=heights)
    else:
        ups = resize.bilinear_align_corners_spatial(
            blurpool.blur_upsample_aa_spatial(lows), heights, x.shape[2] + 1)
        want = resize.bilinear_align_corners(want, (hh, x.shape[2] + 1))
    assert [u.shape[1] for u in ups] == heights
    assert torch.equal(spatial.gather_h(ups), want)
    assert torch.equal(spatial.gather_h(blurpool.blur_upsample_aa_spatial(xs)),
                       blurpool.blur_upsample_aa(x))


def test_heights_that_leave_a_shard_no_row_raise_naming_the_limit():
    """Shard heights through the two stride-2 stages; a height whose
    bottleneck cannot give each shard a row raises and says so, as does
    one that does not divide."""
    assert spatial.check_stage_heights(24, 4, 2) == [[6] * 4, [3] * 4, [2, 1, 2, 1]]
    assert spatial.check_stage_heights(20, 4, 2) == [[5] * 4, [3, 2, 3, 2], [2, 1, 1, 1]]
    with pytest.raises(ValueError, match="every shard needs a row of the 3"):
        spatial.check_stage_heights(12, 4, 2)
    with pytest.raises(ValueError, match="divide"):
        spatial.check_stage_heights(22, 4, 2)
    g = tgen.ResnetUNetGenerator(ngf=8, n_blocks=1).eval()
    g.spatial_mesh = _mesh(4)
    with torch.inference_mode(), pytest.raises(ValueError, match="no row"):
        g(spatial.shard_h(torch.zeros(1, 12, 16, 1), g.spatial_mesh))


@pytest.mark.parametrize("h", [24, 20])
def test_spatial_generator_runs_the_heights_jax_runs(eight_cpu_devices, h):
    """H = 24 and 20 over 4 shards (bottleneck shards of 2, 1, 2, 1 and 2,
    1, 1, 1 rows), W 32, ngf 16, 2 blocks, f32: the port's spatial forward
    against the JAX generator under its spatial mesh (traced under
    ``jax.jit``) and against the port's unsharded forward, atol 2e-4 (the
    bound of ``test_spatial_generator_matches_jax_and_unsharded``)."""
    from ircolor_tpu.config import Config as JConfig
    from ircolor_tpu.models.wrapper import generator_from_config as jgen_from_config
    from ircolor_tpu.parallel.mesh import replicated_sharding
    from ircolor_tpu.parallel.spatial import make_spatial_mesh, spatial_sharding

    from ircolor_tpu_torch.compat import state_dict_from_flax

    jm = jgen_from_config(JConfig(img_size=32, n_blocks=2, ngf=16, pallas_norm_blur=False,
                                  pallas_head=False))
    ir = np.random.RandomState(h).rand(2, h, 32, 1).astype(np.float32) * 2 - 1
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ir[:1]))["params"]
    mesh = make_spatial_mesh(4)
    spat = jm.clone(spatial_mesh=mesh)
    sh = spatial_sharding(mesh)
    want = np.asarray(jax.jit(lambda p, x: spat.apply({"params": p}, x), out_shardings=sh)(
        jax.device_put(params, replicated_sharding(mesh)), jax.device_put(jnp.asarray(ir), sh)))

    g = tgen.ResnetUNetGenerator(ngf=16, n_blocks=2)
    g.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)), strict=False)
    g.eval()
    with torch.inference_mode():
        one = g(torch.from_numpy(ir)).numpy()
        g.spatial_mesh = _mesh(4)
        outs = g(spatial.shard_h(torch.from_numpy(ir), g.spatial_mesh))
    assert [o.shape[1] for o in outs] == [h // 4] * 4
    got = spatial.gather_h(outs).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, one, atol=2e-4)


def test_run_test_spatial_at_a_height_of_unequal_stage_shards(kaist_tree, tmp_path):
    """``run_test(device="cpu")`` with ``sp_devices=4`` at H = 24 (shards of
    2, 1, 2, 1 rows at the bottleneck) against one device on the same tree
    and weights: the same count, |ΔPSNR| < 0.01 dB, |ΔSSIM| < 1e-4."""
    from ircolor_tpu_torch.eval.runner import run_test

    root, _ = kaist_tree
    base = dict(mode="test", img_size=24, test_batch_size=4, ngf=8, n_blocks=1,
                test_roots=(str(root / "set02"),), topk=2, num_workers=2,
                save_comparisons=False)
    s1 = run_test(Config(output_dir=str(tmp_path / "one"), **base), device="cpu")
    s4 = run_test(Config(output_dir=str(tmp_path / "sp"), sp_devices=4, **base), device="cpu")
    assert s4["count"] == s1["count"] > 0
    assert abs(s4["mean_psnr"] - s1["mean_psnr"]) < 0.01
    assert abs(s4["mean_ssim"] - s1["mean_ssim"]) < 1e-4


def test_msgpack_generator_weights_raise_a_named_error(tmp_path):
    """``IRColorizationModel.load_weights`` on a ``.msgpack`` file raises
    ``NotImplementedError`` naming the queue item that ports the format,
    before it reads the file."""
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    path = tmp_path / "netG_best.msgpack"
    path.write_bytes(b"\x81\xa6params\x80")
    m = IRColorizationModel(Config(img_size=32, ngf=8, n_blocks=1), "cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md, Queue 1 item 2"):
        m.load_weights(str(path))
