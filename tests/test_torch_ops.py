"""The port's plain-torch ops and metrics against ``ircolor_tpu.ops`` /
``ircolor_tpu.eval.metrics`` on the same numpy inputs, in float32."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ircolor_tpu.eval import metrics as jmetrics
from ircolor_tpu.ops import blurpool as jblur
from ircolor_tpu.ops import norm as jnorm
from ircolor_tpu.ops.padding import pad2d as jpad2d
from ircolor_tpu.ops.quant import quantize_weight_per_channel as jquantize
from ircolor_tpu.ops.resize import bilinear_align_corners as jresize

from ircolor_tpu_torch.eval import metrics
from ircolor_tpu_torch.ops import blurpool, norm
from ircolor_tpu_torch.ops.padding import pad2d
from ircolor_tpu_torch.ops.quant import quantize_weight_per_channel
from ircolor_tpu_torch.ops.resize import bilinear_align_corners
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("pad_type", ["reflect", "replicate", "zero"])
@pytest.mark.parametrize("pad", [1, 3, (1, 2, 3, 0)])
def test_pad2d_matches_jax(pad_type, pad):
    x = _x((2, 7, 9, 3))
    got = pad2d(torch.from_numpy(x), pad, pad_type).numpy()
    want = np.asarray(jpad2d(jnp.asarray(x), pad, pad_type))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["instance_norm", "instance_norm_onepass", "instance_norm_stats"])
def test_instance_norm_forms_match_jax(fn):
    x = _x((2, 12, 10, 5), seed=1) * 3.0 + 1.5
    got = getattr(norm, fn)(torch.from_numpy(x))
    want = getattr(jnorm, fn)(jnp.asarray(x))
    if fn == "instance_norm_stats":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 15, 17, 3), (1, 12, 20, 40)])
def test_blur_downsample_matches_jax(shape):
    x = _x(shape, seed=2)
    got = blurpool.blur_downsample(torch.from_numpy(x)).numpy()
    want = np.asarray(jblur.blur_downsample(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 8), (1, 5, 7, 3), (1, 6, 10, 40)])
def test_blur_upsample_aa_matches_jax(shape):
    x = _x(shape, seed=3)
    got = blurpool.blur_upsample_aa(torch.from_numpy(x)).numpy()
    want = np.asarray(jblur.blur_upsample_aa(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("c", [3, 40])
@pytest.mark.parametrize("out_hw", [(17, 21), (8, 10), (4, 23)])
def test_bilinear_align_corners_matches_jax(c, out_hw):
    x = _x((2, 8, 10, c), seed=4)
    got = bilinear_align_corners(torch.from_numpy(x), out_hw).numpy()
    want = np.asarray(jresize(jnp.asarray(x), out_hw))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_weight_quantization_matches_jax():
    k = _x((3, 3, 16, 24), seed=5) * 0.1
    k[..., 3] = 0.0  # an all-zero channel takes the amax floor
    q, s = quantize_weight_per_channel(torch.from_numpy(k))
    jq, js = jquantize(jnp.asarray(k))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)


def _u8_batch(rng, shape):
    return rng.randint(0, 256, size=shape).astype(np.uint8)


@pytest.mark.parametrize("hw", [(32, 40), (7, 9)])
def test_batched_metrics_match_jax(hw):
    rng = np.random.RandomState(6)
    pred = _u8_batch(rng, (3, *hw, 3)).astype(np.float32) / 255.0
    gt = _u8_batch(rng, (3, *hw, 3)).astype(np.float32) / 255.0
    gt[1] = pred[1]  # identical image: MSE 0, PSNR inf, SSIM 1
    got = metrics.batched_metrics(torch.from_numpy(pred), torch.from_numpy(gt))
    want = jmetrics.batched_metrics(jnp.asarray(pred), jnp.asarray(gt))
    for key in ("mae", "mse", "ssim"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, err_msg=key)
    gp, wp = got["psnr"].numpy(), np.asarray(want["psnr"])
    assert math.isinf(gp[1]) and math.isinf(wp[1])
    np.testing.assert_allclose(gp[[0, 2]], wp[[0, 2]], atol=1e-4)
    assert got["mse"][1] == 0.0
    np.testing.assert_allclose(got["ssim"][1].item(), 1.0, atol=1e-6)


def test_quantize_and_compute_metrics_match_jax():
    rng = np.random.RandomState(7)
    x = rng.rand(2, 9, 11, 3).astype(np.float32) * 1.4 - 0.2
    np.testing.assert_array_equal(
        metrics.quantize_to_uint8_01(torch.from_numpy(x)).numpy(),
        np.asarray(jmetrics.quantize_to_uint8_01(jnp.asarray(x))),
    )
    p = rng.rand(16, 20, 3).astype(np.float32)
    g = rng.rand(16, 20, 3).astype(np.float32)
    got = metrics.compute_metrics(p, g)
    want = jmetrics.compute_metrics(p, g)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert math.isinf(metrics.compute_metrics(p, p)[2])
