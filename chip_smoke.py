#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's serving and training steps on one NVIDIA
H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU path):

1. Build every CUDA kernel from ``ircolor_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together) and print the card.
2. Hold each serving kernel against its plain PyTorch version at the
   flagship shapes (32×512×640, ngf=64); time both, and a PyTorch library
   call of the same function where there is one, with CUDA events. Also
   the int8 conv of the int8 route outside the fused blocks at every site
   of a batch-1 forward and at the batch-32 up2 legs of configuration (b)
   below (bit-exact; beside ``torch._int_mm`` over an im2col), and the
   int8 head (4q) at 32×512×640×64 (bit-exact).
2b. The same for the block backward kernels (dgrad in both launch forms,
   wgrad with and without the normalize on load) at the flagship training
   bottleneck (8×128×160×256, k 3×3×256×256), beside cuDNN's bf16
   ``conv2d_input`` / ``conv2d_weight`` of the reflect-padded conv.
3. Drive ``make_infer_fn`` + ``IRColorizationModel`` from
   ``configs/flagship_512x640.json`` (bf16, 512×640, ngf 64, 9 blocks,
   random weights from a seed) on synthetic uint16 IR / uint8 GT:
   3 batches of 32 with the int8 default (a forward launches 18 int8 block
   convs, 2 blur tails, 1 head), with ``quant_int8=False`` (18/2/1 float),
   and with ``quant_head`` + ``quant_fixed_u2`` (configuration (b): 18
   block convs, 2 tails, 2 int8 up2 conv legs, 1 int8 head); then batch 1,
   frame by frame with a synchronize after each (the b1 latency), int8
   (configuration (a): 24 int8 conv launches a forward, no other kernel)
   and float (no kernel). The launch counts are set to 0 just before each
   run and read just after.
4. A step through the kernels against the same step with every kernel
   wrapper swapped for its plain version: batch 2 (the small-batch band
   routes everything through the kernels), int8 and float, configuration
   (a) at batch 1 and configuration (b) at batch 32.
5. The training step of the same config (``mode="train"``: bf16, 512×640,
   batch 8, random G/D weights and random VGG tower from seed 0):
   ``create_train_state`` + ``make_train_step`` on synthetic batches, one
   warm-up step and 3 timed ones; each step must launch 18 block convs,
   18 dgrads and 18 wgrads and nothing else. Prints frames/s, peak memory
   and a ``torch.profiler`` breakdown of one more step.
6. The generator gradient of one batch through the kernel backward
   (``fused_wg``) against the plain-torch + cuDNN backward (``"xla"``):
   identical losses, per-block weight gradients within 1e-2 relative L2,
   and the kernel route repeating bit for bit.
5b. One training step with ``pallas_norm_blur_train`` and
   ``pallas_head_train`` on (2 tails and 1 float head a step, with their
   hand-assembled backward); then the G gradient of one batch, every
   parameter finite and present, against the same gradient with the tails'
   and head's forwards on their plain versions (1e-2 relative L2).

Prints a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FLAGSHIP = REPO / "configs" / "flagship_512x640.json"
B, H, W, NGF = 32, 512, 640, 64
TRAIN_B = 8
SEED = 0
# Dense H100 SXM peaks (NVIDIA's data sheet) for the bound column.
PEAK_BF16, PEAK_INT8, PEAK_F32, PEAK_BYTES = 989e12, 1979e12, 67e12, 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: float, nbytes: float, peak: float = PEAK_BF16) -> tuple[float, str]:
    """(least ms, what bounds it): operations over the peak for their type,
    or bytes moved (each input read once, each output written once) over
    the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_kernels(torch, results: list) -> None:
    """Phase 2: every kernel against its plain version at flagship shapes."""
    from ircolor_tpu_torch.kernels import LAUNCHES, blur, head, resblock
    from ircolor_tpu_torch.ops.norm import instance_norm_stats
    from ircolor_tpu_torch.ops.quant import _QCLIP, quantize_weight_per_channel

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    before = dict(LAUNCHES)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    def bf16_err(got, want):
        return float((got.float() - want.float()).abs().max())

    def bf16_mean_err(got, want):
        return float((got.float() - want.float()).abs().mean())

    # bf16 block conv (#2): conv1 form (raw input) and conv2 form
    # (normalize + ReLU on load) at the bottleneck, 32×128×160×256 → 256.
    # Tolerance: 2 bf16 ulps at the output's largest magnitude (both round
    # the same f32 sum, accumulated in another order), and 1e-3 relative on
    # the IN moments.
    hb, wb, cb = H // 4, W // 4, NGF * 4
    x = randn(B, hb, wb, cb).to(torch.bfloat16)
    k = randn(3, 3, cb, cb, scale=0.05).to(torch.bfloat16)
    m0, i0 = instance_norm_stats(x)
    errs, times, ptimes = [], [], []
    for label, args in (("raw", ()), ("norm-on-load", (m0, i0))):
        got = resblock.conv3x3_reflect_fused(x, k, *args)
        want = resblock.conv3x3_reflect_fused_plain(x, k, *args)
        scale = float(want[0].float().abs().max())
        err = bf16_err(got[0], want[0])
        tol = 2 * 2.0**-8 * scale
        merr = float((got[1] - want[1]).abs().max() / want[1].abs().max().clamp(min=1e-6))
        ierr = float(((got[2] - want[2]) / want[2]).abs().max())
        log(f"[conv3x3_reflect_fused {label}] max|d|={err:.4g} mean|d|="
            f"{bf16_mean_err(got[0], want[0]):.3g} tol={tol:.4g} "
            f"mean rel={merr:.3g} inv rel={ierr:.3g} (tol 1e-3)")
        if not (err <= tol and merr <= 1e-3 and ierr <= 1e-3):
            raise AssertionError(f"conv3x3_reflect_fused {label} disagrees with its plain version")
        errs.append(err)
        times.append(cuda_time_ms(lambda: resblock.conv3x3_reflect_fused(x, k, *args), 10))
        ptimes.append(cuda_time_ms(lambda: resblock.conv3x3_reflect_fused_plain(x, k, *args), 3, 1))
        log(f"    kernel {times[-1]:.3f} ms  plain {ptimes[-1]:.3f} ms")
    cudnn_ms = cuda_time_ms(
        lambda: torch.nn.functional.conv2d(
            torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect"),
            k.permute(3, 2, 0, 1)), 10)
    log(f"    (for scale: cuDNN bf16 reflect-pad + conv alone {cudnn_ms:.3f} ms)")
    act = B * hb * wb * cb * 2
    b_ms, b_by = bound(2 * B * hb * wb * 9 * cb * cb, 2 * act + 9 * cb * cb * 2 + B * cb * 16)
    results.append(dict(name="conv3x3_reflect_fused", route="cuda",
                        source="ircolor_tpu_torch/csrc/resblock.cu",
                        replaces="ircolor_tpu/ops/pallas_resblock.py:280",
                        max_abs_err=max(errs), ms=sum(times) / 2, plain_ms=sum(ptimes) / 2,
                        bound_ms=b_ms, bound_by=b_by, library_ms=cudnn_ms))

    # int8 block conv (#1): conv1 (per-sample 127/amax) and conv2 (fixed
    # 127/6 grid after normalize + ReLU). Bound: ≤ 2.5 quant steps, where a
    # step is one int8 input step through the channel's largest weight
    # (sc[b, co]·127), and ≤ 1e-3 of elements differing by more than one
    # bf16 ulp.
    kq, sw = quantize_weight_per_channel(k)
    amax = x.abs().amax(dim=(1, 2, 3)).float().clamp(min=1e-12)
    sc1 = ((amax / 127.0)[:, None] * sw[None, :]).contiguous()
    sc2 = ((_QCLIP / 127.0) * sw[None, :]).expand(B, -1).contiguous()
    cases = (("conv1", sc1, dict(qscale=(127.0 / amax).contiguous())),
             ("conv2", sc2, dict(mean=m0, inv=i0)))
    errs, times, ptimes = [], [], []
    for label, sc, kw in cases:
        got = resblock.conv3x3_reflect_fused_q(x, kq, sc, **kw)
        want = resblock.conv3x3_reflect_fused_q_plain(x, kq, sc, **kw)
        d = (got[0].float() - want[0].float()).abs()
        step = (sc * 127.0)[:, None, None, :]
        steps = float((d / step).max())
        ulp = want[0].float().abs() * 2.0**-8
        frac = float((d > ulp).float().mean())
        log(f"[conv3x3_reflect_fused_q {label}] max|d|={float(d.max()):.4g} "
            f"= {steps:.3g} quant steps (tol 2.5), mean|d|={float(d.mean()):.3g}, "
            f"differing {frac:.3g} (tol 1e-3)")
        if not (steps <= 2.5 and frac <= 1e-3):
            raise AssertionError(f"conv3x3_reflect_fused_q {label} disagrees with its plain version")
        errs.append(float(d.max()))
        times.append(cuda_time_ms(lambda: resblock.conv3x3_reflect_fused_q(x, kq, sc, **kw), 10))
        ptimes.append(cuda_time_ms(lambda: resblock.conv3x3_reflect_fused_q_plain(x, kq, sc, **kw), 2, 1))
        log(f"    kernel {times[-1]:.3f} ms  plain {ptimes[-1]:.3f} ms")
    # No stock int8 convolution in PyTorch: library_ms is null.
    b_ms, b_by = bound(2 * B * hb * wb * 9 * cb * cb,
                       2 * act + 9 * cb * cb + B * cb * 4 * 3, PEAK_INT8)
    results.append(dict(name="conv3x3_reflect_fused_q", route="cuda",
                        source="ircolor_tpu_torch/csrc/resblock.cu",
                        replaces="ircolor_tpu/ops/pallas_resblock.py:1385",
                        max_abs_err=max(errs), ms=sum(times) / 2, plain_ms=sum(ptimes) / 2,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del x

    # norm_relu_blur_down (#3) at both down-stage tails. Same additions in
    # the same order: tolerance 1 bf16 ulp at the output's largest value.
    errs, times, ptimes, bounds = [], [], [], []
    for hh, ww, cc in ((H, W, NGF * 2), (H // 2, W // 2, NGF * 4)):
        xt = randn(B, hh, ww, cc).to(torch.bfloat16)
        mt, it = instance_norm_stats(xt)
        got = blur.norm_relu_blur_down_pallas(xt, mt, it)
        want = blur.norm_relu_blur_down_plain(xt, mt, it)
        err, tol = bf16_err(got, want), 2.0**-8 * float(want.float().abs().max())
        log(f"[norm_relu_blur_down {hh}x{ww}x{cc}] max|d|={err:.4g} "
            f"mean|d|={bf16_mean_err(got, want):.3g} tol={tol:.4g}")
        if err > tol:
            raise AssertionError("norm_relu_blur_down disagrees with its plain version")
        errs.append(err)
        times.append(cuda_time_ms(lambda: blur.norm_relu_blur_down_pallas(xt, mt, it), 20))
        ptimes.append(cuda_time_ms(lambda: blur.norm_relu_blur_down_plain(xt, mt, it), 5))
        log(f"    kernel {times[-1]:.3f} ms  plain {ptimes[-1]:.3f} ms")
        n_in, n_out = B * hh * ww * cc, B * (hh // 2) * (ww // 2) * cc
        bounds.append(bound(3 * n_in + 18 * n_out, 2 * (n_in + n_out) + B * cc * 8, PEAK_F32))
        del xt
    # No single PyTorch call computes normalize + ReLU + blur-pool: null.
    results.append(dict(name="norm_relu_blur_down", route="cuda",
                        source="ircolor_tpu_torch/csrc/blur.cu",
                        replaces="ircolor_tpu/ops/pallas_blur.py:218",
                        max_abs_err=max(errs), ms=sum(times), plain_ms=sum(ptimes),
                        bound_ms=sum(b for b, _ in bounds), bound_by=bounds[0][1],
                        library_ms=None))

    # 7×7 head (#4), 32×512×640×64 → 3. f32 sums in another order, rounded
    # to bf16: tolerance 2 bf16 ulps at the output's largest magnitude.
    xt = randn(B, H, W, NGF).to(torch.bfloat16)
    kh = randn(7, 7, NGF, 3, scale=0.02).to(torch.bfloat16)
    mt, it = instance_norm_stats(xt)
    got = head.conv7x7_head_pallas(xt, mt, it, kh)
    want = head.conv7x7_head_plain(xt, mt, it, kh)
    err, tol = bf16_err(got, want), 2 * 2.0**-8 * float(want.float().abs().max())
    log(f"[conv7x7_head] max|d|={err:.4g} mean|d|={bf16_mean_err(got, want):.3g} tol={tol:.4g}")
    if err > tol:
        raise AssertionError("conv7x7_head disagrees with its plain version")
    ms = cuda_time_ms(lambda: head.conv7x7_head_pallas(xt, mt, it, kh), 10)
    pms = cuda_time_ms(lambda: head.conv7x7_head_plain(xt, mt, it, kh), 5)
    # Library yardstick: cuDNN's bf16 7×7 conv of the reflect-padded,
    # normalized input (the normalize and the pad made outside the timing).
    zp = torch.nn.functional.pad(
        torch.relu((xt.float() - mt[:, None, None, :]) * it[:, None, None, :])
        .to(torch.bfloat16).permute(0, 3, 1, 2), (3, 3, 3, 3), mode="reflect")
    lib_ms = cuda_time_ms(lambda: torch.nn.functional.conv2d(zp, kh.permute(3, 2, 0, 1)), 10)
    del zp
    log(f"    kernel {ms:.3f} ms  plain {pms:.3f} ms  cuDNN 7x7 conv alone {lib_ms:.3f} ms")
    b_ms, b_by = bound(2 * B * H * W * 49 * NGF * 3, B * H * W * (NGF + 3) * 2 + 49 * NGF * 3 * 2)
    results.append(dict(name="conv7x7_head", route="cuda",
                        source="ircolor_tpu_torch/csrc/head.cu",
                        replaces="ircolor_tpu/ops/pallas_head.py:286",
                        max_abs_err=err, ms=ms, plain_ms=pms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))

    # int8 head (#4q) at the same shape. The plain version takes the same
    # IEEE steps on exact integer sums: tolerance 0 (bit for bit).
    got = head.conv7x7_head_pallas(xt, mt, it, kh, quant=True)
    want = head.conv7x7_head_q_plain(xt, mt, it, kh)
    err = bf16_err(got, want)
    log(f"[conv7x7_head_q] bit-exact: {bool(torch.equal(got, want))} max|d|={err:.4g} (tol 0)")
    if not torch.equal(got, want):
        raise AssertionError("conv7x7_head_q disagrees with its plain version")
    del got, want
    ms = cuda_time_ms(lambda: head.conv7x7_head_pallas(xt, mt, it, kh, quant=True), 10)
    pms = cuda_time_ms(lambda: head.conv7x7_head_q_plain(xt, mt, it, kh), 1, 1)
    log(f"    kernel {ms:.3f} ms  plain {pms:.3f} ms  (no stock int8 conv in PyTorch)")
    b_ms, b_by = bound(2 * B * H * W * 49 * NGF * 3,
                       B * H * W * (NGF + 3) * 2 + 49 * NGF * 3 + B * NGF * 8, PEAK_INT8)
    results.append(dict(name="conv7x7_head_q", route="cuda",
                        source="ircolor_tpu_torch/csrc/head.cu",
                        replaces="ircolor_tpu/ops/pallas_head.py:445",
                        max_abs_err=err, ms=ms, plain_ms=pms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del xt
    torch.cuda.empty_cache()
    check_conv_int8(torch, results, randn)
    # These launches were comparisons, not the main path: leave the counts
    # as they were.
    LAUNCHES.update(before)


# The int8 conv's sites: (label, launches per forward, B, H, W, Cin, Cout,
# padding, epilogue). Configuration (a), batch 1 at 512×640: down1, down2,
# the 18 unfused block convs, the two legs of up1 and of up2 (leg a writes
# f32, leg b adds it and the bias and writes bf16). Configuration (b): the
# fixed-scale up2 legs at batch 32.
INT8_SITES_A = (
    ("down1", 1, 1, H, W, NGF, 2 * NGF, "zero", "bias"),
    ("down2", 1, 1, H // 2, W // 2, 2 * NGF, 4 * NGF, "zero", "bias"),
    ("block", 18, 1, H // 4, W // 4, 4 * NGF, 4 * NGF, "reflect", "bias"),
    ("up1 leg a", 1, 1, H // 2, W // 2, 4 * NGF, 2 * NGF, "zero", "f32"),
    ("up1 leg b", 1, 1, H // 2, W // 2, 2 * NGF, 2 * NGF, "zero", "addend"),
    ("up2 leg a", 1, 1, H, W, 2 * NGF, NGF, "zero", "f32"),
    ("up2 leg b", 1, 1, H, W, NGF, NGF, "zero", "addend"),
)
INT8_SITES_B = (
    ("up2 leg a", 1, B, H, W, 2 * NGF, NGF, "zero", "f32"),
    ("up2 leg b", 1, B, H, W, NGF, NGF, "zero", "addend"),
)


def im2col_int8(torch, xq, pad: str):
    """(B·H·W, 9·C) int8 columns of the padded input, tap-major, for the
    library yardstick ``torch._int_mm`` (built outside its timing)."""
    b, h, w, c = xq.shape
    xp = torch.zeros((b, h + 2, w + 2, c), dtype=torch.int8, device=xq.device)
    xp[:, 1:-1, 1:-1] = xq
    if pad == "reflect":
        xp[:, 0], xp[:, -1] = xp[:, 2].clone(), xp[:, -3].clone()
        xp[:, :, 0], xp[:, :, -1] = xp[:, :, 2].clone(), xp[:, :, -3].clone()
    cols = torch.empty((b, h, w, 9, c), dtype=torch.int8, device=xq.device)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        cols[:, :, :, tap] = xp[:, dy : dy + h, dx : dx + w]
    return cols.reshape(b * h * w, 9 * c)


def check_conv_int8(torch, results: list, randn) -> None:
    """Phase 2, the int8 conv: each site against its plain version (the
    exact integer sums, then the same epilogue steps: tolerance 0), timed
    beside ``torch._int_mm`` over an im2col (the int32 GEMM alone). The
    row's numbers are one configuration-(a) forward: each site times its
    launches per forward, summed."""
    from ircolor_tpu_torch.kernels import conv_int8

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    for config, sites in (("a", INT8_SITES_A), ("b", INT8_SITES_B)):
        for label, per_fwd, bb, hh, ww, cin, cout, pad, form in sites:
            xq = torch.randint(-127, 128, (bb, hh, ww, cin), device=dev, generator=gen,
                               dtype=torch.int8)
            wq = torch.randint(-127, 128, (3, 3, cin, cout), device=dev, generator=gen,
                               dtype=torch.int8)
            sc = torch.rand(bb, cout, device=dev, generator=gen) * 1e-4
            kw = dict(pad=pad)
            out_bytes = 2
            if form == "f32":
                kw["out_dtype"], out_bytes = torch.float32, 4
            else:
                kw["bias"] = randn(cout)
            if form == "addend":
                kw["addend"] = randn(bb, hh, ww, cout)
            got = conv_int8.conv3x3_int8(xq, wq, sc, **kw)
            want = conv_int8.conv3x3_int8_plain(xq, wq, sc, **kw)
            exact = bool(torch.equal(got, want))
            del got, want
            ms = cuda_time_ms(lambda: conv_int8.conv3x3_int8(xq, wq, sc, **kw), 20)
            pms = cuda_time_ms(lambda: conv_int8.conv3x3_int8_plain(xq, wq, sc, **kw), 1, 1)
            cols = im2col_int8(torch, xq, pad)
            wmat = wq.reshape(9 * cin, cout).t().contiguous().t()
            lib = cuda_time_ms(lambda: torch._int_mm(cols, wmat), 10)
            del cols
            npix = bb * hh * ww
            nbytes = (npix * cin + 9 * cin * cout + bb * cout * 4 + npix * cout * out_bytes
                      + (cout * 4 if "bias" in kw else 0) + (npix * cout * 4 if form == "addend" else 0))
            ops = 2 * npix * 9 * cin * cout
            b_ms, b_by = bound(ops, nbytes, PEAK_INT8)
            log(f"[conv3x3_int8 ({config}) {label} {bb}x{hh}x{ww}x{cin}->{cout} {pad}, {form}] "
                f"bit-exact: {exact} (tol 0); kernel {ms:.4f} ms  plain {pms:.3f} ms  "
                f"_int_mm over im2col {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by}), x{per_fwd} a forward")
            if not exact:
                raise AssertionError(f"conv3x3_int8 {label} disagrees with its plain version")
            if config == "a":
                row["ms"] += per_fwd * ms
                row["plain_ms"] += per_fwd * pms
                row["library_ms"] += per_fwd * lib
                row["bound_ms"] += per_fwd * b_ms
                row["ops_ms"] += per_fwd * ops / PEAK_INT8 * 1e3
                row["bytes_ms"] += per_fwd * nbytes / PEAK_BYTES * 1e3
            del xq, kw
            torch.cuda.empty_cache()
    log(f"    one (a) forward's 24 launches: kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
        f"_int_mm {row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms")
    results.append(dict(name="conv3x3_int8", route="cuda",
                        source="ircolor_tpu_torch/csrc/conv_int8.cu",
                        replaces="ircolor_tpu/ops/quant.py:93",
                        max_abs_err=0.0, ms=row["ms"], plain_ms=row["plain_ms"],
                        bound_ms=row["bound_ms"],
                        bound_by="operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes",
                        library_ms=row["library_ms"]))


def check_bwd_kernels(torch, results: list) -> None:
    """Phase 2b: the block backward kernels against their plain versions at
    the flagship training bottleneck, 8×128×160×256, k 3×3×256×256.

    Tolerances: bf16 outputs within 2 bf16 ulps at the output's largest
    magnitude (both round the same f32 sums, taken in another order); the
    dgrad statistics within 1e-3 of the largest |stat|; dk within 1e-3 of
    max|dk| (f32 sums over 163,840 pixels in another order)."""
    from ircolor_tpu_torch.kernels import LAUNCHES, resblock
    from ircolor_tpu_torch.ops.norm import instance_norm_stats

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    before = dict(LAUNCHES)
    bb, hb, wb, cb = TRAIN_B, H // 4, W // 4, NGF * 4

    def bf16(scale=1.0):
        return (torch.randn(bb, hb, wb, cb, device=dev, generator=gen) * scale).to(torch.bfloat16)

    def small(scale):
        return torch.randn(bb, cb, device=dev, generator=gen) * scale

    def rel(got, want):
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())

    g, raw2, raw1, x = bf16(), bf16(), bf16(), bf16()
    k = (torch.randn(3, 3, cb, cb, device=dev, generator=gen) * 0.05).to(torch.bfloat16)
    m2, i2 = instance_norm_stats(raw2)
    m1, i1 = instance_norm_stats(raw1)
    gm, gy = small(0.01), small(0.01)
    act = bb * hb * wb * cb * 2
    flops = 2 * bb * hb * wb * 9 * cb * cb

    # dgrad: launch 1 (ReLU mask + stats, dy emitted once to check it) and
    # launch 2 (residual add).
    errs, times, ptimes, bounds = [], [], [], []
    forms = (("mask_stats", (g, raw2, raw1, k, m2, i2, gm, gy), dict(mask_stats=(m1, i1))),
             ("residual", (raw1, raw2, g, k, m1, i1, gm, gy), {}))
    for label, args, kw in forms:
        got = resblock.conv3x3_dgrad_fused(*args, **kw)
        want = resblock.conv3x3_dgrad_fused_plain(*args, **kw)
        ulps = float((got[0].float() - want[0].float()).abs().max()
                     / (2.0**-8 * want[0].float().abs().max()))
        dy_err = float((got[1].float() - want[1].float()).abs().max())
        srel = rel(got[2], want[2]) if kw else 0.0
        log(f"[conv3x3_dgrad_fused {label}] max|d| = {ulps:.3g} bf16 ulps (tol 2), "
            f"dy max|d| {dy_err:.3g}, stats rel {srel:.3g} (tol 1e-3)")
        if not (ulps <= 2 and srel <= 1e-3 and dy_err <= 2.0**-8 * float(want[1].float().abs().max())):
            raise AssertionError(f"conv3x3_dgrad_fused {label} disagrees with its plain version")
        errs.append(float((got[0].float() - want[0].float()).abs().max()))
        del got, want
        times.append(cuda_time_ms(
            lambda: resblock.conv3x3_dgrad_fused(*args, emit_dy=False, **kw), 10))
        ptimes.append(cuda_time_ms(
            lambda: resblock.conv3x3_dgrad_fused_plain(*args, emit_dy=False, **kw), 3, 1))
        log(f"    kernel {times[-1]:.3f} ms  plain {ptimes[-1]:.3f} ms")
        bounds.append(bound(flops, 4 * act + 9 * cb * cb * 2 + bb * cb * 4 * 8))
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    w_oihw = k.permute(3, 2, 0, 1).contiguous()
    g_nchw = g.permute(0, 3, 1, 2)
    lib = cuda_time_ms(lambda: torch.nn.grad.conv2d_input(xp.shape, w_oihw, g_nchw), 10)
    log(f"    (for scale: cuDNN bf16 conv2d_input of the reflect-padded conv {lib:.3f} ms)")
    results.append(dict(name="conv3x3_dgrad_fused", route="cuda",
                        source="ircolor_tpu_torch/csrc/resblock_bwd.cu",
                        replaces="ircolor_tpu/ops/pallas_resblock.py:692",
                        max_abs_err=max(errs), ms=sum(times) / 2, plain_ms=sum(ptimes) / 2,
                        bound_ms=sum(b for b, _ in bounds) / 2, bound_by=bounds[0][1],
                        library_ms=lib))

    # wgrad: conv2's (Z = relu(IN(raw1)) on load) and conv1's (Z = x).
    errs, times, ptimes = [], [], []
    forms = (("znorm", (raw1, g, raw2, m2, i2, gm, gy), dict(znorm=(m1, i1))),
             ("raw", (x, raw1, raw2, m2, i2, gm, gy), {}))
    for label, args, kw in forms:
        got = resblock.conv3x3_wgrad_fused(*args, **kw)
        want = resblock.conv3x3_wgrad_fused_plain(*args, **kw)
        err = rel(got, want)
        log(f"[conv3x3_wgrad_fused {label}] max|d|/max|dk| = {err:.3g} (tol 1e-3)")
        if err > 1e-3:
            raise AssertionError(f"conv3x3_wgrad_fused {label} disagrees with its plain version")
        errs.append(float((got - want).abs().max()))
        times.append(cuda_time_ms(lambda: resblock.conv3x3_wgrad_fused(*args, **kw), 10))
        ptimes.append(cuda_time_ms(lambda: resblock.conv3x3_wgrad_fused_plain(*args, **kw), 3, 1))
        log(f"    kernel {times[-1]:.3f} ms  plain {ptimes[-1]:.3f} ms")
    lib = cuda_time_ms(lambda: torch.nn.grad.conv2d_weight(xp, w_oihw.shape, g_nchw), 10)
    log(f"    (for scale: cuDNN bf16 conv2d_weight of the reflect-padded conv {lib:.3f} ms)")
    b_ms, b_by = bound(flops, 3 * act + 9 * cb * cb * 4 + bb * cb * 4 * 6)
    results.append(dict(name="conv3x3_wgrad_fused", route="cuda",
                        source="ircolor_tpu_torch/csrc/resblock_bwd.cu",
                        replaces="ircolor_tpu/ops/pallas_resblock.py:956",
                        max_abs_err=max(errs), ms=sum(times) / 2, plain_ms=sum(ptimes) / 2,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    LAUNCHES.update(before)
    del g, raw2, raw1, x, xp
    torch.cuda.empty_cache()


def synthetic_batches(np, n: int, b: int):
    """IR-like frames (smooth gradients + a warm blob, a little sensor
    noise) with the RGB a fixed colormap of the IR, as uint16 / uint8 — the
    pattern of ``ircolor_tpu/data/synthetic.py``, made here with numpy."""
    rng = np.random.RandomState(SEED)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for _ in range(n):
        ir = np.empty((b, H, W, 1), np.uint16)
        gt = np.empty((b, H, W, 3), np.uint8)
        for j in range(b):
            phase = rng.uniform(0, 2 * np.pi)
            f = 0.5 + 0.4 * np.sin(xx / W * 4 * np.pi + phase) * np.cos(yy / H * 2 * np.pi)
            cx, cy = rng.randint(0, W), rng.randint(0, H)
            f = f + 0.5 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * (H / 4) ** 2))
            f = np.clip(f + rng.normal(0, 0.01, f.shape), 0, 1).astype(np.float32)
            ir[j, :, :, 0] = np.rint(f * 65535)
            rgb = np.stack([np.clip(1.5 * f - 0.2, 0, 1), np.clip(1 - np.abs(f - 0.5) * 2, 0, 1),
                            np.clip(0.9 - f, 0, 1)], axis=2)
            gt[j] = np.rint(rgb * 255)
        out.append((ir, gt))
    return out


def serving_config(**overrides):
    from ircolor_tpu_torch.config import Config

    return Config.from_json(FLAGSHIP.read_text()).replace(mode="test", seed=SEED, **overrides)


def expect_launches(label: str, counts: dict, per_forward: dict, forwards: int) -> None:
    """Fail unless ``counts`` is ``per_forward`` × ``forwards`` for every
    kernel (0 for the kernels ``per_forward`` does not name)."""
    want = {name: per_forward.get(name, 0) * forwards for name in counts}
    log(f"[{label}] launches over {forwards} forwards: {counts}")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")


def serve(torch, np, label: str, overrides: dict, quant: bool, per_forward: dict,
          results_counts: dict) -> float:
    """Phase 3 at batch 32: returns frames/s over 3 batches."""
    from ircolor_tpu_torch.eval.runner import make_infer_fn
    from ircolor_tpu_torch.kernels import LAUNCHES, reset_launches
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    cfg = serving_config(**overrides)
    if (cfg.resolved_hw, cfg.resolved_test_batch_size, cfg.resolved_quant_int8) != ((H, W), B, quant):
        raise AssertionError(f"{FLAGSHIP.name} no longer resolves to {H}x{W} b{B} int8={quant}")
    model = IRColorizationModel(cfg, "cuda")
    infer = make_infer_fn(model.module)
    batches = [
        (torch.from_numpy(ir).cuda(), torch.from_numpy(gt).cuda())
        for ir, gt in synthetic_batches(np, 3, B)
    ]
    pred, m = infer(*batches[0])  # warm-up: cuDNN algorithm picks
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    outs = [infer(ir, gt) for ir, gt in batches]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    fps = len(batches) * B / dt
    expect_launches(f"serve {label}", counts, per_forward, len(batches))
    check_outputs(torch, f"serve {label}", outs, B)
    mm = {k: float(v.mean()) for k, v in outs[-1][1].items()}
    log(f"[serve {label}] {fps:.2f} frames/s (3 batches of {B} at {H}x{W}, "
        f"{1e3 * dt / 3:.1f} ms per batch); last-batch metrics {mm}")
    results_counts[label] = counts
    del model, batches, outs
    torch.cuda.empty_cache()
    return fps


def check_outputs(torch, label: str, outs, b: int) -> None:
    for pred, m in outs:
        if pred.shape != (b, H, W, 3) or pred.dtype != torch.uint8:
            raise AssertionError(f"{label}: prediction {pred.shape} {pred.dtype}")
        for key, v in m.items():
            if v.shape != (b,) or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{label}: metric {key} not finite: {v}")


B1_FRAMES, B1_WARMUP = 64, 4


def latency_b1(torch, np, label: str, quant: bool, per_forward: dict, results_counts: dict):
    """Phase 3 at batch 1: one frame at a time through ``make_infer_fn``,
    a synchronize after each; returns (mean, median) ms per frame over
    ``B1_FRAMES`` frames after ``B1_WARMUP`` warm-up frames."""
    from ircolor_tpu_torch.eval.runner import make_infer_fn
    from ircolor_tpu_torch.kernels import LAUNCHES, reset_launches
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    cfg = serving_config(test_batch_size=1, quant_int8=None if quant else False)
    if (cfg.resolved_hw, cfg.resolved_test_batch_size, cfg.resolved_quant_int8) != ((H, W), 1, quant):
        raise AssertionError(f"{FLAGSHIP.name} at batch 1 no longer resolves to int8={quant}")
    model = IRColorizationModel(cfg, "cuda")
    infer = make_infer_fn(model.module)
    ir, gt = (torch.from_numpy(a).cuda() for a in synthetic_batches(np, 1, B1_FRAMES)[0])
    frames = [(ir[j : j + 1], gt[j : j + 1]) for j in range(B1_FRAMES)]
    for f in frames[:B1_WARMUP]:
        infer(*f)
    torch.cuda.synchronize()
    reset_launches()
    times, outs = [], []
    for f in frames:
        t0 = time.perf_counter()
        outs.append(infer(*f))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    counts = dict(LAUNCHES)
    expect_launches(f"b1 {label}", counts, per_forward, len(frames))
    check_outputs(torch, f"b1 {label}", outs, 1)
    mean, med = sum(times) / len(times), sorted(times)[len(times) // 2]
    log(f"[b1 {label}] {mean:.3f} ms per frame mean, {med:.3f} median, {min(times):.3f} min "
        f"({len(frames)} frames after {B1_WARMUP} warm-up, synchronize after each)")

    def four_frames():
        for f in frames[:4]:
            infer(*f)

    profile_window(torch, f"b1 {label} profile", four_frames, "4 frames", top=8)
    results_counts[f"b1 {label}"] = counts
    del model, outs
    torch.cuda.empty_cache()
    return mean, med


class plain_kernels:
    """Context: the named kernel wrappers (all by default) swapped for their
    plain versions, so whatever calls them runs no kernel."""

    def __init__(self, names=None):
        from ircolor_tpu_torch.kernels import blur, conv_int8, head, resblock
        from ircolor_tpu_torch.ops import quant

        def head_plain(x, mean, inv, kernel, *, quant=False):
            plain = head.conv7x7_head_q_plain if quant else head.conv7x7_head_plain
            return plain(x, mean, inv, kernel)

        swaps = {
            "conv3x3_reflect_fused": (resblock, resblock.conv3x3_reflect_fused_plain),
            "conv3x3_reflect_fused_q": (resblock, resblock.conv3x3_reflect_fused_q_plain),
            "norm_relu_blur_down_pallas": (blur, blur.norm_relu_blur_down_plain),
            "conv7x7_head_pallas": (head, head_plain),
            "conv3x3_int8": (quant, conv_int8.conv3x3_int8_plain),
        }
        self.swaps = {n: swaps[n] for n in (names or swaps)}

    def __enter__(self):
        self.saved = {n: getattr(mod, n) for n, (mod, _) in self.swaps.items()}
        for n, (mod, fn) in self.swaps.items():
            setattr(mod, n, fn)

    def __exit__(self, *exc):
        for n, (mod, _) in self.swaps.items():
            setattr(mod, n, self.saved[n])


def kernel_vs_plain_route(torch, np, label: str, overrides: dict, batch: int,
                          per_forward: dict, exact_with_plain: tuple = (),
                          uint8_bound: bool = True) -> None:
    """Phase 4: one step through the kernels against the same step with
    every kernel wrapper swapped for its plain version. The kernel route
    also runs twice and must repeat bit for bit (the kernels' statistics
    are deterministic). With only the ``exact_with_plain`` wrappers on
    their plain versions (kernels whose plain version they equal bit for
    bit) the step must repeat the kernel route bit for bit too.
    ``uint8_bound=False`` leaves the uint8-image bound out and keeps the
    metric budget (see the call for why)."""
    from ircolor_tpu_torch.eval.runner import make_infer_fn
    from ircolor_tpu_torch.kernels import LAUNCHES
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    cfg = serving_config(test_batch_size=batch, **overrides)
    model = IRColorizationModel(cfg, "cuda")
    infer = make_infer_fn(model.module)
    ir, gt = (torch.from_numpy(a).cuda() for a in synthetic_batches(np, 1, batch)[0])
    before = dict(LAUNCHES)
    pred_k, m_k = infer(ir, gt)
    ran = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    pred_k2, _ = infer(ir, gt)
    repeat = bool(torch.equal(pred_k, pred_k2))
    del pred_k2
    same_swapped = True
    if exact_with_plain:
        with plain_kernels(exact_with_plain):
            pred_s, _ = infer(ir, gt)
        same_swapped = bool(torch.equal(pred_k, pred_s))
        log(f"[kernel vs plain route, {label}, b{batch}] with only {', '.join(exact_with_plain)} "
            f"on their plain versions: bit-identical {same_swapped} (tol 0)")
        del pred_s
    with plain_kernels():
        mid = dict(LAUNCHES)
        pred_p, m_p = infer(ir, gt)
        if LAUNCHES != mid:
            raise AssertionError("the plain route launched a kernel")
    LAUNCHES.update(before)
    d = (pred_k.int() - pred_p.int()).abs()
    mean_d = float(d.float().mean())
    hist = [float((d <= j).float().mean()) for j in (0, 1, 2, 4)]
    dpsnr = float((m_k["psnr"] - m_p["psnr"]).abs().max())
    dssim = float((m_k["ssim"] - m_p["ssim"]).abs().max())
    log(f"[kernel vs plain route, {label}, b{batch}] kernels run {ran}; "
        f"repeat bit-identical: {repeat}; uint8 max|d|={int(d.max())} "
        f"mean|d|={mean_d:.4f}; share with |d|<=0/1/2/4: "
        f"{', '.join(f'{h:.4f}' for h in hist)}; |dPSNR|={dpsnr:.5f} dB |dSSIM|={dssim:.6f}")
    expect_launches(f"kernel route {label}", ran, per_forward, 1)
    if not (repeat and same_swapped):
        raise AssertionError(f"{label}: kernel-route runs differ (repeat {repeat}, "
                             f"new kernels on plain versions {same_swapped})")
    # Bound: the repository's int8 serving budget on the metrics (0.02 dB
    # PSNR, 0.002 SSIM per image), and on the uint8 image a mean difference
    # of at most 2 levels with 95% of values within 4. Each kernel alone
    # matches its plain version bit for bit or to one bf16 ulp (phase 2);
    # here the conv statistics, summed in another order, move the next
    # conv's normalize (and, for int8, its rounding) by an ulp here and
    # there, and 9 blocks of a random-weight network compound that, while
    # the bf16 output grid makes one ulp of the prediction 1-2 uint8 levels.
    if not (dpsnr <= 0.02 and dssim <= 0.002 and (not uint8_bound or (mean_d <= 2.0 and hist[3] >= 0.95))):
        raise AssertionError(f"{label}: kernel route disagrees with the plain route")
    del model, pred_k, pred_p
    torch.cuda.empty_cache()


def _train_setup(torch, np, n_batches: int = 4, **overrides):
    """The flagship config in train mode (with ``overrides``), its state on
    the card, the random VGG tower, the step, and ``n_batches`` synthetic
    batches of 8."""
    from ircolor_tpu_torch.config import Config
    from ircolor_tpu_torch.losses.vgg import load_vgg16
    from ircolor_tpu_torch.train.state import create_train_state
    from ircolor_tpu_torch.train.step import make_train_step

    cfg = Config.from_json(FLAGSHIP.read_text()).replace(mode="train", seed=SEED, **overrides)
    if (cfg.resolved_hw, cfg.batch_size, cfg.compute_dtype) != ((H, W), TRAIN_B, "bf16"):
        raise AssertionError(f"{FLAGSHIP.name} no longer resolves to {H}x{W} b{TRAIN_B} bf16 training")
    state = create_train_state(cfg, steps_per_epoch=1000, device="cuda")
    vgg = load_vgg16(None, SEED, torch.bfloat16).cuda()
    batches = [{"ir": torch.from_numpy(ir).cuda(), "rgb": torch.from_numpy(gt).cuda()}
               for ir, gt in synthetic_batches(np, n_batches, TRAIN_B)]
    return cfg, state, vgg, make_train_step(cfg, vgg), batches


def profile_window(torch, label: str, run, what: str, top: int = 12, table: bool = False) -> None:
    """torch.profiler over ``run()``: device time by kernel and the busy
    share of the window's wall time; with ``table`` the full operator table
    goes to stderr."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    def dev_us(evt):
        return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and dev_us(e) > 0]
    kernels.sort(key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    log(f"[{label}] {what}: wall {wall_ms:.1f} ms (profiler on), device busy "
        f"{busy_ms:.1f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}; "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in kernels[:top]:
        log(f"    {dev_us(e) / 1e3:8.2f} ms  x{e.count:<4d} {e.key[:90]}")
    if table:
        print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60),
              file=sys.stderr, flush=True)


def train_step_phase(torch, np) -> tuple[dict, object]:
    """Phase 5: the flagship training step; returns (launch counts of the 3
    timed steps, the setup for phase 6)."""
    from ircolor_tpu_torch.kernels import LAUNCHES, reset_launches
    from ircolor_tpu_torch.train.loop import _check_loss_sanity
    from ircolor_tpu_torch.train.step import METRIC_KEYS

    cfg, state, vgg, step, batches = _train_setup(torch, np)
    step(state, batches[0])  # warm-up: cuDNN algorithm picks, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    metrics = [step(state, b)[1] for b in batches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    n = len(batches) - 1
    expect_launches("train (forwards = steps)", counts, TRAIN_PER_STEP, n)
    for i, m in enumerate(metrics):
        vals = {k: float(m[k]) for k in METRIC_KEYS}
        _check_loss_sanity(vals, cfg, 1, i + 1)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] 512x640 b{TRAIN_B} bf16: {n * TRAIN_B / dt:.2f} frames/s "
        f"({1e3 * dt / n:.1f} ms per step), peak memory {peak_gb:.2f} GiB; last losses "
        + ", ".join(f"{k}={float(metrics[-1][k]):.4f}" for k in METRIC_KEYS))
    profile_window(torch, "train profile", lambda: step(state, batches[1]), "one step", table=True)
    LAUNCHES.update(counts)
    return counts, (cfg, state, vgg, batches[0])


TRAIN_PER_STEP = {"conv3x3_reflect_fused": 18, "conv3x3_dgrad_fused": 18,
                  "conv3x3_wgrad_fused": 18}


def g_grads(torch, cfg, state, vgg, batch, params):
    """(losses, d total_G / d params) of one batch: the G phase of the train
    step (D's parameters take no gradient)."""
    from ircolor_tpu_torch.losses.gan import hinge_g_loss
    from ircolor_tpu_torch.train.step import _decode_transport, composite_g_losses

    g, d = state.g, state.d
    ir, rgb = _decode_transport(batch["ir"], batch["rgb"])
    d.requires_grad_(False)
    try:
        fake = g(ir)
        loss_gan = hinge_g_loss(d(torch.cat([ir, fake.float()], dim=-1)))
        total, m = composite_g_losses(cfg, vgg, fake, rgb, loss_gan)
        out = torch.autograd.grad(total, params, allow_unused=True)
    finally:
        d.requires_grad_(True)
    return torch.stack([v.detach() for v in m.values()]), out


class deterministic:
    """Context: deterministic cuDNN and PyTorch algorithms."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        self.torch.backends.cudnn.deterministic = True
        self.torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        self.torch.use_deterministic_algorithms(False)
        self.torch.backends.cudnn.deterministic = False


def bwd_vs_xla(torch, setup) -> None:
    """Phase 6: the G gradient of one batch through the kernel backward
    against the "xla" backward (plain torch + cuDNN), from the same state.
    The forwards are the same kernels, so the losses must be bit-identical;
    each resnet-block weight gradient must agree within 1e-2 relative L2;
    the kernel route must repeat bit for bit (deterministic algorithms on
    for the rest of the network)."""
    from ircolor_tpu_torch.kernels import LAUNCHES

    cfg, state, vgg, batch = setup
    g = state.g
    weights = [w for blk in g.resblocks for w in (blk.conv_block[1].weight, blk.conv_block[5].weight)]
    before = dict(LAUNCHES)

    def grads(bwd):
        for blk in g.resblocks:
            blk.pallas_block_bwd = bwd
        return g_grads(torch, cfg, state, vgg, batch, weights)

    try:
        with deterministic(torch):
            loss_k, grad_k = grads("fused_wg")
            loss_x, grad_x = grads("xla")
            loss_k2, grad_k2 = grads("fused_wg")
    finally:
        for blk in g.resblocks:
            blk.pallas_block_bwd = cfg.pallas_block_bwd
    LAUNCHES.update(before)
    rels = [float((a.float() - b.float()).norm() / b.float().norm()) for a, b in zip(grad_k, grad_x)]
    same_loss = bool(torch.equal(loss_k, loss_x))
    repeat = all(torch.equal(a, b) for a, b in zip(grad_k, grad_k2)) and bool(torch.equal(loss_k, loss_k2))
    log(f"[bwd vs xla] losses bit-identical: {same_loss}; per-block-weight relative L2 "
        f"max {max(rels):.3g} mean {sum(rels) / len(rels):.3g} (tol 1e-2); "
        f"kernel route repeats bit for bit: {repeat}")
    log("    " + " ".join(f"{r:.2e}" for r in rels))
    if not (same_loss and max(rels) <= 1e-2 and repeat):
        raise AssertionError("kernel backward disagrees with the xla backward")


def train_tail_head_phase(torch, np) -> dict:
    """Phase 5b: the training step with the fused tails and head on
    (``pallas_norm_blur_train``, ``pallas_head_train``) and their
    hand-assembled backward. One step must launch 2 tails and 1 float head
    besides the blocks' 18/18/18. Then the G gradient of one batch: every
    parameter finite and present — except the fused blocks' conv biases,
    which that route does not read (inert through instance norm; the JAX
    package gives them exact zeros) — and, against the same gradient with
    the tails' and head's forwards on their plain versions, within 1e-2
    relative L2 per parameter (the conv biases that feed an instance norm
    are left out of that: their gradient is rounding noise around 0).
    Returns the step's launch counts."""
    from ircolor_tpu_torch.kernels import LAUNCHES, reset_launches

    cfg, state, vgg, step, batches = _train_setup(
        torch, np, 2, pallas_norm_blur_train=True, pallas_head_train=True)
    step(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    step(state, batches[1])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    expect_launches("train, fused tails and head (forwards = steps)", counts,
                    {**TRAIN_PER_STEP, "norm_relu_blur_down": 2, "conv7x7_head": 1}, 1)
    log(f"[train, fused tails and head] one step {1e3 * dt:.1f} ms")
    names, params = zip(*state.g.named_parameters())
    with deterministic(torch):
        loss_k, grad_k = g_grads(torch, cfg, state, vgg, batches[0], params)
        with plain_kernels(("norm_relu_blur_down_pallas", "conv7x7_head_pallas")):
            mid = dict(LAUNCHES)
            loss_p, grad_p = g_grads(torch, cfg, state, vgg, batches[0], params)
            ran_plain = {k: LAUNCHES[k] - mid[k] for k in ("norm_relu_blur_down", "conv7x7_head")}
    LAUNCHES.update(counts)
    unused = {f"resblocks.{i}.conv_block.{j}.bias" for i in range(len(state.g.resblocks)) for j in (1, 5)}
    inert = {n for n in names if n.endswith(".bias") and n != "outc.1.bias"}
    rels, bad = {}, []
    for n, a, b in zip(names, grad_k, grad_p):
        if n in unused:
            if a is not None or b is not None:
                bad.append(f"{n}: a gradient on the fused block route")
            continue
        if a is None or b is None or not bool(torch.isfinite(a).all()):
            bad.append(f"{n}: no finite gradient")
            continue
        if n not in inert:
            rels[n] = float((a.float() - b.float()).norm() / b.float().norm())
    worst = max(rels, key=rels.get)
    log(f"[train, fused tails and head] G gradient: {len(names) - len(unused)} of {len(names)} "
        f"parameters finite and present ({len(unused)} fused-block biases unused); kernel vs "
        f"plain forwards of tails/head: relative L2 max {rels[worst]:.3g} ({worst}), mean "
        f"{sum(rels.values()) / len(rels):.3g} over {len(rels)} parameters (tol 1e-2); losses "
        f"max rel {float(((loss_k - loss_p).abs() / loss_p.abs().clamp(min=1e-12)).max()):.3g}; "
        f"plain route launched {ran_plain}")
    for n in ("inc.1.weight", "down1.0.weight", "down2.0.weight", "up2_conv.0.weight", "outc.1.weight"):
        log(f"    {n}: {rels[n]:.3g}")
    if bad or rels[worst] > 1e-2 or any(ran_plain.values()):
        raise AssertionError(f"train with fused tails and head: {bad or rels[worst]}")
    del state, vgg, batches
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    if not (REPO / "ircolor_tpu_torch").is_dir() or not FLAGSHIP.is_file():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    # Deterministic cuBLAS for phase 6 (read when the first handle is made).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from ircolor_tpu_torch.kernels import build

    # The plain versions are the f32 reference: no TF32 anywhere.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {len(build.SOURCES)} sources in {time.perf_counter() - t0:.1f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"    {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {smi}; torch {torch.__version__} CUDA {torch.version.cuda}")

    results: list = []
    check_kernels(torch, results)
    check_bwd_kernels(torch, results)
    counts: dict = {}
    blocks_tails_head = {"norm_relu_blur_down": 2, "conv7x7_head": 1}
    int8_default = {"conv3x3_reflect_fused_q": 18, **blocks_tails_head}
    float_default = {"conv3x3_reflect_fused": 18, **blocks_tails_head}
    config_a = {"conv3x3_int8": 24}
    config_b = {"conv3x3_reflect_fused_q": 18, "norm_relu_blur_down": 2, "conv3x3_int8": 2,
                "conv7x7_head_q": 1}
    opt_in = dict(quant_head=True, quant_fixed_u2=True)
    fps_int8 = serve(torch, np, "int8", {}, True, int8_default, counts)
    fps_float = serve(torch, np, "float", dict(quant_int8=False), False, float_default, counts)
    fps_b = serve(torch, np, "int8 (b)", opt_in, True, config_b, counts)
    lat_int8 = latency_b1(torch, np, "int8 (a)", True, config_a, counts)
    lat_float = latency_b1(torch, np, "float", False, {}, counts)
    kernel_vs_plain_route(torch, np, "int8", dict(quant_int8=True), 2, int8_default)
    kernel_vs_plain_route(torch, np, "float", dict(quant_int8=False), 2, float_default)
    kernel_vs_plain_route(torch, np, "int8 (a)", {}, 1, config_a, ("conv3x3_int8",))
    # (b) quantizes up2 and the head, with no instance norm after them: an
    # ulp of difference upstream (the block convs' IN moments, summed in
    # another order by the kernel and by its plain version) moves a value
    # across a rounding boundary of the fixed 127/6 grid and the output by
    # a whole quant step. The uint8 mean |d| of this whole-route comparison
    # measures that mode's rounding noise (2.07 levels at b32, random
    # weights; H100, 700 W), not the kernels: the route with only the int8
    # conv and the int8 head on their plain versions must repeat the kernel
    # route bit for bit, and the all-plain route stays within the metric
    # budget.
    kernel_vs_plain_route(torch, np, "int8 (b)", opt_in, B, config_b,
                          ("conv3x3_int8", "conv7x7_head_pallas"), uint8_bound=False)
    log(f"[serve] 512x640 b32: int8 {fps_int8:.2f} frames/s, float {fps_float:.2f} frames/s, "
        f"int8 (b) quant_head + quant_fixed_u2 {fps_b:.2f} frames/s")
    log(f"[serve] 512x640 b1 latency (mean / median ms per frame): int8 (a) "
        f"{lat_int8[0]:.3f} / {lat_int8[1]:.3f}, float {lat_float[0]:.3f} / {lat_float[1]:.3f}")
    counts["train"], setup = train_step_phase(torch, np)
    bwd_vs_xla(torch, setup)
    del setup
    torch.cuda.empty_cache()
    counts["train tails+head"] = train_tail_head_phase(torch, np)

    # launches: each kernel's count in the main-path run at the shape its
    # row is timed and bounded at — serving (int8 default) for the int8
    # block conv, tails and head; float serving (b32) for the bf16 block
    # conv; the training step (b8) for the backward kernels; configuration
    # (a) at batch 1 for the int8 conv; configuration (b) for the int8 head.
    main_run = {"conv3x3_reflect_fused_q": "int8", "norm_relu_blur_down": "int8",
                "conv7x7_head": "int8", "conv3x3_reflect_fused": "float",
                "conv3x3_dgrad_fused": "train", "conv3x3_wgrad_fused": "train",
                "conv3x3_int8": "b1 int8 (a)", "conv7x7_head_q": "int8 (b)"}
    for r in results:
        r["launches"] = counts[main_run[r["name"]]][r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
