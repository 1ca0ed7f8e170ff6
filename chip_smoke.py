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
   the int8 conv of the int8 route outside the fused blocks
   (``csrc/conv_fwd.cu``'s q-conv policy) at every site of a batch-1
   forward and at the batch-32 up2 legs of configuration (b) below
   (bit-exact and bit-exact on repeat at both N = 128 and 64, its reflect
   pass and GEMM timed apart, the IGMMA count and ptxas line of both
   instantiations: a spill fails the run; beside ``torch._int_mm`` over an
   im2col); its stride-2 form at the no_antialias down convs at b32
   (down1 512×640×64 → 256×320×128, down2 256×320×128 → 128×160×256:
   the phase pass and the GEMM timed apart, bit-exact, beside
   ``torch._int_mm`` over a stride-2 im2col), the float head (4, within 2
   bf16 ulps) and the int8 head (4q,
   bit-exact) at 32×512×640×64, both bit-exact on repeat, after every
   ``csrc/head.cu`` instantiation's ptxas line and ``HMMA`` / ``IMMA``
   count (a spill or none fails the run), beside cuDNN's 7×7 conv and
   ``torch._int_mm`` over an im2col, and the fused instance norm
   (kernel 11) at the 256² bottleneck of ``use_pallas`` serving,
   16×64×64×256: IN + ReLU and IN + residual in bf16 (1 bf16 ulp), IN +
   ReLU in f32 (1e-5), beside ``F.instance_norm``. The bf16 block conv
   (``csrc/conv_fwd.cu``, both forms bit-exact on repeat) also with its
   operand pass and GEMM timed apart, the GEMM's TFLOP/s, the ptxas lines
   and the ``HGMMA`` count of its SASS; the int8 block conv (the same
   GEMM on s8 operands after the int8 form of the pass; both forms within
   2.5 quant steps, the share not bit-identical logged, bit-exact on
   repeat) likewise, with its TOP/s and ``IGMMA`` count, beside
   ``torch._int_mm`` over an int8 im2col (the GEMM alone).
2b. The same for the block backward kernels (dgrad in both launch forms,
   wgrad with and without the normalize, bit-exact on repeat) at the
   flagship training bottleneck (8×128×160×256, k 3×3×256×256), beside
   cuDNN's bf16 ``conv2d_input`` / ``conv2d_weight`` of the reflect-padded
   conv (on channels-last operands, and as PRs 3-9 called them: the faster
   is the dgrad's library time); and both in the enc/dec segment modes at
   the b8 flagship segments (down1 512×640 128 → dz 64 with dy stored,
   down2 256×320 256 → 128, up1 256×320 128 → 384 and its two wgrad legs),
   beside the zero-pad conv's. For each wgrad
   form also its two launches timed apart (transform pass, GEMM with its
   TFLOP/s) and ptxas's register / spill line; for each dgrad form its
   launches (operand pass, fold lines, ``csrc/conv_fwd.cu``'s GEMM with
   its TFLOP/s), the GEMM instantiation's ptxas line and HGMMA count (every
   dgrad instantiation must issue ``wgmma`` and spill nothing).
2c. TPU kernels 7-10, which the JAX package leaves on no generator route
   and its tools call at the flagship stage shapes, with the flagship
   generator's weights (down2_conv, up1_conv, resblocks.0) at b32: the
   multi-input SAME conv with free IN stats (down2, 1 leg, zero halos;
   up1, 2 legs 256 + 128, no concat; a reflect leg at the bottleneck), the
   VALID conv with stats and with normalize on load, the VALID conv (v1,
   v2 preshift, v2 dxcat) at 32×130×162×256 → 256, and the blur-pool at
   32×512×640×128 and 32×256×320×256: each against its plain version, timed
   beside it and one cuDNN call, each conv form (``csrc/conv_fwd.cu``) also
   with its operand pass and GEMM timed apart. Then three compositions against the
   product route on the same inputs: (a) the d2 stage (kernel 7's free
   stats into kernel 3), (b) the u1 stage, (c) a ResnetBlock from kernel 9
   against kernel 2's. Then the slice's path once, with the counts set to 0
   before and read after (2 + 1 + 1 + 3 + 2 launches and the d2 tail).
   The product routes of phases 3-5c launch none of these kernels.
3. Drive ``make_infer_fn`` + ``IRColorizationModel`` from
   ``configs/flagship_512x640.json`` (bf16, 512×640, ngf 64, 9 blocks,
   random weights from a seed) on synthetic uint16 IR / uint8 GT:
   3 batches of 32 with the int8 default (a forward launches 18 int8 block
   convs, 2 blur tails, 1 head), with ``quant_int8=False`` (18/2/1 float),
   and with ``quant_head`` + ``quant_fixed_u2`` (configuration (b): 18
   block convs, 2 tails, 2 int8 up2 conv legs, 1 int8 head); then batch 1,
   frame by frame with a synchronize after each (the b1 latency), int8
   (configuration (a): 24 int8 conv launches a forward, no other kernel)
   and float (no kernel), each with a profile of 4 frames that lists the
   port's kernels' device time. Then 256×256 float at its test batch of 16, 12
   batches, without and with ``use_pallas`` in turns (without, with, with,
   without): with it a forward launches 9 + 9 kernel-11 launches and the
   down1 tail, no head and no block conv. The launch counts are set to 0
   just before each run and read just after.
4. A step through the kernels against the same step with every kernel
   wrapper swapped for its plain version: batch 2 (the small-batch band
   routes everything through the kernels), int8 and float, configuration
   (a) at batch 1, configuration (b) at batch 32, and ``use_pallas`` at
   256×256 b16.
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
5c. The training step with ``pallas_encdec_bwd`` (512×640 b8: 18 block
   convs, 18 + 3 dgrads and 18 + 3 wgrads a step), then its G gradient
   against the same with only the segments' dgrad/wgrad on their plain
   versions: losses bit-identical, ≤ 1e-2 relative L2 per parameter, the
   kernel route bit-exact on repeat. Then 256×256 b8 training without and
   with ``use_pallas`` (18 kernel-11 launches a step), and the latter's G
   gradient against the plain forwards (every used parameter finite and
   present, ≤ 1e-2 relative L2, bit-exact repeat).

7. The generator variants ``Config`` reaches, at the same full width:
   b32 serving of ``norm="batch"`` int8 (the int8 conv at all 24 sites a
   forward) and float (no kernel), ``no_antialias`` + ``no_antialias_up``
   int8 (18 int8 block convs and the head; the tails are off) and
   ``norm="batch"`` + ``no_antialias`` int8 (22 int8 conv launches and 2 of
   its stride-2 form a forward), each with frames/s and peak memory and
   held kernel route against plain route (phase 4's budget; the batch
   norms' running statistics calibrated on one batch first, so that the
   prediction is live); ``no_antialias``
   int8 at b1 (latency; down1 and down2 on the stride-2 form); training
   with ``remat`` at b8 (36 block convs a step: each block's forward and
   its recompute; the G gradient bit-identical to the step without
   ``remat``, peak memory beside phase 5's) and one ``norm="batch"``
   training step (no kernel; finite losses, every running statistic moved).

Prints a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
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

    # bf16 block conv (#2, csrc/conv_fwd.cu): conv1 form (raw input) and
    # conv2 form (normalize + ReLU on load) at the bottleneck,
    # 32×128×160×256 → 256. Tolerance: 2 bf16 ulps at the output's largest
    # magnitude (both round the same f32 sum, accumulated in another order),
    # 1e-3 relative on the IN moments, and a bit-exact repeat.
    hgmma = hgmma_count("conv_fwd")
    log(f"[conv GEMM] {hgmma} HGMMA instructions in the SASS of csrc/conv_fwd.cu")
    if hgmma == 0:
        raise AssertionError("the forward conv's GEMM issues no wgmma")
    hb, wb, cb = H // 4, W // 4, NGF * 4
    x = randn(B, hb, wb, cb).to(torch.bfloat16)
    k = randn(3, 3, cb, cb, scale=0.05).to(torch.bfloat16)
    m0, i0 = instance_norm_stats(x)
    errs, times, ptimes = [], [], []
    for label, args in (("raw", ()), ("norm-on-load", (m0, i0))):
        got = resblock.conv3x3_reflect_fused(x, k, *args)
        want = resblock.conv3x3_reflect_fused_plain(x, k, *args)
        again = resblock.conv3x3_reflect_fused(x, k, *args)
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        scale = float(want[0].float().abs().max())
        err = bf16_err(got[0], want[0])
        tol = 2 * 2.0**-8 * scale
        merr = float((got[1] - want[1]).abs().max() / want[1].abs().max().clamp(min=1e-6))
        ierr = float(((got[2] - want[2]) / want[2]).abs().max())
        log(f"[conv3x3_reflect_fused {label}] max|d|={err:.4g} mean|d|="
            f"{bf16_mean_err(got[0], want[0]):.3g} tol={tol:.4g} "
            f"mean rel={merr:.3g} inv rel={ierr:.3g} (tol 1e-3); repeat bit-exact {repeat}")
        if not (err <= tol and merr <= 1e-3 and ierr <= 1e-3 and repeat):
            raise AssertionError(f"conv3x3_reflect_fused {label} disagrees with its plain version")
        errs.append(err)
        del got, want, again
        times.append(cuda_time_ms(lambda: resblock.conv3x3_reflect_fused(x, k, *args), 10))
        parts = conv_parts(torch, "reflect", [x], [k], *args)
        ptimes.append(cuda_time_ms(lambda: resblock.conv3x3_reflect_fused_plain(x, k, *args), 3, 1))
        log(f"    kernel {times[-1]:.3f} ms  plain {ptimes[-1]:.3f} ms\n{parts}")
    cudnn_ms = cuda_time_ms(
        lambda: torch.nn.functional.conv2d(
            torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect"),
            k.permute(3, 2, 0, 1)), 10)
    log(f"    (for scale: cuDNN bf16 reflect-pad + conv alone {cudnn_ms:.3f} ms)")
    act = B * hb * wb * cb * 2
    b_ms, b_by = bound(2 * B * hb * wb * 9 * cb * cb, 2 * act + 9 * cb * cb * 2 + B * cb * 16)
    results.append(dict(name="conv3x3_reflect_fused", route="cuda",
                        source="ircolor_tpu_torch/csrc/conv_fwd.cu",
                        replaces="ircolor_tpu/ops/pallas_resblock.py:280",
                        max_abs_err=max(errs), ms=sum(times) / 2, plain_ms=sum(ptimes) / 2,
                        bound_ms=b_ms, bound_by=b_by, library_ms=cudnn_ms))

    # int8 block conv (#1, csrc/conv_fwd.cu: the int8 operand pass, then the
    # GEMM on s8 operands): conv1 (per-sample 127/amax) and conv2 (fixed
    # 127/6 grid after normalize + ReLU). Bound: ≤ 2.5 quant steps, where a
    # step is one int8 input step through the channel's largest weight
    # (sc[b, co]·127), and ≤ 1e-3 of elements differing by more than one
    # bf16 ulp; the IN moments within 1e-3 relative, as row 2's; and a
    # bit-exact repeat. The share of elements that are not
    # bit-identical to the plain version is logged (expected: 0).
    igmma = hgmma_by_kernel("conv_fwd").get("gemm n128 q-stats", 0)
    log(f"[int8 conv GEMM] {igmma} IGMMA instructions in the SASS of its instantiation")
    if igmma == 0:
        raise AssertionError("the int8 conv's GEMM issues no wgmma")
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
        again = resblock.conv3x3_reflect_fused_q(x, kq, sc, **kw)
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        d = (got[0].float() - want[0].float()).abs()
        step = (sc * 127.0)[:, None, None, :]
        steps = float((d / step).max())
        ulp = want[0].float().abs() * 2.0**-8
        frac = float((d > ulp).float().mean())
        nonid = float((got[0].view(torch.int16) != want[0].view(torch.int16)).float().mean())
        merr = float((got[1] - want[1]).abs().max() / want[1].abs().max().clamp(min=1e-6))
        ierr = float(((got[2] - want[2]) / want[2]).abs().max())
        log(f"[conv3x3_reflect_fused_q {label}] max|d|={float(d.max()):.4g} "
            f"= {steps:.3g} quant steps (tol 2.5), mean|d|={float(d.mean()):.3g}, "
            f"differing {frac:.3g} (tol 1e-3), not bit-identical {nonid:.3g}; "
            f"mean rel={merr:.3g} inv rel={ierr:.3g} (tol 1e-3); repeat bit-exact {repeat}")
        if not (steps <= 2.5 and frac <= 1e-3 and merr <= 1e-3 and ierr <= 1e-3 and repeat):
            raise AssertionError(f"conv3x3_reflect_fused_q {label} disagrees with its plain version")
        errs.append(float(d.max()))
        del got, want, again
        times.append(cuda_time_ms(lambda: resblock.conv3x3_reflect_fused_q(x, kq, sc, **kw), 10))
        parts = q_parts(torch, x, kq, sc, kw)
        ptimes.append(cuda_time_ms(lambda: resblock.conv3x3_reflect_fused_q_plain(x, kq, sc, **kw), 2, 1))
        log(f"    kernel {times[-1]:.3f} ms  plain {ptimes[-1]:.3f} ms\n{parts}")
    # The library yardstick: torch._int_mm over an int8 im2col of conv1's
    # reflect-padded quantized input (1.5 GB, built outside the timing) —
    # the int32 GEMM alone: no halo, quantize, dequant or stats.
    zq = resblock._q_pass(x, **cases[0][2])
    cols = im2col_int8(torch, zq[:, 1:-1, 1:-1].contiguous(), "reflect")
    wmat = kq.reshape(9 * cb, cb).t().contiguous().t()
    int_mm_ms = cuda_time_ms(lambda: torch._int_mm(cols, wmat), 10)
    log(f"    (the GEMM alone: torch._int_mm over an int8 im2col, {cols.numel() / 1e9:.2f} GB, "
        f"{int_mm_ms:.3f} ms)")
    del zq, cols
    b_ms, b_by = bound(2 * B * hb * wb * 9 * cb * cb,
                       2 * act + 9 * cb * cb + B * cb * 4 * 3, PEAK_INT8)
    results.append(dict(name="conv3x3_reflect_fused_q", route="cuda",
                        source="ircolor_tpu_torch/csrc/conv_fwd.cu",
                        replaces="ircolor_tpu/ops/pallas_resblock.py:1385",
                        max_abs_err=max(errs), ms=sum(times) / 2, plain_ms=sum(ptimes) / 2,
                        bound_ms=b_ms, bound_by=b_by, library_ms=int_mm_ms))
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

    # 7×7 head (#4), 32×512×640×64 → 3 (csrc/head.cu, both forms one
    # tensor-core kernel template). f32 sums in another order, rounded to
    # bf16: tolerance 2 bf16 ulps at the output's largest magnitude; a
    # repeat bit-exact (sums in a fixed order).
    check_head_build()
    xt = randn(B, H, W, NGF).to(torch.bfloat16)
    kh = randn(7, 7, NGF, 3, scale=0.02).to(torch.bfloat16)
    mt, it = instance_norm_stats(xt)
    got = head.conv7x7_head_pallas(xt, mt, it, kh)
    want = head.conv7x7_head_plain(xt, mt, it, kh)
    err, tol = bf16_err(got, want), 2 * 2.0**-8 * float(want.float().abs().max())
    repeat = torch.equal(head.conv7x7_head_pallas(xt, mt, it, kh), got)
    log(f"[conv7x7_head] max|d|={err:.4g} mean|d|={bf16_mean_err(got, want):.3g} tol={tol:.4g} "
        f"repeat bit-exact: {repeat} (plan {head._head_plan(B, H, W, NGF, False)})")
    if err > tol or not repeat:
        raise AssertionError("conv7x7_head disagrees with its plain version or its repeat")
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
    repeat = torch.equal(head.conv7x7_head_pallas(xt, mt, it, kh, quant=True), got)
    log(f"[conv7x7_head_q] bit-exact: {bool(torch.equal(got, want))} max|d|={err:.4g} (tol 0) "
        f"repeat bit-exact: {repeat} (plan {head._head_plan(B, H, W, NGF, True)})")
    if not torch.equal(got, want) or not repeat:
        raise AssertionError("conv7x7_head_q disagrees with its plain version or its repeat")
    del got, want
    ms = cuda_time_ms(lambda: head.conv7x7_head_pallas(xt, mt, it, kh, quant=True), 10)
    pms = cuda_time_ms(lambda: head.conv7x7_head_q_plain(xt, mt, it, kh), 1, 1)
    # The library yardstick, as rows 1 and the int8 conv have it:
    # torch._int_mm over an int8 im2col of the quantized, reflect-padded
    # input (49 taps x 64 channels a pixel, 32.9 GB, built outside the
    # timing) against the int8 weights with Cout padded from 3 to 8 (its
    # N must be a multiple of 8): the GEMM alone, no normalize, quantize
    # or dequant.
    q = torch.clamp(torch.round(head._normalize_relu(xt, mt, it) * (127.0 / _QCLIP)), max=127.0)
    qp = torch.nn.functional.pad(q.permute(0, 3, 1, 2), (3, 3, 3, 3), mode="reflect")
    qp = qp.permute(0, 2, 3, 1).to(torch.int8)
    del q
    cols = torch.empty((B * H * W, 49 * NGF), dtype=torch.int8, device=dev)
    for tap in range(49):
        dy, dx = divmod(tap, 7)
        cols[:, tap * NGF : (tap + 1) * NGF] = qp[:, dy : dy + H, dx : dx + W].reshape(-1, NGF)
    del qp
    kq8 = torch.zeros((49 * NGF, 8), dtype=torch.int8, device=dev)
    kq8[:, :3] = head._quantize_head_weight(kh)[0].reshape(49 * NGF, 3)
    wmat = kq8.t().contiguous().t()
    lib_ms = cuda_time_ms(lambda: torch._int_mm(cols, wmat), 5)
    del cols
    torch.cuda.empty_cache()
    log(f"    kernel {ms:.3f} ms  plain {pms:.3f} ms  torch._int_mm over the im2col (the GEMM "
        f"alone, N 8) {lib_ms:.3f} ms")
    b_ms, b_by = bound(2 * B * H * W * 49 * NGF * 3,
                       B * H * W * (NGF + 3) * 2 + 49 * NGF * 3 + B * NGF * 8, PEAK_INT8)
    results.append(dict(name="conv7x7_head_q", route="cuda",
                        source="ircolor_tpu_torch/csrc/head.cu",
                        replaces="ircolor_tpu/ops/pallas_head.py:445",
                        max_abs_err=err, ms=ms, plain_ms=pms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    del xt
    torch.cuda.empty_cache()
    check_conv_int8(torch, results, randn)
    check_conv_int8_s2(torch, results)
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


def im2col_int8(torch, xq, pad: str, stride: int = 1):
    """(B·Ho·Wo, 9·C) int8 columns of the padded input at ``stride``,
    tap-major, for the library yardstick ``torch._int_mm`` (built outside
    its timing)."""
    b, h, w, c = xq.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    xp = torch.zeros((b, h + 2, w + 2, c), dtype=torch.int8, device=xq.device)
    xp[:, 1:-1, 1:-1] = xq
    if pad == "reflect":
        xp[:, 0], xp[:, -1] = xp[:, 2].clone(), xp[:, -3].clone()
        xp[:, :, 0], xp[:, :, -1] = xp[:, :, 2].clone(), xp[:, :, -3].clone()
    cols = torch.empty((b, ho, wo, 9, c), dtype=torch.int8, device=xq.device)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        cols[:, :, :, tap] = xp[:, dy : dy + stride * (ho - 1) + 1 : stride,
                                dx : dx + stride * (wo - 1) + 1 : stride]
    return cols.reshape(b * ho * wo, 9 * c)


def check_conv_int8(torch, results: list, randn) -> None:
    """Phase 2, the int8 conv (``csrc/conv_fwd.cu``: the reflect pass where
    the site pads by reflection, then the GEMM's q-conv policy on s8
    operands): each site against its plain version (the exact integer
    sums, then the same epilogue steps: tolerance 0) and bit-exact on
    repeat, timed with its pass and GEMM apart, the GEMM also at the other
    N (64 / 128) where the site's channels allow it (bit-exact too), beside
    ``torch._int_mm`` over an im2col (the int32 GEMM alone). The row's
    numbers are one configuration-(a) forward: each site times its
    launches per forward, summed."""
    from ircolor_tpu_torch.kernels import conv_int8, resblock

    log(f"[int8 conv pass q8] ptxas {ptxas_lines('conv_fwd').get('pass q8', 'not built')}")
    check_gemm_build("int8 conv", ("q-conv",))
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
            repeat = bool(torch.equal(got, conv_int8.conv3x3_int8(xq, wq, sc, **kw)))
            ms = cuda_time_ms(lambda: conv_int8.conv3x3_int8(xq, wq, sc, **kw), 20)
            pms = cuda_time_ms(lambda: conv_int8.conv3x3_int8_plain(xq, wq, sc, **kw), 1, 1)
            # The launches apart: the reflect pass, the GEMM at the plan's N
            # and at the other N (held bit-exact too).
            plan = conv_int8._plan(bb, hh, ww, cin, cout, pad)
            src = conv_int8._pad(xq) if pad == "reflect" else xq
            tp = cuda_time_ms(lambda: conv_int8._pad(xq), 20) if pad == "reflect" else 0.0
            ekw = dict(bias=kw.get("bias"), addend=kw.get("addend"),
                       out_dtype=kw.get("out_dtype", torch.bfloat16))
            gemm_ms = {}
            for bn in (128, 64):
                if -(-cout // 64) * 64 % bn:
                    continue
                p = resblock._conv_plan(bb, hh, ww, (cin,), cout, pad, s8=True, bn=bn)
                kt = resblock._q_weights(wq, p)
                alt = conv_int8._gemm(src, kt, sc, p, **ekw)
                exact = exact and bool(torch.equal(alt, want))
                del alt
                gemm_ms[bn] = cuda_time_ms(lambda: conv_int8._gemm(src, kt, sc, p, **ekw), 20)
            del got, want, src
            cols = im2col_int8(torch, xq, pad)
            wmat = wq.reshape(9 * cin, cout).t().contiguous().t()
            lib = cuda_time_ms(lambda: torch._int_mm(cols, wmat), 10)
            del cols
            npix = bb * hh * ww
            nbytes = (npix * cin + 9 * cin * cout + bb * cout * 4 + npix * cout * out_bytes
                      + (cout * 4 if "bias" in kw else 0) + (npix * cout * 4 if form == "addend" else 0))
            ops = 2 * npix * 9 * cin * cout
            b_ms, b_by = bound(ops, nbytes, PEAK_INT8)
            other = " ".join(f"N={bn} {t:.4f} ms" for bn, t in gemm_ms.items() if bn != plan.bn)
            log(f"[conv3x3_int8 ({config}) {label} {bb}x{hh}x{ww}x{cin}->{cout} {pad}, {form}] "
                f"bit-exact: {exact} (tol 0), repeat bit-exact: {repeat}; kernel {ms:.4f} ms "
                f"= pass {tp:.4f} + GEMM N={plan.bn} {gemm_ms[plan.bn]:.4f} ms "
                f"({ops / gemm_ms[plan.bn] / 1e9:.1f} TOP/s, {plan.blocks} output blocks)"
                f"{'; other ' + other if other else ''}; plain {pms:.3f} ms; "
                f"_int_mm over im2col {lib:.4f} ms; bound {b_ms:.4f} ms ({b_by}), "
                f"x{per_fwd} a forward")
            if not (exact and repeat):
                raise AssertionError(f"conv3x3_int8 {label} disagrees with its plain version")
            if config == "a":
                row["ms"] += per_fwd * ms
                row["plain_ms"] += per_fwd * pms
                row["library_ms"] += per_fwd * lib
                row["bound_ms"] += per_fwd * b_ms
                row["ops_ms"] += per_fwd * ops / PEAK_INT8 * 1e3
                row["bytes_ms"] += per_fwd * nbytes / PEAK_BYTES * 1e3
            del xq, kw, ekw
            torch.cuda.empty_cache()
    log(f"    one (a) forward's 24 launches: kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
        f"_int_mm {row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms")
    results.append(dict(name="conv3x3_int8", route="cuda",
                        source="ircolor_tpu_torch/csrc/conv_fwd.cu",
                        replaces="ircolor_tpu/ops/quant.py:93",
                        max_abs_err=0.0, ms=row["ms"], plain_ms=row["plain_ms"],
                        bound_ms=row["bound_ms"],
                        bound_by="operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes",
                        library_ms=row["library_ms"]))


# The stride-2 form's sites: the no_antialias down convs at b32 (down1
# 512×640×64 → 256×320×128, down2 256×320×128 → 128×160×256), zero halos,
# + bias, bf16 out; a b32 forward of the norm="batch" + no_antialias route
# launches each once.
INT8_S2_SITES = (
    ("down1", B, H, W, NGF, 2 * NGF),
    ("down2", B, H // 2, W // 2, 2 * NGF, 4 * NGF),
)


def check_conv_int8_s2(torch, results: list) -> None:
    """Phase 2, the int8 conv's stride-2 form (``csrc/conv_fwd.cu``: the
    phase pass writes the input's four parity planes, then the q-conv GEMM
    runs six stages a chunk): each site against ``conv3x3_int8_plain(...,
    stride=2)`` (tolerance 0) and bit-exact on repeat, timed with the pass
    and the GEMM apart, the GEMM also at the other N, beside
    ``torch._int_mm`` over a stride-2 im2col (the GEMM alone); the
    instantiations' ptxas lines and IGMMA counts (a spill fails the run).
    The row sums the two sites: one b32 forward's stride-2 launches."""
    from ircolor_tpu_torch.kernels import conv_int8, resblock

    log(f"[int8 conv s2 phase pass] ptxas {ptxas_lines('conv_fwd').get('phase', 'not built')}")
    check_gemm_build("int8 conv s2", ("q-conv s2",))
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    for label, bb, hh, ww, cin, cout in INT8_S2_SITES:
        xq = torch.randint(-127, 128, (bb, hh, ww, cin), device=dev, generator=gen,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (3, 3, cin, cout), device=dev, generator=gen,
                           dtype=torch.int8)
        sc = torch.rand(bb, cout, device=dev, generator=gen) * 1e-4
        kw = dict(pad="zero", stride=2, bias=torch.randn(cout, device=dev, generator=gen))
        got = conv_int8.conv3x3_int8(xq, wq, sc, **kw)
        want = conv_int8.conv3x3_int8_plain(xq, wq, sc, **kw)
        exact = bool(torch.equal(got, want))
        repeat = bool(torch.equal(got, conv_int8.conv3x3_int8(xq, wq, sc, **kw)))
        ms = cuda_time_ms(lambda: conv_int8.conv3x3_int8(xq, wq, sc, **kw), 20)
        pms = cuda_time_ms(lambda: conv_int8.conv3x3_int8_plain(xq, wq, sc, **kw), 1, 1)
        ho, wo = conv_int8.out_hw(hh, ww, "zero", 2)
        plan = conv_int8._plan(bb, ho, wo, cin, cout, "zero", 2)
        src = conv_int8._phases(xq, "zero", ho, wo)
        tp = cuda_time_ms(lambda: conv_int8._phases(xq, "zero", ho, wo), 20)
        gemm_ms = {}
        for bn in (128, 64):
            p = resblock._conv_plan(bb, ho, wo, (cin,), cout, "zero", s8=True, bn=bn, stride=2)
            kt = resblock._q_weights(wq, p)
            alt = conv_int8._gemm(src, kt, sc, p, bias=kw["bias"])
            exact = exact and bool(torch.equal(alt, want))
            del alt
            gemm_ms[bn] = cuda_time_ms(lambda: conv_int8._gemm(src, kt, sc, p, bias=kw["bias"]), 20)
        del got, want, src
        cols = im2col_int8(torch, xq, "zero", 2)
        wmat = wq.reshape(9 * cin, cout).t().contiguous().t()
        lib = cuda_time_ms(lambda: torch._int_mm(cols, wmat), 10)
        del cols
        npix = bb * ho * wo
        nbytes = xq.numel() + 9 * cin * cout + bb * cout * 4 + cout * 4 + npix * cout * 2
        ops = 2 * npix * 9 * cin * cout
        b_ms, b_by = bound(ops, nbytes, PEAK_INT8)
        other = " ".join(f"N={bn} {t:.4f} ms" for bn, t in gemm_ms.items() if bn != plan.bn)
        log(f"[conv3x3_int8 s2 {label} {bb}x{hh}x{ww}x{cin}->{ho}x{wo}x{cout} zero] bit-exact: "
            f"{exact} (tol 0), repeat bit-exact: {repeat}; kernel {ms:.4f} ms = phase pass "
            f"{tp:.4f} + GEMM N={plan.bn} {gemm_ms[plan.bn]:.4f} ms "
            f"({ops / gemm_ms[plan.bn] / 1e9:.1f} TOP/s, {plan.blocks} output blocks); other {other}; "
            f"plain {pms:.3f} ms; _int_mm over a stride-2 im2col {lib:.4f} ms; bound {b_ms:.4f} ms "
            f"({b_by})")
        if not (exact and repeat):
            raise AssertionError(f"conv3x3_int8 s2 {label} disagrees with its plain version")
        row["ms"] += ms
        row["plain_ms"] += pms
        row["library_ms"] += lib
        row["bound_ms"] += b_ms
        row["ops_ms"] += ops / PEAK_INT8 * 1e3
        row["bytes_ms"] += nbytes / PEAK_BYTES * 1e3
        del xq, wq, kw
        torch.cuda.empty_cache()
    log(f"    one b32 forward's 2 stride-2 launches: kernel {row['ms']:.3f} ms, plain "
        f"{row['plain_ms']:.3f} ms, _int_mm {row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms")
    results.append(dict(name="conv3x3_int8_s2", route="cuda",
                        source="ircolor_tpu_torch/csrc/conv_fwd.cu",
                        replaces="ircolor_tpu/ops/quant.py:93",
                        max_abs_err=0.0, ms=row["ms"], plain_ms=row["plain_ms"],
                        bound_ms=row["bound_ms"],
                        bound_by="operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes",
                        library_ms=row["library_ms"]))


# csrc/conv_fwd.cu's epilogue policies, by their template number.
EPI_NAMES = ("stats", "store", "mask-stats", "residual", "dz", "q-stats", "q-conv")


def kernel_key(name: str) -> str:
    """A kernel of a library by its mangled name: "gemm nBN <policy>" for
    csrc/conv_fwd.cu's GEMM instantiations, "gemm" / "gemm swap" for the
    wgrad's ("... s2": the int8 conv's stride-2 form), "fold" (the dgrad's
    fold lines), "pass" (the operand pass), "pass q8" (its int8 form),
    "phase" (the stride-2 pass) or "head bf16 kK" / "head s8 kK" for
    csrc/head.cu's instantiations (K MMA K steps a staged unit; "multi":
    the one for C past 64 channels, several units a row)."""
    import re

    found = re.search(r"head_kernelILb(\d)ELi(\d+)ELb(\d)E", name)
    if found:
        multi = " multi" if found[3] == "1" else ""
        return f"head {'s8' if found[1] == '1' else 'bf16'} k{found[2]}{multi}"
    if "operand_pass" in name:
        return "pass q8" if "ILb1E" in name else "pass"
    if "phase_pass" in name:
        return "phase"
    if "ILb1E" in name:
        return "gemm swap"
    found = re.search(r"gemm_kernelILi(\d+)ELi(\d+)ELb(\d)E", name)
    if found:
        return f"gemm n{found[1]} {EPI_NAMES[int(found[2])]}{' s2' if found[3] == '1' else ''}"
    return "gemm" if "gemm" in name else "fold" if "fold" in name else "pass"


def ptxas_lines(source: str) -> dict:
    """ptxas's register / spill lines of ``csrc/<source>.cu``'s kernels,
    from this process's build, by ``kernel_key``."""
    from ircolor_tpu_torch.kernels import build

    out, name = {}, None
    for line in build.build_logs.get(source, "").splitlines():
        if "Compiling entry function" in line:
            name = kernel_key(line)
        elif name and ("registers" in line or "spill" in line):
            out[name] = (out.get(name, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


@functools.lru_cache
def hgmma_by_kernel(source: str, ops: tuple = ("HGMMA", "IGMMA")) -> dict:
    """Tensor-core instructions in the SASS of each kernel of
    ``csrc/<source>.cu``'s library, by ``kernel_key``: by default ``HGMMA``
    (bf16) and ``IGMMA`` (int8), the ``wgmma`` a GEMM must issue; the head
    counts ``mma.sync``'s ``HMMA`` and ``IMMA`` too."""
    import shutil

    from ircolor_tpu_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build._lib_path(source))], capture_output=True,
                          text=True, check=True).stdout
    out, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            key = kernel_key(line.split("Function :", 1)[1].strip())
            out.setdefault(key, 0)
        elif key and any(op in line for op in ops):
            out[key] += 1
    return out


def hgmma_count(source: str) -> int:
    return sum(hgmma_by_kernel(source).values())


def wgrad_parts(torch, args, kw, ptxas: dict) -> str:
    """One wgrad form's two launches timed apart: the transform pass and
    the GEMM (its TFLOP/s, grid, ptxas line and shared memory)."""
    from ircolor_tpu_torch.kernels import resblock

    b, h, w, cz = args[0].shape
    co = args[1].shape[-1]
    plan = resblock._wgrad_plan(b, h, w, cz, co)
    pad = kw.get("pad", "reflect")
    zsrc, dy = resblock._wgrad_transform(*args, **kw)
    tx = cuda_time_ms(lambda: resblock._wgrad_transform(*args, **kw), 10)
    tg = cuda_time_ms(lambda: resblock._wgrad_gemm(zsrc, dy, plan, pad=pad), 10)
    flops = 2 * b * h * w * 9 * cz * co
    kern = "gemm swap" if plan.swap else "gemm"
    smem = resblock._load_wgrad().ircolor_wgrad_gemm_smem()
    return (f"    transform {tx:.4f} ms, GEMM {tg:.4f} ms = {flops / tg / 1e9:.1f} TFLOP/s "
            f"({plan.mtiles * plan.ncob} x {plan.slots} blocks, {smem} B shared)\n"
            f"    ptxas {kern}: {ptxas.get(kern, 'not built in this process')}; transform: "
            f"{ptxas.get('pass', 'not built in this process')}")


def conv_parts(torch, halo: str, legs, kernels, mean=None, inv=None, stats: bool = True) -> str:
    """One bf16 conv form's launches (``csrc/conv_fwd.cu``) timed apart:
    the operand pass over its legs, where the plan has one, and the GEMM
    (its TFLOP/s, grid, shared memory, ptxas lines, HGMMA count)."""
    from ircolor_tpu_torch.kernels import resblock

    b, hi, wi = legs[0].shape[:3]
    h, w = (hi - 2, wi - 2) if halo == "valid" else (hi, wi)
    cout = kernels[0].shape[-1]
    plan = resblock._conv_plan(b, h, w, [x.shape[-1] for x in legs], cout, halo,
                               norm=mean is not None)

    def run_pass():
        return [resblock._conv_pass(x, mean, inv, pad=plan.pass_pad) for x in legs]

    srcs, tp = legs, 0.0
    if plan.pass_pad is not None:
        srcs = run_pass()
        tp = cuda_time_ms(run_pass, 10)
    tg = cuda_time_ms(lambda: resblock._conv_gemm(srcs, kernels, plan, stats), 10)
    flops = 2 * b * h * w * 9 * sum(x.shape[-1] for x in legs) * cout
    ptx = ptxas_lines("conv_fwd")
    smem = resblock._load_fwd().ircolor_conv_fwd_smem(plan.bn)
    missing = "not built in this process"
    pad = "none" if plan.pass_pad is None else f"pad {plan.pass_pad}"
    key = f"gemm n{plan.bn} {'stats' if stats else 'store'}"
    return (f"    pass {tp:.4f} ms ({pad}), GEMM {tg:.4f} ms = {flops / tg / 1e9:.1f} TFLOP/s "
            f"({plan.blocks} output blocks on {plan.grid} persistent blocks, {smem} B shared)\n"
            f"    ptxas {key}: {ptx.get(key, missing)}; pass: {ptx.get('pass', missing)}; "
            f"{hgmma_by_kernel('conv_fwd').get(key, 0)} HGMMA in its SASS")


def q_parts(torch, x, kq, sc, kw) -> str:
    """One int8 block conv form's two launches (``csrc/conv_fwd.cu``) timed
    apart: the int8 operand pass and the s8 GEMM (its TOP/s, grid, shared
    memory, ptxas lines, IGMMA count)."""
    from ircolor_tpu_torch.kernels import resblock

    b, h, w, c = x.shape
    cout = kq.shape[-1]
    plan = resblock._conv_plan(b, h, w, (c,), cout, "reflect", s8=True)
    zq, kt = resblock._q_pass(x, **kw), resblock._q_weights(kq, plan)
    tp = cuda_time_ms(lambda: resblock._q_pass(x, **kw), 10)
    tg = cuda_time_ms(lambda: resblock._q_gemm(zq, kt, sc, plan), 10)
    ops = 2 * b * h * w * 9 * c * cout
    ptx = ptxas_lines("conv_fwd")
    smem = resblock._load_fwd().ircolor_conv_fwd_smem(plan.bn)
    missing = "not built in this process"
    key = "gemm n128 q-stats"
    return (f"    pass {tp:.4f} ms ({(x.numel() * 2 + zq.numel()) / tp / 1e6:.0f} GB/s), GEMM "
            f"{tg:.4f} ms = {ops / tg / 1e9:.1f} TOP/s ({plan.blocks} output blocks on "
            f"{plan.grid} persistent blocks, {smem} B shared)\n"
            f"    ptxas {key}: {ptx.get(key, missing)}; pass q8: {ptx.get('pass q8', missing)}; "
            f"{hgmma_by_kernel('conv_fwd').get(key, 0)} IGMMA in its SASS")


def dgrad_parts(torch, args, kw) -> str:
    """One dgrad form's launches (``csrc/conv_fwd.cu``) timed apart: the
    operand pass (dy), the fold lines (reflect halos) and the GEMM with the
    form's epilogue (its TFLOP/s, grid, shared memory, ptxas line and
    HGMMA count)."""
    from ircolor_tpu_torch.kernels import resblock

    p, comp, aux, k, m, inv, gm, gy = args
    mask_stats, mask_p = kw.get("mask_stats"), kw.get("mask_p", False)
    b, h, w, c = p.shape
    plan = resblock._dgrad_plan(b, h, w, c, k.shape[2], kw.get("pad", "reflect"))
    dy = resblock._dgrad_pass(p, comp, m, inv, gm, gy, mask_p)
    kdg = resblock._dgrad_kernel(k)
    fold = resblock._dgrad_fold(dy, k) if plan.fold else None
    tp = cuda_time_ms(lambda: resblock._dgrad_pass(p, comp, m, inv, gm, gy, mask_p), 10)
    tf = cuda_time_ms(lambda: resblock._dgrad_fold(dy, k), 10) if plan.fold else 0.0
    tg = cuda_time_ms(lambda: resblock._dgrad_gemm(dy, kdg, plan, aux, mask_stats, fold), 10)
    flops = 2 * b * h * w * 9 * c * k.shape[2]
    cp = plan.conv
    policy = "mask-stats" if mask_stats is not None else "residual" if aux is not None else "dz"
    key = f"gemm n{cp.bn} {policy}"
    ptx = ptxas_lines("conv_fwd")
    smem = resblock._load_fwd().ircolor_conv_fwd_smem(cp.bn)
    missing = "not built in this process"
    return (f"    pass {tp:.4f} ms, fold lines {tf:.4f} ms, GEMM {tg:.4f} ms = "
            f"{flops / tg / 1e9:.1f} TFLOP/s ({cp.blocks} output blocks of N {cp.bn} on "
            f"{cp.grid} persistent blocks, {smem} B shared)\n"
            f"    ptxas {key}: {ptx.get(key, missing)}; fold: {ptx.get('fold', missing)}; "
            f"pass: {ptx.get('pass', missing)}; {hgmma_by_kernel('conv_fwd').get(key, 0)} HGMMA "
            f"in its SASS")


def check_head_build() -> None:
    """Every instantiation of csrc/head.cu (bf16 with 1, 2 or 4 K steps a
    unit, s8 with 1 or 2, and each form's several-unit one for C > 64)
    issues tensor-core MMAs (``HMMA`` / ``IMMA``, or ``wgmma``) and spills
    nothing; their ptxas lines are printed."""
    from ircolor_tpu_torch.kernels import head

    head._load()
    ptx = ptxas_lines("head")
    mma = hgmma_by_kernel("head", ("HMMA", "IMMA", "HGMMA", "IGMMA"))
    keys = ["head bf16 k1", "head bf16 k2", "head bf16 k4", "head bf16 k4 multi",
            "head s8 k1", "head s8 k2", "head s8 k2 multi"]
    for key in keys:
        line = ptx.get(key, "not built in this process")
        log(f"[head build {key}] {mma.get(key, 0)} tensor-core instructions in its SASS; "
            f"ptxas {line}")
        if not mma.get(key):
            raise AssertionError(f"the head ({key}) issues no tensor-core instruction")
        if key in ptx and "0 bytes spill stores, 0 bytes spill loads" not in line:
            raise AssertionError(f"the head ({key}) spills: {line}")


def check_gemm_build(what: str, policies: tuple) -> None:
    """Every instantiation of csrc/conv_fwd.cu's GEMM with one of
    ``policies`` (N 128 and 64) issues ``wgmma`` (HGMMA or IGMMA) and spills
    nothing; their ptxas lines are printed."""
    ptx, hg = ptxas_lines("conv_fwd"), hgmma_by_kernel("conv_fwd")
    for bn in (128, 64):
        for policy in policies:
            key = f"gemm n{bn} {policy}"
            line = ptx.get(key, "not built in this process")
            log(f"[{what} GEMM {key}] {hg.get(key, 0)} wgmma instructions; ptxas {line}")
            if not hg.get(key):
                raise AssertionError(f"the {what} GEMM ({key}) issues no wgmma")
            if key in ptx and "0 bytes spill stores, 0 bytes spill loads" not in line:
                raise AssertionError(f"the {what} GEMM ({key}) spills: {line}")


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

    # dgrad (the operand pass, the fold lines and csrc/conv_fwd.cu's GEMM):
    # launch 1 (ReLU mask + stats, dy emitted once to check it) and launch 2
    # (residual add), each with a bit-exact repeat and its launches timed
    # apart.
    check_gemm_build("dgrad", ("mask-stats", "residual", "dz"))
    errs, times, ptimes, bounds = [], [], [], []
    forms = (("mask_stats", (g, raw2, raw1, k, m2, i2, gm, gy), dict(mask_stats=(m1, i1))),
             ("residual", (raw1, raw2, g, k, m1, i1, gm, gy), {}))
    for label, args, kw in forms:
        got = resblock.conv3x3_dgrad_fused(*args, **kw)
        want = resblock.conv3x3_dgrad_fused_plain(*args, **kw)
        again = resblock.conv3x3_dgrad_fused(*args, **kw)
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        ulps = float((got[0].float() - want[0].float()).abs().max()
                     / (2.0**-8 * want[0].float().abs().max()))
        dy_err = float((got[1].float() - want[1].float()).abs().max())
        srel = rel(got[2], want[2]) if kw else 0.0
        log(f"[conv3x3_dgrad_fused {label}] max|d| = {ulps:.3g} bf16 ulps (tol 2), "
            f"dy max|d| {dy_err:.3g}, stats rel {srel:.3g} (tol 1e-3); repeat bit-exact {repeat}")
        if not (ulps <= 2 and srel <= 1e-3 and repeat
                and dy_err <= 2.0**-8 * float(want[1].float().abs().max())):
            raise AssertionError(f"conv3x3_dgrad_fused {label} disagrees with its plain version")
        errs.append(float((got[0].float() - want[0].float()).abs().max()))
        del got, want, again
        times.append(cuda_time_ms(
            lambda: resblock.conv3x3_dgrad_fused(*args, emit_dy=False, **kw), 10))
        ptimes.append(cuda_time_ms(
            lambda: resblock.conv3x3_dgrad_fused_plain(*args, emit_dy=False, **kw), 3, 1))
        log(f"    kernel {times[-1]:.3f} ms  plain {ptimes[-1]:.3f} ms")
        log(dgrad_parts(torch, args, kw))
        bounds.append(bound(flops, 4 * act + 9 * cb * cb * 2 + bb * cb * 4 * 8))
    # cuDNN's input gradient of the reflect-padded conv: the call of PRs 3-9
    # (g's NHWC memory, a channels-last view, with OIHW weights) and with
    # channels-last weights too; library_ms is the faster of the two.
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    w_oihw = k.permute(3, 2, 0, 1).contiguous()
    w_cl = w_oihw.contiguous(memory_format=torch.channels_last)
    g_nchw = g.permute(0, 3, 1, 2)
    lib_oihw = cuda_time_ms(lambda: torch.nn.grad.conv2d_input(xp.shape, w_oihw, g_nchw), 10)
    lib_cl = cuda_time_ms(lambda: torch.nn.grad.conv2d_input(xp.shape, w_cl, g_nchw), 10)
    lib = min(lib_oihw, lib_cl)
    log(f"    (for scale: cuDNN bf16 conv2d_input of the reflect-padded conv {lib_cl:.3f} ms "
        f"channels-last operands, {lib_oihw:.3f} ms with OIHW weights)")
    results.append(dict(name="conv3x3_dgrad_fused", route="cuda",
                        source="ircolor_tpu_torch/csrc/conv_fwd.cu",
                        replaces="ircolor_tpu/ops/pallas_resblock.py:692",
                        max_abs_err=max(errs), ms=sum(times) / 2, plain_ms=sum(ptimes) / 2,
                        bound_ms=sum(b for b, _ in bounds) / 2, bound_by=bounds[0][1],
                        library_ms=lib))

    # wgrad (csrc/wgrad.cu): conv2's (Z = relu(IN(raw1))) and conv1's (Z =
    # x); the transform pass and the GEMM also timed apart.
    ptxas = ptxas_lines("wgrad")
    hgmma = hgmma_count("wgrad")
    log(f"[wgrad GEMM] {hgmma} HGMMA instructions in the SASS of csrc/wgrad.cu")
    if hgmma == 0:
        raise AssertionError("the wgrad GEMM issues no wgmma")
    errs, times, ptimes = [], [], []
    forms = (("znorm", (raw1, g, raw2, m2, i2, gm, gy), dict(znorm=(m1, i1))),
             ("raw", (x, raw1, raw2, m2, i2, gm, gy), {}))
    for label, args, kw in forms:
        got = resblock.conv3x3_wgrad_fused(*args, **kw)
        want = resblock.conv3x3_wgrad_fused_plain(*args, **kw)
        err = rel(got, want)
        repeat = bool(torch.equal(got, resblock.conv3x3_wgrad_fused(*args, **kw)))
        log(f"[conv3x3_wgrad_fused {label}] max|d|/max|dk| = {err:.3g} (tol 1e-3); repeat "
            f"bit-exact {repeat}")
        if err > 1e-3 or not repeat:
            raise AssertionError(f"conv3x3_wgrad_fused {label} disagrees with its plain version")
        errs.append(float((got - want).abs().max()))
        del got, want
        times.append(cuda_time_ms(lambda: resblock.conv3x3_wgrad_fused(*args, **kw), 10))
        ptimes.append(cuda_time_ms(lambda: resblock.conv3x3_wgrad_fused_plain(*args, **kw), 3, 1))
        log(f"    kernel {times[-1]:.3f} ms  plain {ptimes[-1]:.3f} ms")
        log(wgrad_parts(torch, args, kw, ptxas))
    # cuDNN's weight gradient of the padded conv, on channels-last operands
    # (the port's NHWC) and on a contiguous NCHW pad.
    xp_cl = xp.contiguous(memory_format=torch.channels_last)
    lib = cuda_time_ms(lambda: torch.nn.grad.conv2d_weight(xp_cl, w_oihw.shape, g_nchw), 10)
    lib_nchw = cuda_time_ms(lambda: torch.nn.grad.conv2d_weight(xp, w_oihw.shape, g_nchw), 10)
    log(f"    (for scale: cuDNN bf16 conv2d_weight of the reflect-padded conv {lib:.3f} ms "
        f"channels-last, {lib_nchw:.3f} ms NCHW)")
    b_ms, b_by = bound(flops, 3 * act + 9 * cb * cb * 4 + bb * cb * 4 * 6)
    results.append(dict(name="conv3x3_wgrad_fused", route="cuda",
                        source="ircolor_tpu_torch/csrc/wgrad.cu",
                        replaces="ircolor_tpu/ops/pallas_resblock.py:956",
                        max_abs_err=max(errs), ms=sum(times) / 2, plain_ms=sum(ptimes) / 2,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    LAUNCHES.update(before)
    del g, raw2, raw1, x, xp, xp_cl
    torch.cuda.empty_cache()


def rotating_time_ms(torch, fn, inputs: list, iters: int, warmup: int = 2) -> float:
    """``cuda_time_ms`` of ``fn(*inputs[i])`` cycling over the input sets,
    which together exceed the 50 MB L2 cache: each launch reads its inputs
    from device memory, as the forward that feeds it leaves them there."""
    state = {"i": 0}

    def step():
        fn(*inputs[state["i"] % len(inputs)])
        state["i"] += 1

    return cuda_time_ms(step, iters, warmup)


def bf16_ulps(torch, got, want) -> float:
    """Largest |got − want| in bf16 ulps of each plain value (an ulp of at
    least 1e-6: where x ≈ mean the IN value is f32 rounding noise around 0)."""
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0**-126))) - 7).clamp(min=1e-6)
    return float(((got.float() - w).abs() / ulp).max())


def check_instance_norm(torch, results: list) -> None:
    """Phase 2, kernel 11 at the shape ``use_pallas`` serving runs it: the
    256² bottleneck at the test batch, 16×64×64×256. bf16 IN + ReLU and
    IN + residual within one bf16 ulp of the plain version; f32 IN + ReLU
    within 1e-5 relative to max(|value|, 1); every form repeats bit for bit.
    Times over 4 input sets (134 MB in bf16: device memory, not L2)."""
    import torch.nn.functional as F

    from ircolor_tpu_torch.kernels import LAUNCHES
    from ircolor_tpu_torch.kernels import instance_norm as tin

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    before = dict(LAUNCHES)
    shape = (16, 64, 64, 4 * NGF)
    n = 16 * 64 * 64 * 4 * NGF

    def randn(scale=1.0, shift=0.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale + shift

    xs32 = [randn(3.0, 1.0) for _ in range(4)]
    sets = [(x.to(torch.bfloat16), randn().to(torch.bfloat16)) for x in xs32]
    nchw = [(x.permute(0, 3, 1, 2), r.permute(0, 3, 1, 2)) for x, r in sets]
    forms = (
        ("fused_instance_norm", "IN + ReLU", ":117", lambda x, r: tin.run_in(x, True),
         lambda x, r: tin.fused_instance_norm_plain(x, True),
         lambda x, r: torch.relu(F.instance_norm(x)), 2 * n * 2),
        ("fused_instance_norm_residual", "IN + r", ":133", tin.run_in_res,
         tin.fused_instance_norm_residual_plain, lambda x, r: F.instance_norm(x) + r, 3 * n * 2),
    )
    for name, label, line, kern, plain, lib, nbytes in forms:
        x, r = sets[0]
        got, want = kern(x, r), plain(x, r)
        ulps = bf16_ulps(torch, got, want)
        repeat = bool(torch.equal(got, kern(x, r)))
        err = float((got.float() - want.float()).abs().max())
        log(f"[{name} bf16 16x64x64x256 {label}] max {ulps:.3g} bf16 ulps (tol 1); "
            f"max|d|={err:.4g}; repeat bit-exact {repeat}")
        if not (ulps <= 1 and repeat):
            raise AssertionError(f"{name} disagrees with its plain version")
        ms = rotating_time_ms(torch, kern, sets, 40)
        pms = rotating_time_ms(torch, plain, sets, 8)
        lms = rotating_time_ms(torch, lib, nchw, 20)
        b_ms, b_by = bound(8 * n, nbytes, PEAK_F32)
        log(f"    kernel {ms:.4f} ms  plain {pms:.4f} ms  library (F.instance_norm, then the "
            f"ReLU or + r) {lms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        results.append(dict(name=name, route="cuda", source="ircolor_tpu_torch/csrc/instance_norm.cu",
                            replaces=f"ircolor_tpu/ops/pallas_kernels.py{line}",
                            max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=lms))
    del sets, nchw
    # float32 IN + ReLU (use_pallas in f32 runs only this form at 256²).
    sets32 = [(x, None) for x in xs32]
    got, want = tin.run_in(xs32[0], True), tin.fused_instance_norm_plain(xs32[0], True)
    rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
    repeat = bool(torch.equal(got, tin.run_in(xs32[0], True)))
    ms = rotating_time_ms(torch, lambda x, r: tin.run_in(x, True), sets32, 40)
    pms = rotating_time_ms(torch, lambda x, r: tin.fused_instance_norm_plain(x, True), sets32, 8)
    lms = rotating_time_ms(torch, lambda x, r: torch.relu(F.instance_norm(x.permute(0, 3, 1, 2))),
                           sets32, 20)
    b_ms, b_by = bound(8 * n, 2 * n * 4, PEAK_F32)
    log(f"[fused_instance_norm f32 16x64x64x256 IN + ReLU] max rel {rel:.3g} (tol 1e-5); repeat "
        f"bit-exact {repeat}; kernel {ms:.4f} ms  plain {pms:.4f} ms  F.instance_norm + relu "
        f"{lms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
    if not (rel <= 1e-5 and repeat):
        raise AssertionError("fused_instance_norm f32 disagrees with its plain version")
    del xs32, sets32
    torch.cuda.empty_cache()
    LAUNCHES.update(before)


# The flagship b8 training segments: (label, H, W, cotangent channels, input
# legs). down1's 64-channel leg takes cuDNN's weight gradient from the dy the
# dgrad stores ("xla" mode); down2 and up1 run the wgrad kernel per leg.
SEGMENTS = (
    ("down1", H, W, 2 * NGF, (NGF,)),
    ("down2", H // 2, W // 2, 4 * NGF, (2 * NGF,)),
    ("up1", H // 2, W // 2, 2 * NGF, (4 * NGF, 2 * NGF)),
)


def check_segment_kernels(torch, results: list) -> None:
    """Phase 2b, the dgrad and wgrad kernels in the enc/dec segment modes
    (zero halos, p masked by comp > m on load, no aux) at the three b8
    flagship segments, at the block rows' bounds: dz within 2 bf16 ulps at
    its largest magnitude, the emitted dy within 1 ulp at its largest, dk
    within 1e-3 of max|dk|. Beside cuDNN's bf16 ``conv2d_input`` /
    ``conv2d_weight`` of the zero-pad conv. Each row sums one training
    step's launches: 3 dgrads, 3 wgrads."""
    from ircolor_tpu_torch.kernels import LAUNCHES, resblock
    from ircolor_tpu_torch.ops.norm import instance_norm_stats

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    before = dict(LAUNCHES)
    ptxas = ptxas_lines("wgrad")
    bb = TRAIN_B
    kw = dict(pad="zero", mask_p=True)
    dg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bounds=[], err=0.0)
    wg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bounds=[], err=0.0)
    for label, hh, ww, c, legs in SEGMENTS:
        cin = sum(legs)

        def bf16(ch, scale=1.0):
            return (torch.randn(bb, hh, ww, ch, device="cuda", generator=gen) * scale).to(torch.bfloat16)

        p, comp = bf16(c), bf16(c)
        m, inv = instance_norm_stats(comp)
        gm, gy = (torch.randn(bb, c, device="cuda", generator=gen) * 0.01 for _ in range(2))
        k = (torch.randn(3, 3, cin, c, device="cuda", generator=gen) * 0.05).to(torch.bfloat16)
        emit = any(leg % 128 for leg in legs)  # the "xla" wgrad reads the stored dy
        args = (p, comp, None, k, m, inv, gm, gy)
        got = resblock.conv3x3_dgrad_fused(*args, emit_dy=emit, **kw)
        want = resblock.conv3x3_dgrad_fused_plain(*args, emit_dy=emit, **kw)
        scale = float(want[0].float().abs().max())
        ulps = float((got[0].float() - want[0].float()).abs().max()) / (2.0**-8 * scale)
        dy_ok = not emit or float((got[1].float() - want[1].float()).abs().max()) <= (
            2.0**-8 * float(want[1].float().abs().max()))
        repeat = torch.equal(got[0], resblock.conv3x3_dgrad_fused(*args, emit_dy=emit, **kw)[0])
        log(f"[conv3x3_dgrad_fused_seg {label} {bb}x{hh}x{ww}, {c} -> dz {cin}"
            f"{', dy stored' if emit else ''}] max|d| = {ulps:.3g} bf16 ulps (tol 2); dy ok {dy_ok}; "
            f"repeat bit-exact {repeat}")
        if not (ulps <= 2 and dy_ok and repeat):
            raise AssertionError(f"conv3x3_dgrad_fused_seg {label} disagrees with its plain version")
        dg["err"] = max(dg["err"], float((got[0].float() - want[0].float()).abs().max()))
        del got, want
        ms = cuda_time_ms(lambda: resblock.conv3x3_dgrad_fused(*args, emit_dy=emit, **kw), 10)
        pms = cuda_time_ms(lambda: resblock.conv3x3_dgrad_fused_plain(*args, emit_dy=emit, **kw), 2, 1)
        w_oihw = k.permute(3, 2, 0, 1).contiguous()
        w_cl = w_oihw.contiguous(memory_format=torch.channels_last)
        p_nchw = p.permute(0, 3, 1, 2)
        lib_oihw = cuda_time_ms(lambda: torch.nn.grad.conv2d_input(
            (bb, cin, hh, ww), w_oihw, p_nchw, padding=1), 10)
        lib_cl = cuda_time_ms(lambda: torch.nn.grad.conv2d_input(
            (bb, cin, hh, ww), w_cl, p_nchw, padding=1), 10)
        lib = min(lib_oihw, lib_cl)  # the faster call, as the block row
        npix = bb * hh * ww
        b_ms = bound(2 * npix * 9 * c * cin,
                     npix * (2 * c + cin + c * emit) * 2 + 9 * c * cin * 2 + bb * c * 16)
        log(f"    kernel {ms:.3f} ms  plain {pms:.3f} ms  cuDNN conv2d_input {lib_cl:.3f} ms "
            f"channels-last ({lib_oihw:.3f} with OIHW weights)  bound {b_ms[0]:.3f} ms ({b_ms[1]})")
        log(dgrad_parts(torch, args, dict(kw)))
        for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lib)):
            dg[key] += v
        dg["bounds"].append(b_ms)
        if emit:
            continue
        for leg in legs:
            z = bf16(leg)
            wargs = (z, p, comp, m, inv, gm, gy)
            got = resblock.conv3x3_wgrad_fused(*wargs, **kw)
            want = resblock.conv3x3_wgrad_fused_plain(*wargs, **kw)
            rel = float((got - want).abs().max() / want.abs().max())
            repeat = bool(torch.equal(got, resblock.conv3x3_wgrad_fused(*wargs, **kw)))
            log(f"[conv3x3_wgrad_fused_seg {label} leg {leg} -> {c}] max|d|/max|dk| = {rel:.3g} "
                f"(tol 1e-3); repeat bit-exact {repeat}")
            if rel > 1e-3 or not repeat:
                raise AssertionError(f"conv3x3_wgrad_fused_seg {label} disagrees with its plain version")
            wg["err"] = max(wg["err"], float((got - want).abs().max()))
            ms = cuda_time_ms(lambda: resblock.conv3x3_wgrad_fused(*wargs, **kw), 10)
            pms = cuda_time_ms(lambda: resblock.conv3x3_wgrad_fused_plain(*wargs, **kw), 2, 1)
            z_nchw = z.permute(0, 3, 1, 2)
            lib = cuda_time_ms(lambda: torch.nn.grad.conv2d_weight(z_nchw, (c, leg, 3, 3), p_nchw,
                                                                   padding=1), 10)
            b_ms = bound(2 * npix * 9 * leg * c,
                         npix * (leg + 2 * c) * 2 + 9 * leg * c * 4 + bb * c * 16)
            log(f"    kernel {ms:.3f} ms  plain {pms:.3f} ms  cuDNN conv2d_weight {lib:.3f} ms  "
                f"bound {b_ms[0]:.3f} ms ({b_ms[1]})")
            log(wgrad_parts(torch, wargs, kw, ptxas))
            for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lib)):
                wg[key] += v
            wg["bounds"].append(b_ms)
            del z, got, want
        del p, comp, k, args
        torch.cuda.empty_cache()
    for name, row, line, src in (("conv3x3_dgrad_fused_seg", dg, ":692", "conv_fwd.cu"),
                                 ("conv3x3_wgrad_fused_seg", wg, ":956", "wgrad.cu")):
        log(f"    {name}, one step's launches: kernel {row['ms']:.3f} ms, plain "
            f"{row['plain_ms']:.3f} ms, cuDNN {row['library_ms']:.3f} ms, bound "
            f"{sum(b for b, _ in row['bounds']):.3f} ms")
        results.append(dict(name=name, route="cuda", source=f"ircolor_tpu_torch/csrc/{src}",
                            replaces=f"ircolor_tpu/ops/pallas_resblock.py{line}",
                            max_abs_err=row["err"], ms=row["ms"], plain_ms=row["plain_ms"],
                            bound_ms=sum(b for b, _ in row["bounds"]),
                            bound_by=row["bounds"][0][1], library_ms=row["library_ms"]))
    LAUNCHES.update(before)


def nhwc_pad(torch, x, mode: str = "reflect"):
    """One pixel of ``mode`` padding of an NHWC tensor, contiguous."""
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode=mode)
    return xp.permute(0, 2, 3, 1).contiguous()


def ulps_at_scale(got, want) -> float:
    """Largest |got − want| in bf16 ulps at the plain output's largest
    magnitude."""
    return float((got.float() - want.float()).abs().max()) / (
        2.0**-8 * float(want.float().abs().max()))


def stats_rel(got, want) -> float:
    """IN (mean, inv) disagreement: |Δmean| over the largest |mean|, and
    |Δinv| / inv, the larger of the two."""
    merr = (got[1] - want[1]).abs().max() / want[1].abs().max().clamp(min=1e-6)
    return max(float(merr), float(((got[2] - want[2]) / want[2]).abs().max()))


def slice5_setup(torch):
    """The flagship generator of phase 3 (configs/flagship_512x640.json,
    seed 0) for its weights, HWIO bf16 through ``_hwio``: down2_conv (128 →
    256), up1_conv (256 + 128 → 128) and resblocks.0's two convs; and b32
    bf16 inputs at the flagship stage shapes from a seeded generator: the
    d2 input (32×256×320×128), the up1 legs (the upsampled bottleneck
    32×256×320×256 and the skip 32×256×320×128), the bottleneck
    (32×128×160×256, and reflect-padded) and the down1 tail's plane
    (32×512×640×128)."""
    from ircolor_tpu_torch.models.generator import _hwio
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    bf16 = torch.bfloat16
    g = IRColorizationModel(serving_config(), "cuda").module
    blk = g.resblocks[0].conv_block
    up1 = _hwio(g.up1_conv[0], bf16)
    w = dict(down2=_hwio(g.down2[0], bf16), up1=(up1[:, :, :4 * NGF], up1[:, :, 4 * NGF:]),
             k1=_hwio(blk[1], bf16), k2=_hwio(blk[5], bf16))
    w = {k: tuple(t.detach() for t in v) if isinstance(v, tuple) else v.detach()
         for k, v in w.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(bf16)

    xs = dict(d2=randn(B, H // 2, W // 2, 2 * NGF), up=randn(B, H // 2, W // 2, 4 * NGF),
              skip=randn(B, H // 2, W // 2, 2 * NGF), neck=randn(B, H // 4, W // 4, 4 * NGF),
              d1=randn(B, H, W, 2 * NGF))
    xs["neck_p"] = nhwc_pad(torch, xs["neck"])
    return g, w, xs


def slice5_path(torch, w, xs) -> dict:
    """The slice's main path, once: the compositions the JAX tools build
    from TPU kernels 7–10 (``tools/fwdvariants.py`` ``pallas_all``: the d2
    stage (a) and the concat-free u1 stage (b); ``pallas_block.py``'s
    ResnetBlock (c)), row 10 in its three JAX forms at the bottleneck
    (``tools/pallasbench.py``, ``pallassmoke.py``) and row 8 at both
    down-stage planes (``tools/blurprobe.py``). Returns the outputs."""
    from ircolor_tpu_torch.kernels import blur, block, conv, resblock

    out = {}
    raw, m, i = resblock.conv3x3_sum_fused([xs["d2"]], [w["down2"]], pad="zero")
    out["a"] = blur.norm_relu_blur_down_pallas(raw, m, i)
    raw, m, i = resblock.conv3x3_sum_fused([xs["up"], xs["skip"]], list(w["up1"]), pad="zero")
    out["b"] = torch.relu((raw.float() - m[:, None, None, :]) * i[:, None, None, :]).to(raw.dtype)
    raw1, m1, i1 = block.conv3x3_stats(xs["neck_p"], w["k1"])
    raw2, m2, i2 = block.conv3x3_norm_in_stats(nhwc_pad(torch, raw1), w["k2"], m1, i1)
    out["c"] = resblock._block_epilogue(xs["neck"], raw2, m2, i2)
    out["v1"] = conv.conv3x3_valid_pallas(xs["neck_p"], w["k1"])
    for mode in ("preshift", "dxcat"):
        out[f"v2 {mode}"] = conv.conv3x3_valid_pallas_v2(xs["neck_p"], w["k1"], mode=mode)
    out["blur d1"] = blur.blur_downsample_pallas(xs["d1"])
    out["blur d2"] = blur.blur_downsample_pallas(xs["up"])
    return out


def check_slice5_kernels(torch, results: list, w, xs) -> None:
    """Phase 2c: TPU kernels 7–10 against their plain versions at the b32
    flagship stage shapes, timed beside the plain version and one cuDNN
    call. Tolerances: conv outputs within 2 bf16 ulps at the output's
    largest magnitude (the same f32 sums in another order, one rounding),
    IN (mean, inv) within 1e-3 relative, each conv kernel bit-exact on
    repeat (fixed-order sums); the blur within 1 bf16 ulp of its plain
    version and of ``ops.blurpool.blur_downsample``."""
    import torch.nn.functional as F

    from ircolor_tpu_torch.kernels import LAUNCHES, blur, block, conv, resblock
    from ircolor_tpu_torch.ops.blurpool import blur_downsample

    before = dict(LAUNCHES)

    def conv_case(name, label, kern, plain, lib, ops, nbytes, parts, stats=True):
        got, want, again = kern(), plain(), kern()
        g0, w0 = (got[0], want[0]) if stats else (got, want)
        ulps = ulps_at_scale(g0, w0)
        srel = stats_rel(got, want) if stats else 0.0
        repeat = all(torch.equal(a, b) for a, b in zip(got, again)) if stats else bool(
            torch.equal(got, again))
        log(f"[{name} {label}] max|d| = {ulps:.3g} bf16 ulps at scale (tol 2); stats rel "
            f"{srel:.3g} (tol 1e-3); repeat bit-exact {repeat}")
        if not (ulps <= 2 and srel <= 1e-3 and repeat):
            raise AssertionError(f"{name} {label} disagrees with its plain version")
        err = float((g0.float() - w0.float()).abs().max())
        del got, want, again
        ms = cuda_time_ms(kern, 10)
        parts_line = conv_parts(torch, *parts, stats=stats)
        pms = cuda_time_ms(plain, 2, 1)
        lms = cuda_time_ms(lib, 10)
        b_ms, b_by = bound(ops, nbytes)
        log(f"    kernel {ms:.3f} ms  plain {pms:.3f} ms  cuDNN {lms:.3f} ms  bound "
            f"{b_ms:.3f} ms ({b_by})\n{parts_line}")
        return dict(err=err, ms=ms, plain_ms=pms, library_ms=lms, bound=(b_ms, b_by))

    def row(name, source, replaces, cases):
        by = cases[0]["bound"][1]
        results.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=max(c["err"] for c in cases),
            ms=sum(c["ms"] for c in cases), plain_ms=sum(c["plain_ms"] for c in cases),
            bound_ms=sum(c["bound"][0] for c in cases), bound_by=by,
            library_ms=sum(c["library_ms"] for c in cases)))

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def oihw(k):
        return k.permute(3, 2, 0, 1).contiguous()

    def conv_bytes(npix_in, cin, npix_out, cout, stats=True):
        return 2 * (npix_in * cin + npix_out * cout + 9 * cin * cout) + (B * cout * 8 if stats else 0)

    src = "ircolor_tpu_torch/csrc/conv_fwd.cu"
    # Row 7: down2 (1 leg, zero), up1 (2 legs, zero, no concat), a reflect
    # leg at the bottleneck. The row sums the three.
    hs, ws = H // 2, W // 2
    d2, (ua, ub), k1, k2 = w["down2"], w["up1"], w["k1"], w["k2"]
    cat = torch.cat([xs["up"], xs["skip"]], dim=-1)  # the library call's input, made here
    ucat = oihw(torch.cat([ua, ub], dim=2))
    npx, npb = B * hs * ws, B * (H // 4) * (W // 4)
    cases = [
        conv_case("conv3x3_sum_fused", f"down2 {B}x{hs}x{ws}x128->256, 1 leg, zero",
                  lambda: resblock.conv3x3_sum_fused([xs["d2"]], [d2]),
                  lambda: resblock.conv3x3_sum_fused_plain([xs["d2"]], [d2]),
                  lambda: F.conv2d(nchw(xs["d2"]), oihw(d2), padding=1),
                  2 * npx * 9 * 128 * 256, conv_bytes(npx, 128, npx, 256),
                  parts=("zero", [xs["d2"]], [d2])),
        conv_case("conv3x3_sum_fused", f"up1 {B}x{hs}x{ws}x(256+128)->128, 2 legs, zero",
                  lambda: resblock.conv3x3_sum_fused([xs["up"], xs["skip"]], [ua, ub]),
                  lambda: resblock.conv3x3_sum_fused_plain([xs["up"], xs["skip"]], [ua, ub]),
                  lambda: F.conv2d(nchw(cat), ucat, padding=1),
                  2 * npx * 9 * 384 * 128, conv_bytes(npx, 384, npx, 128),
                  parts=("zero", [xs["up"], xs["skip"]], [ua, ub])),
        conv_case("conv3x3_sum_fused", f"{B}x{H // 4}x{W // 4}x256->256, 1 leg, reflect",
                  lambda: resblock.conv3x3_sum_fused([xs["neck"]], [k1], pad="reflect"),
                  lambda: resblock.conv3x3_sum_fused_plain([xs["neck"]], [k1], pad="reflect"),
                  lambda: F.conv2d(F.pad(nchw(xs["neck"]), (1, 1, 1, 1), mode="reflect"), oihw(k1)),
                  2 * npb * 9 * 256 * 256, conv_bytes(npb, 256, npb, 256),
                  parts=("reflect", [xs["neck"]], [k1])),
    ]
    del cat, ucat
    row("conv3x3_sum_fused", src, "ircolor_tpu/ops/pallas_resblock.py:1190", cases)

    # Row 9 (stats; norm_in_stats on the reflect-padded raw1 with its
    # stats) and row 10 (v1, v2 preshift, v2 dxcat: one kernel) at the
    # bottleneck, 32×130×162×256 → 32×128×160×256. Rows 9 and 10 are each
    # the mean of their forms, as rows 1 and 2 are.
    xp = xs["neck_p"]
    npad = B * (H // 4 + 2) * (W // 4 + 2)
    raw1, m1, i1 = block.conv3x3_stats_plain(xp, k1)
    rp = nhwc_pad(torch, raw1)
    del raw1
    nb = conv_bytes(npad, 256, npb, 256)
    valid_ops = 2 * npb * 9 * 256 * 256
    stats_cases = [
        conv_case("conv3x3_stats", f"{B}x{H // 4 + 2}x{W // 4 + 2}x256->256",
                  lambda: block.conv3x3_stats(xp, k1), lambda: block.conv3x3_stats_plain(xp, k1),
                  lambda: F.conv2d(nchw(xp), oihw(k1)), valid_ops, nb,
                  parts=("valid", [xp], [k1])),
        conv_case("conv3x3_norm_in_stats", f"{B}x{H // 4 + 2}x{W // 4 + 2}x256->256",
                  lambda: block.conv3x3_norm_in_stats(rp, k2, m1, i1),
                  lambda: block.conv3x3_stats_plain(rp, k2, m1, i1),
                  lambda: F.conv2d(nchw(rp), oihw(k2)), valid_ops, nb + B * 256 * 8,
                  parts=("valid", [rp], [k2], m1, i1)),
    ]
    for case, name in zip(stats_cases, ("conv3x3_stats", "conv3x3_norm_in_stats")):
        results.append(dict(name=name, route="cuda", source=src,
                            replaces="ircolor_tpu/ops/pallas_block.py:105",
                            max_abs_err=case["err"], ms=case["ms"], plain_ms=case["plain_ms"],
                            bound_ms=case["bound"][0], bound_by=case["bound"][1],
                            library_ms=case["library_ms"]))
    del rp
    forms = (("v1", lambda: conv.conv3x3_valid_pallas(xp, k1)),
             ("v2 preshift", lambda: conv.conv3x3_valid_pallas_v2(xp, k1, mode="preshift")),
             ("v2 dxcat", lambda: conv.conv3x3_valid_pallas_v2(xp, k1, mode="dxcat")))
    vcases = [conv_case("conv3x3_valid", f"{label} {B}x{H // 4 + 2}x{W // 4 + 2}x256->256",
                        kern, lambda: conv.conv3x3_valid_plain(xp, k1),
                        lambda: F.conv2d(nchw(xp), oihw(k1)), valid_ops,
                        conv_bytes(npad, 256, npb, 256, stats=False), stats=False,
                        parts=("valid", [xp], [k1]))
              for label, kern in forms]
    n = len(vcases)
    results.append(dict(name="conv3x3_valid", route="cuda", source=src,
                        replaces="ircolor_tpu/ops/pallas_conv.py:256",
                        max_abs_err=max(c["err"] for c in vcases),
                        ms=sum(c["ms"] for c in vcases) / n,
                        plain_ms=sum(c["plain_ms"] for c in vcases) / n,
                        bound_ms=vcases[0]["bound"][0], bound_by=vcases[0]["bound"][1],
                        library_ms=sum(c["library_ms"] for c in vcases) / n))

    # Row 8 at both down-stage planes; the row sums the two.
    bcases = []
    for label, x in (("d1", xs["d1"]), ("d2", xs["up"])):
        b_, hh, ww, cc = x.shape
        got, want = blur.blur_downsample_pallas(x), blur.blur_downsample_plain(x)
        ulps = ulps_at_scale(got, want)
        ulps_conv = ulps_at_scale(got, blur_downsample(x))
        log(f"[blur_downsample {label} {b_}x{hh}x{ww}x{cc}] max|d| = {ulps:.3g} bf16 ulps at "
            f"scale vs plain, {ulps_conv:.3g} vs ops.blurpool.blur_downsample (tol 1 each)")
        if not (ulps <= 1 and ulps_conv <= 1):
            raise AssertionError(f"blur_downsample {label} disagrees with its plain version")
        err = float((got.float() - want.float()).abs().max())
        del got, want
        xpad = nhwc_pad(torch, x)
        filt = torch.tensor([1.0, 2.0, 1.0], device="cuda")
        wdw = (filt[:, None] * filt[None, :] / 16.0).to(torch.bfloat16).expand(cc, 1, 3, 3).contiguous()
        ms = cuda_time_ms(lambda: blur.blur_downsample_pallas(x), 20)
        pms = cuda_time_ms(lambda: blur.blur_downsample_plain(x), 3, 1)
        lms = cuda_time_ms(lambda: F.conv2d(nchw(xpad), wdw, stride=2, groups=cc), 10)
        del xpad
        n_in, n_out = b_ * hh * ww * cc, b_ * (hh // 2) * (ww // 2) * cc
        b_ms, b_by = bound(13 * n_out, 2 * (n_in + n_out), PEAK_F32)
        log(f"    kernel {ms:.3f} ms  plain {pms:.3f} ms  cuDNN depthwise stride-2 conv of the "
            f"padded input {lms:.3f} ms  bound {b_ms:.3f} ms ({b_by})")
        bcases.append(dict(err=err, ms=ms, plain_ms=pms, library_ms=lms, bound=(b_ms, b_by)))
    row("blur_downsample", "ircolor_tpu_torch/csrc/blur.cu",
        "ircolor_tpu/ops/pallas_blur.py:143", bcases)
    LAUNCHES.update(before)
    torch.cuda.empty_cache()


def slice5_compositions(torch, g, w, xs) -> None:
    """Phase 2c, the compositions against the port's product route on the
    same inputs, both timed (CUDA events): (a) the d2 stage, kernel 7's free
    stats into kernel 3, against cuDNN conv + the IN stats by reduction +
    kernel 3 (the serving route; the flagship biases are zero at init);
    (b) the u1 stage, kernel 7 over both legs then normalize + ReLU, against
    ``concat_conv3x3`` + ``_norm_relu``; (c) one ResnetBlock from kernel 9
    (stats, then norm-in stats on the padded raw, then the epilogue)
    against kernel 2's ``resnet_block_pallas``. Bound: 4 bf16 ulps at the
    output's scale (the two routes take their IN stats from differently
    rounded tensors)."""
    from ircolor_tpu_torch.kernels import LAUNCHES, blur, block, resblock
    from ircolor_tpu_torch.models.common import concat_conv3x3, conv_nhwc

    before = dict(LAUNCHES)
    dt = torch.bfloat16

    def route_a():
        raw, m, i = resblock.conv3x3_sum_fused([xs["d2"]], [w["down2"]])
        return blur.norm_relu_blur_down_pallas(raw, m, i)

    def route_b():
        raw, m, i = resblock.conv3x3_sum_fused([xs["up"], xs["skip"]], list(w["up1"]))
        return torch.relu((raw.float() - m[:, None, None, :]) * i[:, None, None, :]).to(dt)

    def route_c():
        raw1, m1, i1 = block.conv3x3_stats(nhwc_pad(torch, xs["neck"]), w["k1"])
        raw2, m2, i2 = block.conv3x3_norm_in_stats(nhwc_pad(torch, raw1), w["k2"], m1, i1)
        return resblock._block_epilogue(xs["neck"], raw2, m2, i2)

    pairs = (
        ("(a) d2 stage", route_a,
         lambda: blur.norm_relu_blur_down(conv_nhwc(g.down2[0], xs["d2"], dt))),
        ("(b) u1 stage", route_b,
         lambda: g._norm_relu(concat_conv3x3(g.up1_conv[0], xs["up"], xs["skip"], dt))),
        ("(c) ResnetBlock", route_c,
         lambda: resblock.resnet_block_pallas(xs["neck"], w["k1"], w["k2"])),
    )
    for label, kern, product in pairs:
        got, want = kern(), product()
        ulps = ulps_at_scale(got, want)
        del got, want
        times = [cuda_time_ms(f, 5) for f in (product, kern, kern, product)]
        log(f"[composition {label}] kernels 7-10 route {times[1]:.3f} / {times[2]:.3f} ms, "
            f"product route {times[0]:.3f} / {times[3]:.3f} ms (turns: product, kernels, "
            f"kernels, product); max|d| {ulps:.3g} bf16 ulps at scale (tol 4)")
        if ulps > 4:
            raise AssertionError(f"composition {label}: the routes disagree")
    LAUNCHES.update(before)
    torch.cuda.empty_cache()


def synthetic_batches(np, n: int, b: int, hw: tuple = (H, W)):
    """IR-like frames (smooth gradients + a warm blob, a little sensor
    noise) with the RGB a fixed colormap of the IR, as uint16 / uint8 — the
    pattern of ``ircolor_tpu/data/synthetic.py``, made here with numpy."""
    rng = np.random.RandomState(SEED)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(n):
        ir = np.empty((b, h, w, 1), np.uint16)
        gt = np.empty((b, h, w, 3), np.uint8)
        for j in range(b):
            phase = rng.uniform(0, 2 * np.pi)
            f = 0.5 + 0.4 * np.sin(xx / w * 4 * np.pi + phase) * np.cos(yy / h * 2 * np.pi)
            cx, cy = rng.randint(0, w), rng.randint(0, h)
            f = f + 0.5 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * (h / 4) ** 2))
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


def calibrate_batch_norms(torch, module, run, label: str):
    """Set every batch norm's running statistics to those of its input in
    one ``run()`` (eval mode; each norm sees inputs that the norms before
    it already normalize with calibrated statistics), as a trained
    network's would be. The init's (0, 1) shrink a random network's
    activations about 3× a layer under batch norm, and its prediction
    comes out nearly flat (std 0.014 at the flagship widths on the CPU,
    against 0.5 under instance norm). Fails unless the prediction is live:
    uint8 std of at least 10 levels. Returns ``run()``'s result."""
    from ircolor_tpu_torch.models.common import BatchNorm

    def hook(m, args):
        x = args[0].float()
        mean = x.mean(dim=(0, 1, 2))
        m.running_mean.copy_(mean)
        m.running_var.copy_(torch.clamp(x.square().mean(dim=(0, 1, 2)) - mean.square(), min=0.0))

    handles = [m.register_forward_pre_hook(hook) for m in module.modules()
               if isinstance(m, BatchNorm)]
    try:
        out = run()
    finally:
        for h in handles:
            h.remove()
    std = float(out[0].float().std())
    log(f"[{label}] batch norms calibrated on one batch ({len(handles)} norms); "
        f"prediction uint8 std {std:.2f}")
    if not handles or std < 10.0:
        raise AssertionError(f"{label}: calibration left {len(handles)} norms, uint8 std {std:.2f}")
    return out


def expect_launches(label: str, counts: dict, per_forward: dict, forwards: int) -> None:
    """Fail unless ``counts`` is ``per_forward`` × ``forwards`` for every
    kernel (0 for the kernels ``per_forward`` does not name)."""
    want = {name: per_forward.get(name, 0) * forwards for name in counts}
    log(f"[{label}] launches over {forwards} forwards: {counts}")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")


def serve(torch, np, label: str, overrides: dict, quant: bool, per_forward: dict,
          results_counts: dict, hw: tuple = (H, W), batch: int = B, n_batches: int = 3,
          profile: bool = False) -> float:
    """Phase 3: returns frames/s over ``n_batches`` batches of the resolved
    test batch (32 at 512×640, 16 at 256²); with ``profile`` also a
    ``torch.profiler`` window of one batch."""
    from ircolor_tpu_torch.eval.runner import make_infer_fn
    from ircolor_tpu_torch.kernels import LAUNCHES, reset_launches
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    cfg = serving_config(**overrides)
    if (cfg.resolved_hw, cfg.resolved_test_batch_size, cfg.resolved_quant_int8) != (hw, batch, quant):
        raise AssertionError(f"{label}: config no longer resolves to {hw} b{batch} int8={quant}")
    model = IRColorizationModel(cfg, "cuda")
    infer = make_infer_fn(model.module)
    batches = [
        (torch.from_numpy(ir).cuda(), torch.from_numpy(gt).cuda())
        for ir, gt in synthetic_batches(np, n_batches, batch, hw)
    ]
    if cfg.norm == "batch":  # the warm-up also calibrates the batch norms
        calibrate_batch_norms(torch, model.module, lambda: infer(*batches[0]), f"serve {label}")
    pred, m = infer(*batches[0])  # warm-up: cuDNN algorithm picks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    outs = [infer(ir, gt) for ir, gt in batches]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    fps = len(batches) * batch / dt
    expect_launches(f"serve {label}", counts, per_forward, len(batches))
    check_outputs(torch, f"serve {label}", outs, batch, hw)
    mm = {k: float(v.mean()) for k, v in outs[-1][1].items()}
    log(f"[serve {label}] {fps:.2f} frames/s ({len(batches)} batches of {batch} at "
        f"{hw[0]}x{hw[1]}, {1e3 * dt / len(batches):.2f} ms per batch), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last-batch metrics {mm}")
    results_counts[label] = counts
    if profile:
        profile_window(torch, f"serve {label} profile", lambda: infer(*batches[0]), "one batch",
                       top=10, ours=True)
        LAUNCHES.update(counts)
    del model, batches, outs
    torch.cuda.empty_cache()
    return fps


def check_outputs(torch, label: str, outs, b: int, hw: tuple = (H, W)) -> None:
    for pred, m in outs:
        if pred.shape != (b, *hw, 3) or pred.dtype != torch.uint8:
            raise AssertionError(f"{label}: prediction {pred.shape} {pred.dtype}")
        for key, v in m.items():
            if v.shape != (b,) or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{label}: metric {key} not finite: {v}")


B1_FRAMES, B1_WARMUP = 64, 4


def latency_b1(torch, np, label: str, quant: bool, per_forward: dict, results_counts: dict,
               overrides: dict | None = None):
    """Phase 3 at batch 1: one frame at a time through ``make_infer_fn``,
    a synchronize after each; returns (mean, median) ms per frame over
    ``B1_FRAMES`` frames after ``B1_WARMUP`` warm-up frames."""
    from ircolor_tpu_torch.eval.runner import make_infer_fn
    from ircolor_tpu_torch.kernels import LAUNCHES, reset_launches
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    cfg = serving_config(test_batch_size=1, quant_int8=None if quant else False,
                         **(overrides or {}))
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

    profile_window(torch, f"b1 {label} profile", four_frames, "4 frames", top=8, ours=True)
    results_counts[f"b1 {label}"] = counts
    del model, outs
    torch.cuda.empty_cache()
    return mean, med


class plain_kernels:
    """Context: the named kernel wrappers (all forward wrappers by default)
    swapped for their plain versions, so whatever calls them runs no
    kernel. ``segment_dgrad`` / ``segment_wgrad`` swap the backward kernels
    only where the enc/dec segments call them (``kernels/encdec.py``)."""

    FORWARD = ("conv3x3_reflect_fused", "conv3x3_reflect_fused_q", "norm_relu_blur_down_pallas",
               "conv7x7_head_pallas", "conv3x3_int8", "run_in", "run_in_res")

    def __init__(self, names=FORWARD):
        from ircolor_tpu_torch.kernels import blur, conv_int8, encdec, head, resblock
        from ircolor_tpu_torch.kernels import instance_norm as tin
        from ircolor_tpu_torch.ops import quant

        def head_plain(x, mean, inv, kernel, *, quant=False):
            plain = head.conv7x7_head_q_plain if quant else head.conv7x7_head_plain
            return plain(x, mean, inv, kernel)

        swaps = {  # name: (module, attribute, plain version)
            "conv3x3_reflect_fused": (resblock, None, resblock.conv3x3_reflect_fused_plain),
            "conv3x3_reflect_fused_q": (resblock, None, resblock.conv3x3_reflect_fused_q_plain),
            "norm_relu_blur_down_pallas": (blur, None, blur.norm_relu_blur_down_plain),
            "conv7x7_head_pallas": (head, None, head_plain),
            "conv3x3_int8": (quant, None, conv_int8.conv3x3_int8_plain),
            "run_in": (tin, None, tin.fused_instance_norm_plain),
            "run_in_res": (tin, None, tin.fused_instance_norm_residual_plain),
            "segment_dgrad": (encdec, "conv3x3_dgrad_fused", resblock.conv3x3_dgrad_fused_plain),
            "segment_wgrad": (encdec, "conv3x3_wgrad_fused", resblock.conv3x3_wgrad_fused_plain),
        }
        self.swaps = [(mod, attr or n, fn) for n, (mod, attr, fn) in swaps.items() if n in names]

    def __enter__(self):
        self.saved = [getattr(mod, attr) for mod, attr, _ in self.swaps]
        for mod, attr, fn in self.swaps:
            setattr(mod, attr, fn)

    def __exit__(self, *exc):
        for (mod, attr, _), fn in zip(self.swaps, self.saved):
            setattr(mod, attr, fn)


def kernel_vs_plain_route(torch, np, label: str, overrides: dict, batch: int,
                          per_forward: dict, exact_with_plain: tuple = (),
                          uint8_bound: bool = True, hw: tuple = (H, W)) -> None:
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
    ir, gt = (torch.from_numpy(a).cuda() for a in synthetic_batches(np, 1, batch, hw)[0])
    before = dict(LAUNCHES)
    if cfg.norm == "batch":
        calibrate_batch_norms(torch, model.module, lambda: infer(ir, gt), f"kernel route {label}")
        LAUNCHES.update(before)
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


def _train_setup(torch, np, n_batches: int = 4, hw: tuple = (H, W), **overrides):
    """The flagship config in train mode (with ``overrides``; at ``hw``),
    its state on the card, the random VGG tower, the step, and
    ``n_batches`` synthetic batches of 8."""
    from ircolor_tpu_torch.config import Config
    from ircolor_tpu_torch.losses.vgg import load_vgg16
    from ircolor_tpu_torch.train.state import create_train_state
    from ircolor_tpu_torch.train.step import make_train_step

    cfg = Config.from_json(FLAGSHIP.read_text()).replace(mode="train", seed=SEED, **overrides)
    if (cfg.resolved_hw, cfg.batch_size, cfg.compute_dtype) != (hw, TRAIN_B, "bf16"):
        raise AssertionError(f"{FLAGSHIP.name} no longer resolves to {hw} b{TRAIN_B} bf16 training")
    state = create_train_state(cfg, steps_per_epoch=1000, device="cuda")
    vgg = load_vgg16(None, SEED, torch.bfloat16).cuda()
    batches = [{"ir": torch.from_numpy(ir).cuda(), "rgb": torch.from_numpy(gt).cuda()}
               for ir, gt in synthetic_batches(np, n_batches, TRAIN_B, hw)]
    return cfg, state, vgg, make_train_step(cfg, vgg), batches


def profile_window(torch, label: str, run, what: str, top: int = 12, table: bool = False,
                   ours: bool = False) -> None:
    """torch.profiler over ``run()``: device time by kernel and the busy
    share of the window's wall time; with ``ours`` also every kernel of the
    port's own (``ircolor::``) and their sum; with ``table`` the full
    operator table goes to stderr."""
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
    if ours:
        mine = [e for e in kernels if "ircolor" in e.key]
        log(f"  the port's kernels: {sum(dev_us(e) for e in mine) / 1e3:.3f} ms of device time, "
            f"{sum(e.count for e in mine)} launches")
        for e in mine:
            log(f"    {dev_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:110]}")
    if table:
        print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60),
              file=sys.stderr, flush=True)


def train_step_phase(torch, np, label: str = "train", per_step: dict | None = None,
                     hw: tuple = (H, W), profile: bool = True, **overrides) -> tuple[dict, object]:
    """Phase 5: one warm-up and 3 timed training steps of the flagship
    config in train mode (with ``overrides``, at ``hw``); returns (launch
    counts of the 3 timed steps, the setup for phase 6)."""
    from ircolor_tpu_torch.kernels import LAUNCHES, reset_launches
    from ircolor_tpu_torch.train.loop import _check_loss_sanity
    from ircolor_tpu_torch.train.step import METRIC_KEYS

    cfg, state, vgg, step, batches = _train_setup(torch, np, 4, hw, **overrides)
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
    expect_launches(f"{label} (forwards = steps)", counts,
                    TRAIN_PER_STEP if per_step is None else per_step, n)
    for i, m in enumerate(metrics):
        vals = {k: float(m[k]) for k in METRIC_KEYS}
        _check_loss_sanity(vals, cfg, 1, i + 1)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    PEAK_GIB[label] = peak_gb
    log(f"[{label}] {hw[0]}x{hw[1]} b{TRAIN_B} bf16: {n * TRAIN_B / dt:.2f} frames/s "
        f"({1e3 * dt / n:.1f} ms per step), peak memory {peak_gb:.2f} GiB; last losses "
        + ", ".join(f"{k}={float(metrics[-1][k]):.4f}" for k in METRIC_KEYS))
    if profile:
        profile_window(torch, f"{label} profile", lambda: step(state, batches[1]), "one step",
                       table=label == "train")
    LAUNCHES.update(counts)
    return counts, (cfg, state, vgg, batches[0])


TRAIN_PER_STEP = {"conv3x3_reflect_fused": 18, "conv3x3_dgrad_fused": 18,
                  "conv3x3_wgrad_fused": 18}
PEAK_GIB: dict = {}  # peak device memory of each training phase, by label


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


def grads_vs_plain(torch, label: str, setup, swaps: tuple, unused: set):
    """The G gradient of one batch through the kernels, twice, and with the
    ``swaps`` wrappers on their plain versions (deterministic algorithms on
    for the rest of the network). Returns (losses bit-identical, kernel
    route bit-exact on repeat, per-parameter relative L2, faults): every
    parameter but ``unused`` needs a finite gradient on both routes;
    ``unused`` ones none. The conv biases that feed an instance norm are
    left out of the relative L2: their gradient is rounding noise around 0."""
    from ircolor_tpu_torch.kernels import LAUNCHES

    cfg, state, vgg, batch = setup
    names, params = zip(*state.g.named_parameters())
    before = dict(LAUNCHES)
    with deterministic(torch):
        loss_k, grad_k = g_grads(torch, cfg, state, vgg, batch, params)
        loss_k2, grad_k2 = g_grads(torch, cfg, state, vgg, batch, params)
        with plain_kernels(swaps):
            loss_p, grad_p = g_grads(torch, cfg, state, vgg, batch, params)
    LAUNCHES.update(before)
    same_loss = bool(torch.equal(loss_k, loss_p))
    repeat = bool(torch.equal(loss_k, loss_k2)) and all(
        (a is None and b is None) or torch.equal(a, b) for a, b in zip(grad_k, grad_k2))
    inert = {n for n in names if n.endswith(".bias") and n != "outc.1.bias"}
    rels, bad = {}, []
    for n, a, b in zip(names, grad_k, grad_p):
        if n in unused:
            if a is not None or b is not None:
                bad.append(f"{n}: a gradient on a route that does not read it")
            continue
        if a is None or b is None or not bool(torch.isfinite(a).all()):
            bad.append(f"{n}: no finite gradient")
            continue
        if n not in inert:
            rels[n] = float((a.float() - b.float()).norm() / b.float().norm())
    worst = max(rels, key=rels.get)
    log(f"[{label}] G gradient, kernels vs {', '.join(swaps)} on plain versions: losses "
        f"bit-identical {same_loss}; kernel route repeats bit for bit {repeat}; "
        f"{len(names) - len(unused)} of {len(names)} parameters finite and present "
        f"({len(unused)} unread); relative L2 max {rels[worst]:.3g} ({worst}), mean "
        f"{sum(rels.values()) / len(rels):.3g} over {len(rels)} parameters (tol 1e-2)")
    for n in ("inc.1.weight", "down1.0.weight", "down2.0.weight", "up1_conv.0.weight",
              "resblocks.0.conv_block.1.weight", "outc.1.weight"):
        log(f"    {n}: {rels[n]:.3g}")
    return same_loss, repeat, rels[worst], bad


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


# Phase 7's serving routes: (label, overrides, batch, quant, launches a
# forward). Batch norm gates every fused kernel off, so int8 runs the int8
# conv at all 24 sites; no_antialias turns the tails off and its down convs
# into the stride-2 form (counted apart); with the head on at b32 the int8
# enc/dec convs stay float and int8 rides in the fused blocks.
BN, NO_AA = {"norm": "batch"}, {"no_antialias": True}
NO_AA_BOTH = {"no_antialias": True, "no_antialias_up": True}
S2_SITES = {"conv3x3_int8": 22, "conv3x3_int8_s2": 2}
VARIANT_ROUTES = (
    ("batch int8", BN, B, True, {"conv3x3_int8": 24}),
    ("batch float", {**BN, "quant_int8": False}, B, False, {}),
    ("no_aa+up int8", NO_AA_BOTH, B, True, {"conv3x3_reflect_fused_q": 18, "conv7x7_head": 1}),
    ("batch no_aa int8", {**BN, **NO_AA}, B, True, S2_SITES),
)
REMAT_PER_STEP = {**TRAIN_PER_STEP, "conv3x3_reflect_fused": 36}  # + the recompute


def variant_phase(torch, np, counts: dict) -> None:
    """Phase 7: the generator variants ``Config`` reaches, at full width
    (the flagship config: 512×640, ngf 64, 9 blocks, random weights from
    seed 0, the batch norms calibrated on one batch, synthetic batches).
    Serving: each route of ``VARIANT_ROUTES`` at b32 (frames/s, launches,
    peak memory) and held kernel route against plain route (phase 4's
    budget; the int8-conv-only routes bit for bit with the int8 conv on its
    plain version); no_antialias int8 at b1
    (latency; down1 and down2 on the stride-2 form, the other 22 sites
    stride 1). Training at b8: ``remat`` (row 2 twice a block: the forward
    and its recompute) with the G gradient bit-identical to the same step
    without ``remat`` and its peak memory beside the flagship step's; and
    one ``norm="batch"`` step (no kernel: the norm gates them off) with
    finite losses and G's and D's running statistics moved."""
    from ircolor_tpu_torch.kernels import LAUNCHES, reset_launches
    from ircolor_tpu_torch.train.loop import _check_loss_sanity
    from ircolor_tpu_torch.train.step import METRIC_KEYS

    fps = {}
    for label, overrides, batch, quant, per_forward in VARIANT_ROUTES:
        fps[label] = serve(torch, np, label, overrides, quant, per_forward, counts,
                           profile=label.startswith("batch"))
    lat = latency_b1(torch, np, "no_aa int8", True, S2_SITES, counts, NO_AA)
    for label, overrides, batch, quant, per_forward in VARIANT_ROUTES:
        if per_forward:
            exact = ("conv3x3_int8",) if "conv3x3_int8" in per_forward else ()
            kernel_vs_plain_route(torch, np, label, overrides, batch, per_forward, exact)
    kernel_vs_plain_route(torch, np, "no_aa int8 b1", NO_AA, 1, S2_SITES, ("conv3x3_int8",))
    log("[variants] b32 frames/s: " + ", ".join(f"{k} {v:.2f}" for k, v in fps.items())
        + f"; no_aa int8 b1 {lat[0]:.3f} ms mean, {lat[1]:.3f} median")

    # remat: the flagship step with each block recomputed in the backward.
    counts["train remat"], setup = train_step_phase(torch, np, "train remat", REMAT_PER_STEP,
                                                    profile=False, remat=True)
    cfg, state, vgg, batch = setup
    params = [p for _, p in state.g.named_parameters()]
    before = dict(LAUNCHES)
    with deterministic(torch):
        loss_r, grad_r = g_grads(torch, cfg, state, vgg, batch, params)
        state.g.remat = False
        loss_n, grad_n = g_grads(torch, cfg, state, vgg, batch, params)
        state.g.remat = True
    LAUNCHES.update(before)
    same = bool(torch.equal(loss_r, loss_n)) and all(
        (a is None and b is None) or (a is not None and b is not None and torch.equal(a, b))
        for a, b in zip(grad_r, grad_n))
    log(f"[train remat] G gradient bit-identical to the step without remat: {same} (tol 0); "
        f"peak memory {PEAK_GIB['train remat']:.2f} GiB (without remat, phase 5: "
        f"{PEAK_GIB['train']:.2f} GiB)")
    if not same:
        raise AssertionError("remat changes the G gradient")
    del setup, state, grad_r, grad_n
    torch.cuda.empty_cache()

    # norm="batch" training: one step after a warm-up, no kernel launched.
    cfg, state, vgg, step, batches = _train_setup(torch, np, 2, norm="batch")
    stats0 = {f"{n}.{k}": v.clone() for n, net in (("G", state.g), ("D", state.d))
              for k, v in net.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    step(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    _, m = step(state, batches[1])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts["train batch"] = dict(LAUNCHES)
    expect_launches("train batch (forwards = steps)", counts["train batch"], {}, 1)
    vals = {k: float(m[k]) for k in METRIC_KEYS}
    _check_loss_sanity(vals, cfg, 1, 2)
    stats1 = {f"{n}.{k}": v for n, net in (("G", state.g), ("D", state.d))
              for k, v in net.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    moved = sum(not torch.equal(stats0[k], stats1[k]) for k in stats0)
    finite = all(bool(torch.isfinite(v).all()) for v in stats1.values())
    log(f"[train batch] {H}x{W} b{TRAIN_B} bf16 norm=batch: one step {1e3 * dt:.1f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; running statistics moved {moved} of "
        f"{len(stats0)}, finite {finite}; losses "
        + ", ".join(f"{k}={v:.4f}" for k, v in vals.items()))
    if moved != len(stats0) or not finite:
        raise AssertionError("norm=batch training: running statistics did not move")
    profile_window(torch, "train batch profile", lambda: step(state, batches[1]), "one step",
                   top=10)
    LAUNCHES.update(counts["train batch"])
    del state, vgg, batches
    torch.cuda.empty_cache()


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
    from ircolor_tpu_torch.kernels import LAUNCHES, build, reset_launches

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
    check_instance_norm(torch, results)
    check_bwd_kernels(torch, results)
    check_segment_kernels(torch, results)
    counts: dict = {}

    # Phase 2c: TPU kernels 7-10 (the JAX tools' functions at the flagship
    # stage shapes). The slice's path runs once with the counts set to 0.
    with torch.inference_mode():
        g5, w5, xs5 = slice5_setup(torch)
        check_slice5_kernels(torch, results, w5, xs5)
        slice5_compositions(torch, g5, w5, xs5)
        reset_launches()
        outs = slice5_path(torch, w5, xs5)
        torch.cuda.synchronize()
        counts["slice 5"] = dict(LAUNCHES)
        slice5_run = {"conv3x3_sum_fused": 2, "conv3x3_stats": 1, "conv3x3_norm_in_stats": 1,
                      "conv3x3_valid": 3, "blur_downsample": 2, "norm_relu_blur_down": 1}
        expect_launches("slice 5 path (forwards = runs)", counts["slice 5"], slice5_run, 1)
        for key, v in outs.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"slice 5 path: {key} not finite")
        log("[slice 5 path] outputs finite: "
            + ", ".join(f"{k} {tuple(v.shape)}" for k, v in outs.items()))
        del g5, w5, xs5, outs
    torch.cuda.empty_cache()
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
    # use_pallas at 256² (float, the test batch of 16): kernel 11 at the 9
    # blocks' two instance norms (the 64×64 bottleneck is the one plane its
    # gate admits), the down1 tail (its plane and launch gates hold; down2's
    # plane is under them), no head, no block conv (4,096 px < 12,288, b16
    # outside the band). Without use_pallas: the tail only. Turns: without,
    # with, with, without.
    hw256, b256 = (256, 256), 16
    flat256 = dict(img_height=256, img_width=256, quant_int8=False)
    k11 = {"fused_instance_norm": 9, "fused_instance_norm_residual": 9, "norm_relu_blur_down": 1}
    fps256 = {"float": [], "float use_pallas": []}
    for label in ("float", "float use_pallas", "float use_pallas", "float"):
        pallas = label.endswith("use_pallas")
        fps256[label].append(serve(
            torch, np, f"256x256 {label}", {**flat256, "use_pallas": pallas}, False,
            k11 if pallas else {"norm_relu_blur_down": 1}, counts, hw256, b256, n_batches=12))
    kernel_vs_plain_route(torch, np, "256x256 float use_pallas", {**flat256, "use_pallas": True},
                          b256, k11, hw=hw256)
    log(f"[serve] 512x640 b32: int8 {fps_int8:.2f} frames/s, float {fps_float:.2f} frames/s, "
        f"int8 (b) quant_head + quant_fixed_u2 {fps_b:.2f} frames/s")
    log("[serve] 256x256 b16 float: without use_pallas "
        + " / ".join(f"{v:.2f}" for v in fps256["float"]) + " frames/s, with "
        + " / ".join(f"{v:.2f}" for v in fps256["float use_pallas"]) + " frames/s")
    log(f"[serve] 512x640 b1 latency (mean / median ms per frame): int8 (a) "
        f"{lat_int8[0]:.3f} / {lat_int8[1]:.3f}, float {lat_float[0]:.3f} / {lat_float[1]:.3f}")
    counts["train"], setup = train_step_phase(torch, np)
    bwd_vs_xla(torch, setup)
    del setup
    torch.cuda.empty_cache()
    counts["train tails+head"] = train_tail_head_phase(torch, np)

    # The enc/dec segment backward (pallas_encdec_bwd) at 512×640 b8: down1,
    # down2 and up1 each one segment dgrad; down2 one and up1 two segment
    # wgrads (down1's 64-channel leg: cuDNN from the stored dy).
    seg_step = {**TRAIN_PER_STEP, "conv3x3_dgrad_fused_seg": 3, "conv3x3_wgrad_fused_seg": 3}
    counts["train encdec"], setup = train_step_phase(
        torch, np, "train encdec", seg_step, pallas_encdec_bwd=True)
    blocks_and_segments = {f"resblocks.{i}.conv_block.{j}.bias" for i in range(9) for j in (1, 5)}
    blocks_and_segments |= {"down1.0.bias", "down2.0.bias", "up1_conv.0.bias"}
    same_loss, repeat, worst, bad = grads_vs_plain(
        torch, "train encdec", setup, ("segment_dgrad", "segment_wgrad"), blocks_and_segments)
    if bad or not (same_loss and repeat and worst <= 1e-2):
        raise AssertionError(f"encdec backward disagrees with its plain version: {bad or worst}")
    del setup
    torch.cuda.empty_cache()

    # use_pallas training at 256² b8: kernel 11 at the 9 unfused blocks
    # (the blocks' fused gate fails: 4,096 px, b8), forward only; the
    # backward is plain torch. Beside the same step without use_pallas.
    counts["train 256x256"], setup = train_step_phase(
        torch, np, "train 256x256", {}, hw256, profile=False, img_height=256, img_width=256)
    del setup
    counts["train 256x256 use_pallas"], setup = train_step_phase(
        torch, np, "train 256x256 use_pallas",
        {"fused_instance_norm": 9, "fused_instance_norm_residual": 9}, hw256,
        img_height=256, img_width=256, use_pallas=True)
    _, repeat, worst, bad = grads_vs_plain(torch, "train 256x256 use_pallas", setup,
                                           ("run_in", "run_in_res"), set())
    if bad or not (repeat and worst <= 1e-2):
        raise AssertionError(f"use_pallas gradient disagrees with the plain forwards: {bad or worst}")
    del setup
    torch.cuda.empty_cache()

    variant_phase(torch, np, counts)

    # The product's serving and training routes launch none of kernels
    # 7-10 (the JAX generator routes to none of them; expect_launches held
    # each run to 0 for every kernel it does not name); say so once.
    slice5 = ("blur_downsample", "conv3x3_valid", "conv3x3_stats", "conv3x3_norm_in_stats",
              "conv3x3_sum_fused")
    stray = {run: {k: c[k] for k in slice5 if c[k]} for run, c in counts.items() if run != "slice 5"}
    stray = {run: c for run, c in stray.items() if c}
    log(f"[product routes] launches of kernels 7-10 over {len(counts) - 1} serving and training "
        f"runs: {stray or 'none'}")
    if stray:
        raise AssertionError(f"a product route launched a kernel of rows 7-10: {stray}")

    # launches: each kernel's count in the main-path run at the shape its
    # row is timed and bounded at — serving (int8 default) for the int8
    # block conv, tails and head; float serving (b32) for the bf16 block
    # conv; the training step (b8) for the backward kernels; configuration
    # (a) at batch 1 for the int8 conv; configuration (b) for the int8 head.
    main_run = {"conv3x3_reflect_fused_q": "int8", "norm_relu_blur_down": "int8",
                "conv7x7_head": "int8", "conv3x3_reflect_fused": "float",
                "conv3x3_dgrad_fused": "train", "conv3x3_wgrad_fused": "train",
                "conv3x3_int8": "b1 int8 (a)", "conv7x7_head_q": "int8 (b)",
                "conv3x3_int8_s2": "batch no_aa int8",
                "fused_instance_norm": "256x256 float use_pallas",
                "fused_instance_norm_residual": "256x256 float use_pallas",
                "conv3x3_dgrad_fused_seg": "train encdec",
                "conv3x3_wgrad_fused_seg": "train encdec",
                **{name: "slice 5" for name in slice5}}
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
