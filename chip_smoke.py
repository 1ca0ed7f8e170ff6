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
   one GEMM launch reading the input through strided TMA boxes, counted
   by ``torch.profiler``, timed beside its GEMM alone, the reflect pad's
   pass and GEMM apart, bit-exact, beside ``torch._int_mm`` over a
   stride-2 im2col), the float head (4, within 2
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

8. Spatial test mode on a 1-D H mesh of this card (every shard on
   cuda:0, S = 2 and 4): (a) rows 1 and 2 in their halo forms at the
   flagship bottleneck split into S shards (row 1 at b32, row 2 at b4),
   each against its plain version (row 1: ≤ 2.5 quant steps, ≤ 1e-3
   differing; row 2: 2 bf16 ulps), the provided form bit-identical to the
   separate one, conv1 on each shard bit-identical to the same rows of the
   unsharded kernel's output, the summed statistics within 1e-5 relative
   of the unsharded kernel's; timed beside the bound and the library call
   on the halo slab, each call (and its operand pass and GEMM alone) also
   as device / host ms a call: events around calls the card runs back to
   back behind a ``torch.cuda._sleep``, the host clock around their
   enqueue. (b) ``make_infer_fn`` over ``spatial_generator`` for
   int8 b32 and float b4 at S = 2 and 4, against the unsharded step with
   the same rebuild (tails and head off) and against the same spatial step
   with rows 1 and 2 on their plain versions (phase 4's budget each; the
   int8 cells to its metric part and a uint8 mean |d| of at most 1.5× the
   unsharded route's own kernel-vs-plain distance, with the route
   bit-identical when the int8 conv runs its plain version and on repeat);
   |d| on the rows by the seams against the interior rows' (≤ 1.5×), a
   check that must flag an injected seam fault (and, in the float cell, a
   single wrong halo row in one bottleneck conv); 18·S halo-form launches a
   forward (int8: and 6·S int8 convs); frames/s and peak memory beside the
   unsharded steps'. (c) The same at 488×640 and S = 4, whose shards are
   unequal inside the generator (61 rows after the first stride-2 stage,
   31, 30, 31, 30 at the bottleneck): the blocks run their plain ops with
   their halos, as JAX's do, the int8 conv at 24·S sites a forward (float:
   no kernel), against the unsharded rebuild at that height.

9. The ``export`` mode (``ircolor_tpu_torch/export/aot.py``) at the
   flagship, on phase 3's batches: the int8 and float ``keep_pallas``
   artifacts at b32 (the serving kernels inside the graph as
   ``torch.library`` ops) exported, saved, loaded and run: each must hold
   a kernel, one call must launch what the eager forward launches (18 /
   2 / 1), and its uint8 output must match the eager ``make_infer_fn``
   step within one level on ≥ 99.9% of values (identical expected);
   frames/s of the artifact beside the eager generator + uint8 step in
   turns (eager, artifact, artifact, eager), export and load time and
   size. Then the portable artifacts (aten ops only), float at b32 and
   int8 at b2 (its int8 convs on their plain version, unrolled over
   images and taps): no ``ircolor::`` op, loaded and run by a process
   that cannot import the port, held to phase 4's budget against the
   eager step with the four kernel gates off.

10. Data parallelism on this one card, at the flagship: (a) test mode
   over a data mesh of two entries on cuda:0 (``dp_devices=2``: chunks of
   16), int8 and float b32, against the unsharded b32 step on the same
   weights and batches (phase 4's budget; bit-identical or not, said), 2 ×
   (18 / 2 / 1) launches a batch by the wrappers' counts and, for every
   port kernel, twice the unsharded step's by ``torch.profiler``, frames/s
   beside the unsharded step in turns; (b) two training ranks spawned on
   cuda:0 over gloo, ``dp_mode="shard_map"`` and then the default
   ``"gspmd"``, global b8 (b4 a rank), 4 steps a mode on fixed synthetic
   batches: the parameters bit-identical across the ranks after every
   step, against one process's b8 step from the same weights the first
   step's losses that D' does not enter (2^-10 relative; gspmd against
   shard_map too), G's and D's conv weight gradients (1e-2 relative L2)
   and their Adam update (lr/4 on ≥ 99%), the rest read out, 18 / 18 / 18
   launches of rows 2, 5, 6 a step on each rank in both modes, step time,
   the all-reduce's share and peak memory a rank beside the one-process
   step; (c) a one-rank NCCL group through the
   same launcher and its all-reduce. Two ranks on one card are no
   multi-card speed-up.

11. Spatial training (``sp_devices`` S, every H-shard on cuda:0) at the
   flagship, bf16 b8, S = 2 and 4: one step (the warm-up) and 3 timed a
   cell, beside the unsharded step with the same routing (every fused
   kernel off, as under sp) and phase 5's kernel step; the first step held
   against the unsharded one (the losses D' does not enter within 2^-10
   relative, G's and D's conv weight gradients within 1e-2 relative L2,
   their Adam update within lr/4 on ≥ 99%: phase 10b's bounds); no kernel
   launched (JAX's spatial step runs no Pallas kernel); step ms, frames/s
   and peak memory. Then an f32 cell at b2, S = 2, to the CPU parity
   bounds (losses 1e-5 relative, live leaves' gradients 1e-4 relative L2,
   the Adam update within lr/4 on ≥ 99%), its G phase against the
   unsharded G phase on its own D'. Shards on one card are no multi-card
   speed-up.

Prints a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
# The flagship's config, shapes, seed, synthetic frames and serving budget,
# shared with tools/dp_probe.py (a checkout's package; alone, this fails).
from ircolor_tpu_torch.tools.flagship import (  # noqa: E402
    B,
    FLAGSHIP,
    H,
    NGF,
    SEED,
    TRAIN_B,
    W,
    route_delta,
    serving_config,
    synthetic_batches,
    within_budget,
)

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


# The first hold of the stream in split_time_ms: ~10 ms at the H100's
# 1.98 GHz boost clock, 4× longer each time the host outlasts it.
HOLD_CYCLES = 20_000_000


def split_time_ms(fn, iters: int = 10, readings: int = 3, warmup: int = 2) -> list:
    """``readings`` readings of one call of ``fn`` three ways, each over
    ``iters`` calls: (device ms, host ms, event ms). Device: CUDA events
    around the calls, recorded while ``torch.cuda._sleep`` holds the
    stream until the host has enqueued them all (the start event still
    pending when the host is done; else the hold grows), so the card runs
    them back to back; host: ``time.perf_counter`` around that enqueue;
    event: ``cuda_time_ms``, the events around calls that the card may
    wait on the host for."""
    import torch

    for _ in range(warmup):
        fn()
    out = []
    for _ in range(readings):
        cycles = HOLD_CYCLES
        while True:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            start.record()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            host = (time.perf_counter() - t0) * 1e3 / iters
            held = not start.query()
            end.record()
            torch.cuda.synchronize()
            if held:
                break
            if cycles >= 64 * HOLD_CYCLES:
                raise AssertionError(f"split_time_ms: the host outlasted a hold of {cycles} cycles")
            cycles *= 4
        out.append((start.elapsed_time(end) / iters, host, cuda_time_ms(fn, iters, 0)))
    return out


def split_text(readings: list) -> str:
    """Readings of ``split_time_ms`` as "device / host / event ms" each."""
    return ", ".join(f"{d:.4f} / {h:.4f} / {e:.4f}" for d, h, e in readings)


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
    # Its N = 64 forms (the wave rule's pick at small grids: the halo forms
    # at b4, the b2 band) must issue wgmma and spill nothing.
    check_gemm_build("bf16 conv", ("stats", "store"), (64,))
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
        # The route's one call (quantized on load) against the pass and GEMM
        # launched apart, bit for bit, both timed.
        plan = resblock._conv_plan(B, hb, wb, (cb,), cb, "reflect", s8=True)
        kt = resblock.q_pack(kq)

        def two_launches():  # the parent's path (its tile sums by torch)
            return resblock._q_gemm(resblock._q_pass(x, **kw), kt, sc, plan)[1].sum(dim=1)

        one = resblock._q_fused(x, kt, sc, plan, **kw)
        out, part = resblock._q_gemm(resblock._q_pass(x, **kw), kt, sc, plan)
        same = torch.equal(one[0], out) and torch.equal(one[1], resblock._tile_sum_plain(part))
        del out, part
        t_one = cuda_time_ms(lambda: resblock._q_fused(x, kt, sc, plan, **kw), 10)
        t_two = cuda_time_ms(two_launches, 10)
        parts += (f"\n    one call, quantized on load: {t_one:.4f} ms against the pass and GEMM "
                  f"launched apart {t_two:.4f}; output and in-order sums bit-identical: {same}")
        if not same:
            raise AssertionError(f"conv3x3_reflect_fused_q {label}: the one call differs from "
                                 f"the two launches")
        del one
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
    q-conv GEMM at N = 64 reads the input through TMA boxes with element
    strides of 2, three stages a chunk; no pass for zero halos): each site
    against ``conv3x3_int8_plain(..., stride=2)`` (tolerance 0) and
    bit-exact on repeat, the kernels one call launches counted by
    ``torch.profiler`` (zero pad: the GEMM alone; reflect: the int8
    reflect pass and the GEMM), the call timed beside its GEMM alone (TOP/s
    each), ``torch._int_mm`` over a stride-2 im2col (the GEMM alone) and
    the bound; the reflect pad (on no route) at down1 with its launches
    timed apart; the instantiation's ptxas line and IGMMA count (a spill
    fails the run). The row sums the two b32 sites: one b32 forward's
    stride-2 launches."""
    from torch.profiler import ProfilerActivity, profile

    from ircolor_tpu_torch.kernels import conv_int8, resblock

    check_gemm_build("int8 conv s2", ("q-conv s2",), (64,))
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0)

    def launched(fn) -> dict:
        """The kernels a call of ``fn`` launches, by ``torch.profiler``: the
        conv's GEMMs and reflect passes, the most in either of two calls
        profiled apart (a profiler window can miss a launch's record; a
        kernel the call launches shows in one of two), and the names of the
        others (PyTorch's)."""
        got = dict(gemm=0, passes=0, other=set())
        for _ in range(2):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
            gemm = [n for n in names if "conv_fwd_gemm_kernel" in n]
            passes = [n for n in names if "operand_pass_kernel" in n]
            got["gemm"] = max(got["gemm"], len(gemm))
            got["passes"] = max(got["passes"], len(passes))
            got["other"] |= {n[:60] for n in names if n not in gemm and n not in passes}
        return got

    def gemm_ms(xq, wq, sc, pad, bias) -> float:
        """The plan's GEMM alone on ``pad``'s source."""
        bb, hh, ww, cin = xq.shape
        ho, wo = conv_int8.out_hw(hh, ww, pad, 2)
        p = conv_int8._plan(bb, ho, wo, cin, wq.shape[-1], pad, 2)
        src, kt = conv_int8._source(xq, pad), resblock._q_weights(wq, p)
        return cuda_time_ms(lambda: conv_int8._gemm(src, kt, sc, p, bias=bias), 20)

    def int8(*shape):
        return torch.randint(-127, 128, shape, device=dev, generator=gen, dtype=torch.int8)

    for label, bb, hh, ww, cin, cout in INT8_S2_SITES:
        xq, wq = int8(bb, hh, ww, cin), int8(3, 3, cin, cout)
        sc = torch.rand(bb, cout, device=dev, generator=gen) * 1e-4
        kw = dict(pad="zero", stride=2, bias=torch.randn(cout, device=dev, generator=gen))
        got = conv_int8.conv3x3_int8(xq, wq, sc, **kw)
        want = conv_int8.conv3x3_int8_plain(xq, wq, sc, **kw)
        exact = bool(torch.equal(got, want))
        repeat = bool(torch.equal(got, conv_int8.conv3x3_int8(xq, wq, sc, **kw)))
        ran = launched(lambda: conv_int8.conv3x3_int8(xq, wq, sc, **kw))
        ms = cuda_time_ms(lambda: conv_int8.conv3x3_int8(xq, wq, sc, **kw), 20)
        pms = cuda_time_ms(lambda: conv_int8.conv3x3_int8_plain(xq, wq, sc, **kw), 1, 1)
        ho, wo = conv_int8.out_hw(hh, ww, "zero", 2)
        plan = conv_int8._plan(bb, ho, wo, cin, cout, "zero", 2)
        g_ms = gemm_ms(xq, wq, sc, "zero", kw["bias"])
        ops = 2 * bb * ho * wo * 9 * cin * cout
        if (ran["gemm"], ran["passes"]) != (1, 0):
            raise AssertionError(f"conv3x3_int8 s2 {label} zero pad launched {ran}, not the "
                                 f"GEMM alone")
        if label == "down1":  # the reflect pad: the int8 reflect pass, then the VALID GEMM
            rkw = dict(kw, pad="reflect")
            rgot = conv_int8.conv3x3_int8(xq, wq, sc, **rkw)
            exact = exact and bool(torch.equal(rgot, conv_int8.conv3x3_int8_plain(xq, wq, sc, **rkw)))
            del rgot
            rran = launched(lambda: conv_int8.conv3x3_int8(xq, wq, sc, **rkw))
            rms = cuda_time_ms(lambda: conv_int8.conv3x3_int8(xq, wq, sc, **rkw), 10)
            tp = cuda_time_ms(lambda: conv_int8._pad(xq), 10)
            rg = gemm_ms(xq, wq, sc, "reflect", kw["bias"])
            log(f"[conv3x3_int8 s2 {label} reflect] bit-exact: {exact}; launched {rran}; "
                f"{rms:.4f} ms = reflect pass {tp:.4f} + GEMM {rg:.4f} ms")
            if (rran["gemm"], rran["passes"]) != (1, 1):
                raise AssertionError(f"conv3x3_int8 s2 {label} reflect pad launched {rran}")
        del got, want
        cols = im2col_int8(torch, xq, "zero", 2)
        wmat = wq.reshape(9 * cin, cout).t().contiguous().t()
        lib_ms = cuda_time_ms(lambda: torch._int_mm(cols, wmat), 10)
        del cols
        npix = bb * ho * wo
        nbytes = xq.numel() + 9 * cin * cout + bb * cout * 4 + cout * 4 + npix * cout * 2
        b_ms, b_by = bound(ops, nbytes, PEAK_INT8)
        log(f"[conv3x3_int8 s2 {label} {bb}x{hh}x{ww}x{cin}->{ho}x{wo}x{cout} zero] bit-exact: "
            f"{exact} (tol 0), repeat bit-exact: {repeat}; launched {ran} (torch.profiler: "
            f"{ran['gemm']} GEMM, {ran['passes']} pass); kernel {ms:.4f} ms "
            f"({ops / ms / 1e9:.1f} TOP/s, {plan.blocks} output blocks of N {plan.bn}); GEMM "
            f"alone {g_ms:.4f} ms {ops / g_ms / 1e9:.1f} TOP/s; plain {pms:.3f} ms; _int_mm over "
            f"a stride-2 im2col {lib_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: ops "
            f"{ops / PEAK_INT8 * 1e3:.4f}, bytes {nbytes / PEAK_BYTES * 1e3:.4f})")
        if not (exact and repeat):
            raise AssertionError(f"conv3x3_int8 s2 {label} disagrees with its plain version")
        row["ms"] += ms
        row["plain_ms"] += pms
        row["library_ms"] += lib_ms
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
    "tile sum" (the in-order sum of a conv's tile partials), "q fused"
    (the int8 block conv that quantizes on the A load) or
    "head bf16 kK" / "head s8 kK" for
    csrc/head.cu's instantiations (K MMA K steps a staged unit; "multi":
    the one for C past 64 channels, several units a row)."""
    import re

    found = re.search(r"head_kernelILb(\d)ELi(\d+)ELb(\d)E", name)
    if found:
        multi = " multi" if found[3] == "1" else ""
        return f"head {'s8' if found[1] == '1' else 'bf16'} k{found[2]}{multi}"
    if "conv_q_fused" in name:
        return "q fused"
    if "operand_pass" in name:
        return "pass q8" if "ILb1E" in name else "pass"
    if "tile_sum" in name:
        return "tile sum"
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
        elif name and ("registers" in line or "spill" in line or "Performance Loss" in line):
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
    plan = resblock._conv_plan(b, h, w, tuple(x.shape[-1] for x in legs), cout, halo,
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


def check_gemm_build(what: str, policies: tuple, bns: tuple = (128, 64),
                     keys: tuple = ()) -> None:
    """Every instantiation of csrc/conv_fwd.cu's GEMM with one of
    ``policies`` at the N of ``bns``, and every kernel of ``keys`` (by
    ``kernel_key``), issues ``wgmma`` (HGMMA or IGMMA) and spills nothing;
    their ptxas lines are printed."""
    ptx, hg = ptxas_lines("conv_fwd"), hgmma_by_kernel("conv_fwd")
    for key in [f"gemm n{bn} {policy}" for bn in bns for policy in policies] + list(keys):
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
        for ir, gt in synthetic_batches(n_batches, batch, hw)
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
    ir, gt = (torch.from_numpy(a).cuda() for a in synthetic_batches(1, B1_FRAMES)[0])
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
    ir, gt = (torch.from_numpy(a).cuda() for a in synthetic_batches(1, batch, hw)[0])
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
    delta = route_delta(pred_k, m_k, pred_p, m_p)
    log(f"[kernel vs plain route, {label}, b{batch}] kernels run {ran}; "
        f"repeat bit-identical: {repeat}; {delta['text']}")
    expect_launches(f"kernel route {label}", ran, per_forward, 1)
    if not (repeat and same_swapped):
        raise AssertionError(f"{label}: kernel-route runs differ (repeat {repeat}, "
                             f"new kernels on plain versions {same_swapped})")
    if not within_budget(delta, uint8_bound):
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
               for ir, gt in synthetic_batches(n_batches, TRAIN_B, hw)]
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
    STEP_MS[label] = 1e3 * dt / n
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
STEP_MS: dict = {}  # ms a step of each training phase, by label


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


# Phase 8: spatial test mode on a 1-D H mesh of one card (every shard on
# cuda:0): the H-shard counts, and the serving cells (label, int8, batch):
# int8 at the default b32, float at b4 (the small-batch band, where the
# float blocks' per-shard gate holds).
SP_SHARDS = (2, 4)
SP_CELLS = (("int8", True, B), ("float", False, 4))
# Phase 8c: a height whose shards are unequal inside the generator. 488
# rows over 4 shards: 122 rows a shard, 61 (odd) after the first stride-2
# stage, 31, 30, 31, 30 at the bottleneck (the fused halo blocks off).
SP_UNEQUAL_H, SP_UNEQUAL_SHARDS = 488, (4,)
# The int8 cells' uint8 limit, set from readings: the spatial step's mean
# |d| to the unsharded step at most SP_INT8_NOISE_K × the unsharded route's
# own distance between its kernel and plain rows 1 and 2 in the same run
# (on an H100 the cells read 2.45-2.46 against 1.89: 1.30×).
SP_INT8_NOISE_K = 1.5
# The seam check: the mean uint8 |d| to the unsharded step on the rows
# within SEAM_BAND rows of a shard seam, over the mean on the rows at least
# SEAM_FAR rows from every seam, at most SEAM_RATIO_MAX. Sum-order noise
# is spread over the image; a wrong halo row lands at the seams.
SEAM_BAND, SEAM_FAR, SEAM_RATIO_MAX = 8, 32, 1.5


def check_halo_kernels(torch, results: list) -> None:
    """Phase 8a: rows 1 and 2 in their halo forms at the flagship
    bottleneck split into S = 2 and 4 (row 1 at b32, row 2 at b4, the
    spatial cells' batches), both forms each (conv1: raw input; conv2:
    normalize + ReLU on load, by the image's IN moments). On every shard
    the separate form against its plain version (row 1: ≤ 2.5 quant steps,
    ≤ 1e-3 differing; row 2: 2 bf16 ulps), the provided form (the same
    slab) and the pass and GEMM launched apart (row 1: the two-launch path
    it ran before it quantized on load) bit-identical to it, its raw output
    (conv1 and conv2) bit-identical to the same rows of the unsharded
    kernel's, shard 1 with its own first row as its top halo row flagged
    by that check, and the sums added over the shards within 1e-5 relative
    of the unsharded kernel's moments; row 1's new kernel must build with
    IGMMA and no spill, and a halo call launch it and no operand pass
    (``torch.profiler``). Timed at the shard shape of S = 2 (the row in
    the kernels line) and of S = 4, beside the bound, the plain version
    and the library call on the halo slab (row 2: cuDNN of the W-padded
    slab; row 1: ``torch._int_mm`` over an int8 im2col of its quantized
    padded slab). Each timed call (both forms; row 1's two-launch path;
    the operand pass and the GEMM alone; the library call) is read three
    times three ways, device / host / event ms (``split_time_ms``); the
    row's ``ms`` and ``library_ms`` are the event readings' means. Returns
    the readings by row name, S and part."""
    import torch.nn.functional as F

    from ircolor_tpu_torch.kernels import LAUNCHES, resblock
    from ircolor_tpu_torch.ops.norm import instance_norm_stats
    from ircolor_tpu_torch.ops.quant import _QCLIP, quantize_weight_per_channel
    from ircolor_tpu_torch.parallel.spatial import all_sum, exchange_halo_rows, shard_h

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    before = dict(LAUNCHES)
    splits: dict = {}
    hb, wb, cb = H // 4, W // 4, NGF * 4
    check_gemm_build("int8 block conv", (), keys=("q fused",))

    def two_launch(xi, hr, args, kw):
        """The halo form's pass and GEMM launched apart, their tile sums
        added in order: bf16 ``_conv_pass`` + ``_conv_gemm``; int8 the
        two-launch path that 1h ran before it quantized on load."""
        hl = xi.shape[1]
        if len(args) == 1:
            plan = resblock._conv_plan(xi.shape[0], hl, wb, (cb,), cb, "reflect",
                                       norm="mean" in kw)
            out, part = resblock._conv_gemm(
                [resblock._conv_pass(xi, **kw, halo="separate", halo_rows=hr)], list(args),
                plan, True)
        else:
            plan = resblock._conv_plan(xi.shape[0], hl, wb, (cb,), cb, "reflect", s8=True)
            out, part = resblock._q_gemm(resblock._q_pass(xi, **kw, halo="separate",
                                                          halo_rows=hr),
                                         resblock._q_weights(args[0], plan), args[1], plan)
        return out, resblock._tile_sum_plain(part)
    k = (torch.randn(3, 3, cb, cb, device=dev, generator=gen) * 0.05).to(torch.bfloat16)
    kq, sw = quantize_weight_per_channel(k)
    for name, quant, b in (("conv3x3_reflect_fused_q_halo", True, B),
                           ("conv3x3_reflect_fused_halo", False, 4)):
        x = torch.randn(b, hb, wb, cb, device=dev, generator=gen).to(torch.bfloat16)
        m0, i0 = instance_norm_stats(x)
        if quant:
            amax = x.float().abs().amax(dim=(1, 2, 3)).clamp(min=1e-12)
            sc1 = ((amax / 127.0)[:, None] * sw[None, :]).contiguous()
            sc2 = ((_QCLIP / 127.0) * sw[None, :]).expand(b, -1).contiguous()
            forms = (("conv1", (kq, sc1), dict(qscale=(127.0 / amax).contiguous())),
                     ("conv2", (kq, sc2), dict(mean=m0, inv=i0)))
            fn, plain = resblock.conv3x3_reflect_fused_q, resblock.conv3x3_reflect_fused_q_plain
        else:
            forms = (("conv1", (k,), {}), ("conv2", (k,), dict(mean=m0, inv=i0)))
            fn, plain = resblock.conv3x3_reflect_fused, resblock.conv3x3_reflect_fused_plain
            check_n64_bits(torch, x, k, forms)
        errs, timing = [], {}
        for n in SP_SHARDS:
            xs = shard_h(x, [dev] * n)
            halos = exchange_halo_rows(xs, 1)
            hl = hb // n
            for form, args, kw in forms:
                one = fn(x, *args, **kw)
                sums, worst, frac = [], 0.0, 0.0
                for i, (xi, hr) in enumerate(zip(xs, halos)):
                    got = fn(xi, *args, **kw, halo="separate", halo_rows=hr, sums=True)
                    slab = torch.cat([hr[0], xi, hr[1]], dim=1).contiguous()
                    prov = fn(slab, *args, **kw, halo="provided", sums=True)
                    want = plain(xi, *args, **kw, halo="separate", halo_rows=hr)
                    d = (got[0].float() - want[0].float()).abs()
                    if quant:
                        worst = max(worst, float((d / (args[1] * 127.0)[:, None, None, :]).max()))
                        frac = max(frac, float((d > want[0].float().abs() * 2.0**-8).float().mean()))
                        ok = worst <= 2.5 and frac <= 1e-3
                    else:
                        worst = max(worst, float(d.max()) / float(want[0].float().abs().max()))
                        ok = worst <= 2 * 2.0**-8
                    same = all(torch.equal(a, c) for a, c in zip(got, prov))
                    # The image's rows (conv2: its IN moments on every shard) and the
                    # GEMM's per-pixel K order: the unsharded kernel's rows, bit for bit.
                    rows = torch.equal(got[0], one[0][:, i * hl : (i + 1) * hl])
                    # The one C call against the pass and GEMM launched apart (int8: the
                    # parent's two-launch path), output and in-order sums bit for bit.
                    two = two_launch(xi, hr, args, kw)
                    same = same and torch.equal(got[0], two[0]) and torch.equal(got[1], two[1])
                    if i == 1:  # a single wrong halo row at the kernel: the rows check flags it
                        bad = fn(xi, *args, **kw, halo="separate", sums=True,
                                 halo_rows=(xi[:, :1].contiguous(), hr[1]))
                        if torch.equal(bad[0], one[0][:, hl : 2 * hl]):
                            raise AssertionError(f"{name} {form} S={n}: shard 1 with its own "
                                                 f"first row as its top halo row is not flagged")
                        del bad
                    if not (ok and same and rows):
                        raise AssertionError(f"{name} {form} S={n} shard {i}: plain ok {ok}, "
                                             f"provided = separate = the pass and GEMM "
                                             f"launched apart {same}, rows {rows}")
                    errs.append(float(d.max()))
                    sums.append(got[1])
                s = all_sum(sums)[0]
                m, inv = resblock._moments(s[:, 0], s[:, 1], hb * wb)
                rel = max(float((m - one[1]).abs().max() / one[1].abs().max()),
                          float(((inv - one[2]) / one[2]).abs().max()))
                what = "quant steps (tol 2.5), differing share " + f"{frac:.3g}" if quant \
                    else "of the output's scale (tol 2 bf16 ulps)"
                log(f"[{name} {form} S={n}] local {tuple(xs[0].shape)}: max|d| vs plain "
                    f"{worst:.4g} {what}; provided = separate = the pass and GEMM launched "
                    f"apart, rows = unsharded kernel rows, shard 1 with a wrong top halo row "
                    f"flagged; summed moments vs unsharded {rel:.3g} relative (tol 1e-5)")
                if rel > 1e-5:
                    raise AssertionError(f"{name} {form} S={n}: summed moments {rel:.3g}")
            # Times at the shard shape, shard 0: each call three ways
            # (split_time_ms), conv1 and conv2, the operand pass and the GEMM
            # alone, and the library call.
            x0, hr0 = xs[0], halos[0]
            plan = resblock._conv_plan(b, hl, wb, (cb,), cb, "reflect", s8=quant)
            split = {f"kernel {form}": split_time_ms(
                lambda: fn(x0, *args, **kw, halo="separate", halo_rows=hr0, sums=True))
                for form, args, kw in forms}
            pms = [cuda_time_ms(lambda: plain(x0, *args, **kw, halo="separate", halo_rows=hr0),
                                1, 1) for _, args, kw in forms]
            slab = torch.cat([hr0[0], x0, hr0[1]], dim=1).contiguous()
            if quant:
                kw1, sc1 = forms[0][2], forms[0][1][1]
                names = kernels_launched(torch, lambda: fn(x0, kq, sc1, **kw1, halo="separate",
                                                           halo_rows=hr0, sums=True))
                log(f"    S={n}: one halo call launches {names} (torch.profiler)")
                if any("operand_pass" in k for k in names) or not any(
                        "conv_q_fused" in k for k in names):
                    raise AssertionError(f"the int8 halo form launches {names}")
                zq = resblock._q_pass(x0, **kw1, halo="separate", halo_rows=hr0)
                kt = resblock._q_weights(kq, plan)
                split["two launches conv1"] = split_time_ms(  # the parent's path
                    lambda: resblock._q_gemm(resblock._q_pass(x0, **kw1, halo="separate",
                                                              halo_rows=hr0),
                                             resblock._q_weights(kq, plan), sc1,
                                             plan)[1].sum(dim=1))
                split["pass"] = split_time_ms(
                    lambda: resblock._q_pass(x0, **kw1, halo="separate", halo_rows=hr0))
                split[f"GEMM N={plan.bn}"] = split_time_ms(
                    lambda: resblock._q_gemm(zq, kt, sc1, plan))
                cols = torch.empty((b, hl, wb, 9, cb), dtype=torch.int8, device=dev)
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    cols[:, :, :, tap] = zq[:, dy : dy + hl, dx : dx + wb]
                cols = cols.reshape(b * hl * wb, 9 * cb)
                wmat = kq.reshape(9 * cb, cb).t().contiguous().t()
                split["library"] = split_time_ms(lambda: torch._int_mm(cols, wmat))
                lib_what = f"torch._int_mm over the slab's int8 im2col ({cols.numel() / 1e9:.2f} GB)"
                del cols, zq, kt
                b_ms, b_by = bound(2 * b * hl * wb * 9 * cb * cb,
                                   2 * x0.numel() * 2 + 4 * b * wb * cb + 9 * cb * cb
                                   + b * cb * 4 * 3, PEAK_INT8)
            else:
                zp0 = resblock._conv_pass(x0, halo="separate", halo_rows=hr0)
                split["pass"] = split_time_ms(
                    lambda: resblock._conv_pass(x0, halo="separate", halo_rows=hr0))
                split[f"GEMM N={plan.bn}"] = split_time_ms(
                    lambda: resblock._conv_gemm([zp0], [k], plan, True))
                zp = F.pad(slab.permute(0, 3, 1, 2), (1, 1, 0, 0), mode="reflect")
                split["library"] = split_time_ms(lambda: F.conv2d(zp, k.permute(3, 2, 0, 1)))
                lib_what = "cuDNN conv of the W-padded slab"
                del zp, zp0
                b_ms, b_by = bound(2 * b * hl * wb * 9 * cb * cb,
                                   2 * x0.numel() * 2 + 4 * b * wb * cb + 9 * cb * cb * 2
                                   + b * cb * 8 * 2)
            mean = {part: [sum(r[j] for r in rs) / len(rs) for j in range(3)]
                    for part, rs in split.items()}
            ms = [mean[f"kernel {form}"][2] for form, _, _ in forms]
            lib = mean["library"][2]
            timing[n] = (sum(ms) / 2, sum(pms) / 2, b_ms, b_by, lib)
            splits.setdefault(name, {})[n] = split
            log(f"    S={n}: kernel {ms[0]:.4f} / {ms[1]:.4f} ms (conv1 / conv2, CUDA events; "
                f"the halo pass alone {mean['pass'][2]:.4f}), plain {pms[0]:.3f} / {pms[1]:.3f} "
                f"ms, bound {b_ms:.4f} ms ({b_by}), {lib_what} {lib:.4f} ms")
            for part, rs in split.items():
                log(f"    S={n} {part}: device / host / event ms a call, {len(rs)} readings: "
                    f"{split_text(rs)}")
        ms, pms, b_ms, b_by, lib = timing[SP_SHARDS[0]]
        results.append(dict(name=name, route="cuda", source="ircolor_tpu_torch/csrc/conv_fwd.cu",
                            replaces="ircolor_tpu/ops/pallas_resblock.py:"
                                     + ("1385" if quant else "280"),
                            max_abs_err=max(errs), ms=ms, plain_ms=pms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib))
        del x, xs, halos
        torch.cuda.empty_cache()
    LAUNCHES.update(before)
    return splits


def kernels_launched(torch, fn) -> list:
    """The CUDA kernels one call of ``fn`` launches, by ``torch.profiler``
    (the names seen in either of two calls profiled apart: a window can
    miss a launch's record, and one that records no kernel at all, which
    happens now and then deep into a run, is taken again, six windows at
    most), each name cut to 60 characters."""
    from torch.profiler import ProfilerActivity, profile

    seen: set = set()
    full = 0
    for _ in range(6):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.name[:60] for e in prof.events() if e.device_type.name == "CUDA"}
        seen |= names
        full += bool(names)
        if full == 2:
            break
    return sorted(seen)


def check_n64_bits(torch, x, k, forms) -> None:
    """Row 2's GEMM at N = 64 against N = 128 on the same operands: the
    unsharded block conv (``x``, conv1 and conv2), its halo form on shard
    0 at S = 2 and 4 and the b2 band's conv (``x``'s first two images),
    output and per-tile sums bit for bit (an output element's K order does
    not depend on N); conv1's GEMM timed at both N (device ms a call, three
    readings, ``split_time_ms``)."""
    from ircolor_tpu_torch.kernels import resblock
    from ircolor_tpu_torch.parallel.spatial import exchange_halo_rows, shard_h

    w, c = x.shape[2], x.shape[3]
    cases = [("unsharded", x, None), ("b2 band", x[:2], None)]
    for n in SP_SHARDS:
        xs = shard_h(x, [x.device] * n)
        cases.append((f"S={n} shard 0", xs[0], exchange_halo_rows(xs, 1)[0]))
    for label, xi, hr in cases:
        halo = "reflect" if hr is None else "separate"
        b = xi.shape[0]
        for form, _, kw in forms:
            zp = resblock._conv_pass(xi, **kw, halo=halo, halo_rows=hr)
            plans = {bn: resblock._conv_plan(b, xi.shape[1], w, (c,), k.shape[-1], "reflect",
                                             norm="mean" in kw, bn=bn) for bn in (64, 128)}
            got = {bn: resblock._conv_gemm([zp], [k], plan, True) for bn, plan in plans.items()}
            same = all(torch.equal(a, z) for a, z in zip(got[64], got[128]))
            pick = resblock._conv_plan(b, xi.shape[1], w, (c,), k.shape[-1], "reflect").bn
            times = ""
            if form == "conv1":
                dev = {bn: [r[0] for r in split_time_ms(
                    lambda: resblock._conv_gemm([zp], [k], plan, True))]
                    for bn, plan in plans.items()}
                times = "; GEMM device ms N=64 " + " / ".join(f"{t:.4f}" for t in dev[64]) + \
                    ", N=128 " + " / ".join(f"{t:.4f}" for t in dev[128]) + \
                    f" ({plans[64].blocks} / {plans[128].blocks} output blocks)"
            log(f"[conv3x3_reflect_fused N=64 vs N=128 {label} {form}] {tuple(xi.shape)}: output "
                f"and tile sums bit-identical {same}; the plan runs N = {pick}{times}")
            if not same:
                raise AssertionError(f"row 2's GEMM at N = 64 differs from N = 128 ({label}, "
                                     f"{form})")


def seam_ratio(torch, pred_a, pred_b, n: int) -> float:
    """The mean uint8 |d| between two (B, H, W, 3) predictions on the rows
    within SEAM_BAND rows of a seam of ``n`` equal H-shards, over the mean
    on the rows at least SEAM_FAR rows from every seam."""
    d = (pred_a.int() - pred_b.int()).abs().float().mean(dim=(0, 2, 3))
    h = d.shape[0]
    seams = torch.tensor([i * h // n for i in range(1, n)], device=d.device, dtype=torch.float32)
    rows = torch.arange(h, device=d.device, dtype=torch.float32) + 0.5
    dist = (rows[:, None] - seams[None, :]).abs().min(dim=1).values
    band, far = float(d[dist < SEAM_BAND].mean()), float(d[dist >= SEAM_FAR].mean())
    return band / far if far > 0 else (0.0 if band == 0 else float("inf"))


def seams_cut_fault(torch, infer, batch):
    """A seam fault for the seam check to find: the int8 enc/dec convs'
    halo rows (``ops/quant.py``'s ``pad2d_spatial``) made from each shard
    alone, zero at the seams, as if every shard were an image."""
    from ircolor_tpu_torch.ops import quant as tquant

    real = tquant.pad2d_spatial
    tquant.pad2d_spatial = lambda xs, r, pad_type="reflect": [real([x], r, pad_type)[0]
                                                              for x in xs]
    try:
        return infer(*batch)
    finally:
        tquant.pad2d_spatial = real


def halo_row_fault(torch, infer, batch):
    """A single wrong halo row for the seam check to find: in the first
    bottleneck block's conv1, shard 1's top halo row (the first seam's)
    replaced by that shard's own first row; every other halo row right."""
    from ircolor_tpu_torch.kernels import resblock

    real, calls = resblock.exchange_halo_rows, []

    def once(xs, r, pad="reflect"):
        halos = real(xs, r, pad)
        if not calls:
            halos[1] = (xs[1][:, :1].contiguous(), halos[1][1])
        calls.append(len(xs))
        return halos

    resblock.exchange_halo_rows = once
    try:
        return infer(*batch)
    finally:
        resblock.exchange_halo_rows = real


def spatial_serving_phase(torch, np, counts: dict, hw: tuple = (H, W),
                          shards: tuple = SP_SHARDS, tag: str = "",
                          noise_of: dict | None = None) -> tuple[dict, dict]:
    """Phase 8b: ``make_infer_fn`` over ``spatial_generator`` (the runner's
    rebuild: tails and head off, every shard on cuda:0) for each cell of
    ``SP_CELLS`` at S = 2 and 4, against the unsharded step of the same
    weights and inputs with the same rebuild (tails and head off, so the
    routes differ only by the sharding; under int8 its enc/dec convs then
    run on the int8 conv too) and against the same spatial step with rows
    1 and 2 on their plain versions: phase 4's serving budget each. The
    int8 cell's decoder quantizes on a per-sample grid (up1, up2), where an
    ulp of upstream difference moves a value across a rounding boundary and
    the prediction by whole levels, so its uint8 limit is set from the
    unsharded route's own distance between kernel and plain rows in the
    same run (its rounding noise): mean |d| at most SP_INT8_NOISE_K times
    that, beside the metric budget; and the spatial route with the int8
    conv on its plain version must repeat the kernel route bit for bit.
    Every spatial step's |d| to the unsharded step on the rows next to the
    seams is held against its |d| on the interior rows (``seam_ratio``),
    and the check must flag a seam fault injected into the int8 enc/dec
    convs' halos at S = 2 (``seams_cut_fault``); a single wrong halo row in
    one bottleneck conv (``halo_row_fault``) is injected at S = 2 in both
    cells, what flags it logged, and the float cell must flag it (the int8
    cell's rounding noise hides it). A forward
    must launch the halo forms 18·S times (and, int8, the int8 conv at the
    6 enc/dec sites of each shard) and nothing else. Frames/s and peak
    memory beside the unsharded steps' (the default route with tails and
    head, and the rebuild) from the same run. Returns the frames/s by run
    and each cell's noise (the uint8 mean |d| above) by cell.

    Phase 8c (``hw`` another height, ``shards`` its S, ``tag`` its label):
    the same checks where the shards are unequal at the bottleneck, so the
    blocks run their plain ops with their halos (as JAX's ``local_h = 0``)
    and a forward launches, under int8, the int8 conv at the 6 enc/dec
    sites and the blocks' 18 convs of each shard, and nothing else (float:
    no kernel). The unsharded rebuild at that height is the reference (no
    default route); its bottleneck (122 rows at 488) takes no fused tile,
    so it runs the same ops unsharded and has no kernel-vs-plain distance
    of its own: the int8 limit scales ``noise_of``, phase 8b's noise of the
    same cell in the same run."""
    import copy

    from ircolor_tpu_torch.eval.runner import make_infer_fn, spatial_generator
    from ircolor_tpu_torch.kernels import LAUNCHES, reset_launches
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel
    from ircolor_tpu_torch.parallel.spatial import check_stage_heights

    rows12 = ("conv3x3_reflect_fused", "conv3x3_reflect_fused_q")

    def swapped(infer, names, ir, gt):
        mid = dict(LAUNCHES)
        with plain_kernels(names):
            out = infer(ir, gt)
        ran = {k: LAUNCHES[k] - mid[k] for k in LAUNCHES if LAUNCHES[k] != mid[k]}
        LAUNCHES.update(mid)
        return out, ran

    summary, fps_by_run, noise_by_cell = [], {}, {}
    size = {} if hw == (H, W) else dict(img_height=hw[0], img_width=hw[1])
    for cell, quant, batch in SP_CELLS:
        label = f"{cell}{tag}"
        cfg = serving_config(test_batch_size=batch, **size,
                             **({} if quant else dict(quant_int8=False)))
        if (cfg.resolved_test_batch_size, cfg.resolved_quant_int8) != (batch, quant):
            raise AssertionError(f"spatial {label}: config no longer resolves to b{batch} "
                                 f"int8={quant}")
        model = IRColorizationModel(cfg, "cuda")
        flat = copy.deepcopy(model.module)
        flat.pallas_norm_blur = flat.pallas_head = False
        block = "conv3x3_reflect_fused_q" if quant else "conv3x3_reflect_fused"
        int8_sites = {"conv3x3_int8": 6} if quant else {}
        if not size:
            flat_per = {block: 18, **int8_sites}
        else:  # 122 bottleneck rows take no fused tile: the blocks' convs unfused here too
            flat_per = {"conv3x3_int8": 24} if quant else {}
        runs = [("unsharded", make_infer_fn(model.module),
                 {block: 18, "norm_relu_blur_down": 2, "conv7x7_head": 1}, 1)] if not size else []
        runs.append(("unsharded, tails and head off", make_infer_fn(flat), flat_per, 1))
        for n in shards:
            g = spatial_generator(cfg.replace(sp_devices=n), model.module, "cuda:0")
            if len(set(check_stage_heights(hw[0], n, 2)[-1])) == 1:
                per = {f"{block}_halo": 18 * n, **{k: v * n for k, v in int8_sites.items()}}
            else:  # unequal bottleneck shards: the blocks' convs on the int8 conv or cuDNN
                per = {"conv3x3_int8": 24 * n} if quant else {}
            runs.append((f"sp{n}", make_infer_fn(g), per, n))
        n_batches = 2 if batch >= 32 else 6
        batches = [(torch.from_numpy(ir).cuda(), torch.from_numpy(gt).cuda())
                   for ir, gt in synthetic_batches(n_batches, batch, hw)]
        ref, default = None, None
        for name, infer, per, n in runs:
            pred, m = infer(*batches[0])  # warm-up; the output compared below
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            outs = [infer(ir, gt) for ir, gt in batches]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            key = f"spatial {label} {name}"
            counts[key] = dict(LAUNCHES)
            expect_launches(key, counts[key], per, n_batches)
            check_outputs(torch, key, outs, batch, hw)
            fps = n_batches * batch / dt
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"[{key}] {fps:.2f} frames/s ({n_batches} batches of {batch} at {hw[0]}x{hw[1]}, "
                f"{1e3 * dt / n_batches:.2f} ms a batch), peak memory {peak:.2f} GiB")
            summary.append(f"{label} {name} {fps:.2f} frames/s {peak:.2f} GiB")
            fps_by_run[key] = fps
            if name == "unsharded":
                default = (pred, m)
                continue
            (pred_p, m_p), ran = swapped(infer, rows12, *batches[0])
            plain = route_delta(pred, m, pred_p, m_p)
            if ref is None:
                ref, noise = (pred, m), noise_of[cell] if noise_of else plain
                noise_by_cell[cell] = noise
                if default is not None:
                    log(f"    the default route (tails and head on) against this one: "
                        f"{route_delta(*default, *ref)['text']}")
                log(f"    this route against rows 1 and 2 on their plain versions (its "
                    f"rounding noise): {plain['text']}"
                    + (f"; the noise taken from phase 8b: {noise['mean_d']:.4f}"
                       if noise_of else ""))
                continue
            delta = route_delta(pred, m, *ref)
            seam = seam_ratio(torch, pred, ref[0], n)
            exact = True
            if quant:  # the int8 conv's kernel equals its plain version bit for bit
                (pred_i, _), _ = swapped(infer, ("conv3x3_int8",), *batches[0])
                exact = bool(torch.equal(pred_i, pred)) and bool(
                    torch.equal(infer(*batches[0])[0], pred))
                del pred_i
            limit = SP_INT8_NOISE_K * noise["mean_d"]
            whose = " (phase 8b's)" if noise_of else ""
            log(f"    against the unsharded step: {delta['text']}; seam/interior mean |d| "
                f"{seam:.4f} (tol {SEAM_RATIO_MAX})\n"
                f"    against rows 1 and 2 on their plain versions (launched there: {ran}): "
                f"{plain['text']}"
                + (f"\n    uint8 mean |d| {delta['mean_d']:.4f} to the unsharded step and "
                   f"{plain['mean_d']:.4f} to the plain rows, tol {SP_INT8_NOISE_K} x the "
                   f"unsharded route's noise{whose} {noise['mean_d']:.4f} = {limit:.4f}"
                   f"\n    the int8 conv on its plain version, and a repeat: bit-identical "
                   f"{exact} (tol 0)" if quant else ""))
            ok = (within_budget(delta, uint8_bound=not quant)
                  and within_budget(plain, uint8_bound=not quant) and seam <= SEAM_RATIO_MAX
                  and (not quant or max(delta["mean_d"], plain["mean_d"]) <= limit))
            if set(ran) - set(int8_sites) or not exact or not ok:
                raise AssertionError(f"{key}: outside the serving budget or the seam bound, a "
                                     f"route not bit-identical, or the plain route launched "
                                     f"{ran}")
            del pred_p
            if quant and n == SP_SHARDS[0]:
                pred_f, m_f = seams_cut_fault(torch, infer, batches[0])
                fault = route_delta(pred_f, m_f, *ref)
                seam_f = seam_ratio(torch, pred_f, ref[0], n)
                log(f"    a seam fault (the int8 enc/dec convs' halos zero at the seams) "
                    f"against the unsharded step: {fault['text']}; seam/interior mean |d| "
                    f"{seam_f:.4f}: the seam check flags it {seam_f > SEAM_RATIO_MAX}, the "
                    f"metric budget {not within_budget(fault, uint8_bound=False)}, the noise "
                    f"limit {fault['mean_d'] > limit}")
                if seam_f <= SEAM_RATIO_MAX:
                    raise AssertionError(f"{key}: the seam check missed an injected seam fault")
                del pred_f
            if n == SP_SHARDS[0] and f"{block}_halo" in per:
                # One wrong halo row in one bottleneck conv, flagged where the
                # cell's own checks above would reject it. The float cell must
                # flag it; the int8 cell's rounding noise hides it (PERF.md §7).
                pred_f, m_f = halo_row_fault(torch, infer, batches[0])
                fault = route_delta(pred_f, m_f, *ref)
                seam_f = seam_ratio(torch, pred_f, ref[0], n)
                budget = not within_budget(fault, uint8_bound=not quant) or (
                    quant and fault["mean_d"] > limit)
                log(f"    one wrong halo row (block 0 conv1, shard 1's top row its own first "
                    f"row) against the unsharded step: {fault['text']}; seam/interior mean |d| "
                    f"{seam_f:.4f}: the seam check flags it {seam_f > SEAM_RATIO_MAX}, the "
                    f"budget {budget}")
                if not quant and not (seam_f > SEAM_RATIO_MAX or budget):
                    raise AssertionError(f"{key}: the checks missed a wrong halo row")
                del pred_f
        del model, flat, runs, batches, outs, ref, default, noise
        torch.cuda.empty_cache()
    log(f"[spatial serve{tag}] " + "; ".join(summary))
    return fps_by_run, noise_by_cell


EXPORT_TURNS = ("eager", "artifact", "artifact", "eager")
PORTABLE_INT8_B = 2


def _step_fps(torch, step, irs: list, b: int) -> float:
    """Frames/s of ``step`` over ``irs`` (one warm call first), host clock
    ending in a synchronize, as phase 3 times."""
    step(irs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ir in irs:
        step(ir)
    torch.cuda.synchronize()
    return len(irs) * b / (time.perf_counter() - t0)


def _decoded_ir(torch, ir_u16):
    """The float IR in [-1, 1] that ``make_infer_fn`` decodes a uint16
    batch to (the same ops, so the same bits)."""
    return ir_u16.float() / 65535.0 * 2.0 - 1.0


def export_phase(torch, np, per_forward: dict, counts: dict) -> None:
    """Phase 9: the ``export`` mode's artifacts at the flagship (module
    docstring). Each artifact is traced outside inference mode, as a user's
    export is, and run inside it."""
    import tempfile

    from ircolor_tpu_torch.eval.metrics import batched_metrics
    from ircolor_tpu_torch.eval.runner import make_infer_fn
    from ircolor_tpu_torch.export import aot
    from ircolor_tpu_torch.kernels import LAUNCHES, reset_launches
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    (REPO / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="export_", dir=REPO / "build"))
    batches = [(torch.from_numpy(ir).cuda(), torch.from_numpy(gt).cuda())
               for ir, gt in synthetic_batches(3, B)]
    irs = [_decoded_ir(torch, ir) for ir, _ in batches]
    for label, quant in (("int8", True), ("float", False)):
        model = IRColorizationModel(serving_config(quant_int8=quant), "cuda")
        t0 = time.perf_counter()
        blob = aot.export_inference(model.module, H, W, batch_size=B, keep_pallas=True)
        export_s = time.perf_counter() - t0
        path = tmp / f"{label}.pt2"
        aot.save_exported(str(path), blob)
        t0 = time.perf_counter()
        served = aot.load_exported(str(path))
        load_s = time.perf_counter() - t0
        if not aot.artifact_has_kernels(blob):
            raise AssertionError(f"export {label}: the keep_pallas artifact holds no kernel")
        with torch.inference_mode():
            served(irs[0])
            torch.cuda.synchronize()
            reset_launches()
            got = served(irs[0])
            torch.cuda.synchronize()
            counts[f"export {label}"] = dict(LAUNCHES)
            expect_launches(f"export {label} artifact", counts[f"export {label}"],
                            per_forward[label], 1)
            want, _ = make_infer_fn(model.module)(*batches[0])
            d = (got.int() - want.int()).abs()
            same = float((d == 0).float().mean())
            log(f"[export {label}] keep_pallas artifact at {H}x{W} b{B}: export {export_s:.2f} s, "
                f"load {load_s:.2f} s, {len(blob) / 1e6:.2f} MB; uint8 vs the eager step: "
                f"max |d| {int(d.max())}, identical share {same:.6f}")
            if int(d.max()) > 1 or same < 0.999:
                raise AssertionError(f"export {label}: artifact disagrees with the eager step")
            eager = aot.ServingStep(model.module)
            fps = {"eager": [], "artifact": []}
            for turn in EXPORT_TURNS:
                fps[turn].append(_step_fps(torch, eager if turn == "eager" else served, irs, B))
        log(f"[export {label}] frames/s (3 batches of {B} a turn, turns "
            f"{', '.join(EXPORT_TURNS)}): artifact "
            + " / ".join(f"{v:.2f}" for v in fps["artifact"]) + ", eager generator + uint8 "
            + " / ".join(f"{v:.2f}" for v in fps["eager"]))
        del model, served, eager, got, want
        torch.cuda.empty_cache()

    # The portable artifacts: aten ops only, served by a process that
    # cannot import the port; held to the serving budget against the eager
    # module with the four kernel gates off.
    for label, quant, b in (("float", False, B), ("int8", True, PORTABLE_INT8_B)):
        model = IRColorizationModel(serving_config(quant_int8=quant, test_batch_size=b), "cuda")
        t0 = time.perf_counter()
        blob = aot.export_inference(model.module, H, W, batch_size=b)
        export_s = time.perf_counter() - t0
        program = aot.load_program(io.BytesIO(blob))
        if aot.kernel_calls(program):
            raise AssertionError(f"portable {label}: ircolor ops {aot.kernel_calls(program)}")
        path = tmp / f"portable_{label}.pt2"
        aot.save_exported(str(path), blob)
        ir_u16, gt_u8 = (torch.from_numpy(a).cuda() for a in synthetic_batches(1, b)[0])
        torch.save(_decoded_ir(torch, ir_u16).cpu(), tmp / "ir.pt")
        code = ("import sys, time; sys.modules['ircolor_tpu_torch'] = None\n"
                "import torch\n"
                f"t0 = time.perf_counter(); step = torch.export.load({str(path)!r}).module()\n"
                "load = time.perf_counter() - t0\n"
                "with torch.inference_mode():\n"
                f"    out = step(torch.load({str(tmp / 'ir.pt')!r}).cuda())\n"
                f"torch.save(out.cpu(), {str(tmp / 'out.pt')!r}); print(f'{{load:.2f}}')\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, "-c", code], cwd=tmp, capture_output=True,
                              text=True, timeout=600, env=env)
        if proc.returncode != 0:
            raise AssertionError(f"portable {label}: the port-free process failed:\n"
                                 + proc.stderr[-3000:])
        got = torch.load(tmp / "out.pt").cuda()
        want, _ = make_infer_fn(aot.without_kernels(model.module))(ir_u16, gt_u8)
        gt01 = gt_u8.float() / 255.0
        delta = route_delta(got, batched_metrics(got.float() / 255.0, gt01),
                            want, batched_metrics(want.float() / 255.0, gt01))
        log(f"[export portable {label}] {H}x{W} b{b}: export {export_s:.2f} s, "
            f"{len(blob) / 1e6:.2f} MB, {len(program.graph.nodes)} graph nodes, no ircolor op; "
            f"load in the port-free process {proc.stdout.strip()} s; vs the eager step with "
            f"the gates off: {delta['text']}")
        if not within_budget(delta):
            raise AssertionError(f"portable {label}: outside the serving budget")
        del model, program, got, want
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)


# Phase 10: data parallelism on this one card. Two ranks share it: the
# test mode's two chunks run one after the other on one replica, and the
# two training ranks (two processes) meet over gloo, which copies through
# the host (NCCL refuses two ranks on one card). No multi-card speed-up is
# measured here.
DP_RANKS = 2
DP_TRAIN_STEPS = 4  # the first held against the one-process step, 3 timed


def port_kernel_counts(torch, fn, windows: int = 2) -> dict:
    """Launches of each of the port's kernels (``ircolor`` in the name) in
    one call of ``fn``, by ``torch.profiler``: the most of ``windows``
    windows (a window can miss a launch's record, never add one)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    best: Counter = Counter()
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = Counter(e.name[:60] for e in prof.events()
                       if e.device_type.name == "CUDA" and "ircolor" in e.name)
        best = Counter({k: max(best[k], seen[k]) for k in best.keys() | seen.keys()})
    return dict(best)


def dp_serving_phase(torch, np, per_forward: dict, counts: dict) -> None:
    """Phase 10a: ``make_infer_fn`` over a data mesh of ``DP_RANKS`` entries
    on cuda:0 (``dp_devices=2``: two chunks of 16 a batch of 32), int8 and
    float, against the unsharded b32 step on the same weights and batches:
    within phase 4's budget (bit-identical or not, said); the wrappers'
    launches 2 × (18 / 2 / 1) a batch over 3 batches, and every port
    kernel's launches by ``torch.profiler`` twice the unsharded step's;
    frames/s beside the unsharded step in turns (one, dp, dp, one)."""
    from ircolor_tpu_torch.eval.runner import make_infer_fn
    from ircolor_tpu_torch.kernels import LAUNCHES, reset_launches
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel
    from ircolor_tpu_torch.parallel.mesh import make_data_mesh

    mesh = make_data_mesh(DP_RANKS, device="cuda:0")
    for label, overrides, quant in (("int8", {}, True), ("float", {"quant_int8": False}, False)):
        cfg = serving_config(dp_devices=DP_RANKS, **overrides)
        if (cfg.resolved_hw, cfg.resolved_test_batch_size, cfg.resolved_quant_int8) != ((H, W), B, quant):
            raise AssertionError(f"dp {label}: config no longer resolves to {H}x{W} b{B}")
        model = IRColorizationModel(cfg, "cuda")
        steps = {"one": make_infer_fn(model.module), "dp": make_infer_fn(model.module, mesh)}
        batches = [(torch.from_numpy(ir).cuda(), torch.from_numpy(gt).cuda())
                   for ir, gt in synthetic_batches(3, B)]
        for f in steps.values():  # warm-up: cuDNN algorithm picks at b32 and b16
            f(*batches[0])
        torch.cuda.synchronize()
        (p1, m1), (pd, md) = steps["one"](*batches[0]), steps["dp"](*batches[0])
        delta = route_delta(pd, md, p1, m1)
        same = bool(torch.equal(pd, p1)) and all(torch.equal(md[k], m1[k]) for k in md)
        log(f"[dp serve {label}] 2 chunks of {B // DP_RANKS} vs unsharded b{B}: {delta['text']}; "
            f"bit-identical: {same}")
        if not within_budget(delta):
            raise AssertionError(f"dp serve {label}: outside the serving budget: {delta['text']}")

        reset_launches()
        outs = [steps["dp"](ir, gt) for ir, gt in batches]
        torch.cuda.synchronize()
        counts[f"dp {label}"] = dict(LAUNCHES)
        expect_launches(f"dp serve {label}", counts[f"dp {label}"],
                        {k: DP_RANKS * v for k, v in per_forward[label].items()}, len(batches))
        check_outputs(torch, f"dp serve {label}", outs, B)
        prof = {w: port_kernel_counts(torch, lambda: steps[w](*batches[0])) for w in steps}
        log(f"[dp serve {label}] the port's kernels a batch by torch.profiler: dp {prof['dp']}; "
            f"unsharded {prof['one']}")
        if not prof["one"] or prof["dp"] != {k: DP_RANKS * v for k, v in prof["one"].items()}:
            raise AssertionError(f"dp serve {label}: profiler launches {prof['dp']} are not "
                                 f"{DP_RANKS} x the unsharded step's {prof['one']}")

        fps: dict = {"one": [], "dp": []}
        for which in ("one", "dp", "dp", "one"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for ir, gt in batches:
                steps[which](ir, gt)
            torch.cuda.synchronize()
            fps[which].append(len(batches) * B / (time.perf_counter() - t0))
        log(f"[dp serve {label}] frames/s at b{B} (turns one, dp, dp, one): dp "
            + " / ".join(f"{v:.2f}" for v in fps["dp"]) + ", unsharded "
            + " / ".join(f"{v:.2f}" for v in fps["one"]))
        del model, steps, batches, outs
        torch.cuda.empty_cache()


def dp_train_phase(torch, np, counts: dict) -> None:
    """Phase 10b: ``DP_RANKS`` training ranks spawned on cuda:0 over gloo
    (``parallel.launch.spawn``, ``tools.dp_steps.run_rank_each``), the
    flagship in train mode with ``dp_mode="shard_map"``, global b8 (b4 a
    rank), ``DP_TRAIN_STEPS`` steps on fixed synthetic batches, against the
    same steps of one process at b8 from the same weights: the parameters
    and buffers bit-identical across the ranks after every step; of the
    first step, the losses D' does not enter within 2^-10 relative, G's and
    D's conv weights' gradients within 1e-2 relative L2 and their Adam
    update within lr/4 on all but 1% of entries, the biases read out; 18 /
    18 / 18 launches of rows 2, 5 and 6 a step on each rank; a failed rank
    fails the phase. The same ranks then run the same steps under the
    default ``dp_mode`` ("gspmd"): the same launches, bit-identical
    replicas, and the losses D' does not enter within 2^-10 relative of
    shard_map's (bit-identical or not, said). Then 10c: a one-rank NCCL
    group through the same launcher, whose all-reduce must return."""
    from ircolor_tpu_torch.config import Config
    from ircolor_tpu_torch.parallel.launch import spawn
    from ircolor_tpu_torch.tools.dp_steps import (
        ROUTING,
        collective_probe,
        one_process_steps,
        run_rank_each,
    )
    from ircolor_tpu_torch.train.state import train_config
    from ircolor_tpu_torch.train.step import METRIC_KEYS

    cfg = Config.from_json(FLAGSHIP.read_text()).replace(
        mode="train", seed=SEED, dp_devices=DP_RANKS, dp_mode="shard_map")
    if (cfg.resolved_hw, cfg.batch_size, cfg.compute_dtype) != ((H, W), TRAIN_B, "bf16"):
        raise AssertionError(f"{FLAGSHIP.name} no longer resolves to b{TRAIN_B} bf16 training")
    batches = [{"ir": ir, "rgb": gt} for ir, gt in synthetic_batches(DP_TRAIN_STEPS, TRAIN_B)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    modes = (cfg, cfg.replace(dp_mode=Config().dp_mode))
    per_rank = spawn(run_rank_each, [torch.device("cuda", 0)] * DP_RANKS,
                     ([(c, batches) for c in modes],), timeout_s=600)
    ranks, default_ranks = ([r[i] for r in per_rank] for i in range(len(modes)))
    log(f"[dp train] {DP_RANKS} ranks on cuda:0 over gloo: spawned, trained "
        f"({' then '.join(c.dp_mode for c in modes)}) and joined in "
        f"{time.perf_counter() - t0:.1f} s")
    one = one_process_steps(cfg.replace(dp_devices=1), torch.device("cuda", 0), batches)
    torch.cuda.empty_cache()

    expect_launches("dp train one process (forwards = steps)", one["launches"], TRAIN_PER_STEP,
                    DP_TRAIN_STEPS)
    for mode, outs in ((modes[0].dp_mode, ranks), (modes[1].dp_mode, default_ranks)):
        for r, out in enumerate(outs):
            counts[f"dp train {mode} rank {r}"] = out["launches"]
            expect_launches(f"dp train {mode} rank {r} (forwards = steps)", out["launches"],
                            TRAIN_PER_STEP, DP_TRAIN_STEPS)
            if out["equal"] != [True] * DP_TRAIN_STEPS:
                raise AssertionError(f"dp train {mode}: replicas differ after the steps "
                                     f"{out['equal']}")
            if out["routing"] != {f: getattr(train_config(cfg), f) for f in ROUTING}:
                raise AssertionError(f"dp train {mode} rank {r}: routing {out['routing']}")
        log(f"[dp train] {mode}: parameters and buffers bit-identical across the ranks after "
            f"each of the {DP_TRAIN_STEPS} steps; routing {outs[0]['routing']}")
    # Against one process at b8 the ranks run b4 shapes and sum in another
    # order, in bf16. Held: the step-1 losses that D' does not enter within
    # a quarter of a bf16 ulp (2^-10) relative; G's conv weights' gradients
    # within phase 6's 1e-2 relative L2 and their Adam update within lr/4 on
    # >= 99% of entries, and D's likewise. Read out only: loss_G_GAN and
    # loss_G, which read D' (D after its Adam step, whose rounding-level
    # entries may step either way), and every bias (those ahead of an
    # instance norm get no gradient in exact arithmetic).
    for i in range(DP_TRAIN_STEPS):
        got, want = ranks[0]["losses"][i], one["losses"][i]
        rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in METRIC_KEYS}
        log(f"[dp train] step {i + 1} losses, dp vs one process (relative): "
            + ", ".join(f"{k} {got[k]:.6f}/{want[k]:.6f} ({rel[k]:.2e})" for k in METRIC_KEYS))
        bad = [k for k in METRIC_KEYS if k not in ("loss_G", "loss_G_GAN")
               and abs(got[k] - want[k]) > 2.0**-10 * abs(want[k]) + 1e-7]
        if i == 0 and bad:
            raise AssertionError(f"dp train: step 1 losses {bad} outside 2^-10 relative")
    # The two modes run the same step on the same weights: step 1's losses
    # that D' does not enter are held as against one process; every step's
    # losses are read out, bit-identical or not.
    same = default_ranks[0]["losses"] == ranks[0]["losses"]
    got, want = default_ranks[0]["losses"][0], ranks[0]["losses"][0]
    worst = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                for k in METRIC_KEYS if k not in ("loss_G", "loss_G_GAN"))
    log(f"[dp train] {modes[1].dp_mode} vs {modes[0].dp_mode}: losses of all {DP_TRAIN_STEPS} "
        f"steps bit-identical: {same}; step 1's D'-free losses at most {worst:.2e} relative apart")
    if worst > 2.0**-10:
        raise AssertionError(f"dp train: {modes[1].dp_mode}'s losses leave shard_map's by {worst}")
    lr = cfg.lr_G
    grads = one["first"]["grads"]
    held = {"g.": [0.0, 0.0, 0], "d.": [0.0, 0.0, 0]}  # worst grad rel L2, worst off share, leaves
    for key, want in grads.items():
        if want is None or not key.endswith(".weight"):
            continue
        got = ranks[0]["first"]["grads"][key]
        rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
        d_one = one["first"]["params"][key] - one["before"][key]
        d_dp = ranks[0]["first"]["params"][key] - one["before"][key]
        off = float((np.abs(d_dp - d_one) > 0.25 * lr).mean())
        worst = held[key[:2]]
        worst[0], worst[1], worst[2] = max(worst[0], rel), max(worst[1], off), worst[2] + 1
        if rel > 1e-2 or off > 0.01:
            raise AssertionError(f"dp train: step 1 of {key}: gradient {rel:.2e} relative L2, "
                                 f"update off by > lr/4 on {off:.4f} of it")
    for tag, name in (("g.", "G"), ("d.", "D")):
        log(f"[dp train] step 1 vs one process, {name}, {held[tag][2]} conv weights: gradient "
            f"at most {held[tag][0]:.2e} relative L2, Adam update more than lr/4 apart on at "
            f"most {held[tag][1]:.5f} of a leaf")

    timed = slice(1, DP_TRAIN_STEPS)
    one_ms = float(np.mean(one["step_ms"][timed]))
    for r, out in enumerate(ranks):
        step_ms = float(np.mean(out["step_ms"][timed]))
        comm_ms = float(np.mean(out["comm_ms"][timed]))
        log(f"[dp train] rank {r}: {step_ms:.1f} ms a step ({TRAIN_B * 1e3 / step_ms:.2f} global "
            f"frames/s), all-reduce {comm_ms:.1f} ms ({comm_ms / step_ms:.3f} of it), peak "
            f"memory {out['peak_gib']:.2f} GiB")
    log(f"[dp train] one process b{TRAIN_B}: {one_ms:.1f} ms a step "
        f"({TRAIN_B * 1e3 / one_ms:.2f} frames/s), peak memory {one['peak_gib']:.2f} GiB")

    t0 = time.perf_counter()
    (probe,) = spawn(collective_probe, [torch.device("cuda", 0)], timeout_s=300)
    log(f"[dp nccl] one rank on cuda:0: backend {probe['backend']}, world {probe['world']}, "
        f"all-reduce {probe['sum']} (every entry equal: {probe['same']}) in "
        f"{time.perf_counter() - t0:.1f} s")
    if probe != {"backend": "nccl", "world": 1, "sum": 1.0, "same": True}:
        raise AssertionError(f"dp nccl: {probe}")


SP_TRAIN_S = (2, 4)  # phase 11's shard counts, every shard on cuda:0


def _live(np, grads: dict, tag: str) -> list:
    """The leaves of one net whose gradient is above 1e-5 of its largest
    (``tests/test_torch_train_step.py``'s rule: the conv biases ahead of an
    instance norm are left out)."""
    norms = {k: float(np.linalg.norm(v)) for k, v in grads.items()
             if k.startswith(tag) and v is not None}
    floor = 1e-5 * max(norms.values())
    return [k for k, n in norms.items() if n > floor]


def sp_train_phase(torch, np, counts: dict, smi: str) -> None:
    """Phase 11: spatial training (``sp_devices`` S, every shard on cuda:0)
    at the flagship, bf16 b8, S = 2 and 4: each cell one step (also the
    warm-up) and 3 timed steps, beside the unsharded step with the same
    routing (every fused kernel off, as ``train_config`` turns them off
    under sp) and phase 5's kernel step; no kernel launched. Held against
    the unsharded step's first step with phase 10b's bounds: the losses D'
    does not enter within 2^-10 relative, G's and D's conv weight gradients
    within 1e-2 relative L2, their Adam update within lr/4 on ≥ 99% of each
    leaf, or, on a leaf where the unsharded bf16 step's own update is more
    than 1% away from the unsharded float32 step's (inc's 7×7 conv,
    bf16's noisiest gradient), on no more of it than that.

    Then an f32 cell at b2, S = 2, to the CPU parity bounds: the losses
    within 1e-5 relative (the G phase against the unsharded G phase on the
    sharded step's own D'), the Adam update within lr/4 on ≥ 99%, and every
    live leaf's gradient within 1e-4 relative L2, or within twice the
    distance that a one-ulp nudge of the input moves the unsharded step's
    gradient of that leaf: at this size a last-bit change of the forward
    (a reordered sum, a nudged input; sharding does both) flips the
    ReLUs and pool windows at their kinks and moves the gradients by
    ~1e-4, with cuDNN or PyTorch's own convs alike."""
    from ircolor_tpu_torch.tools.sp_probe import flagship_train_config, leaf_distance, train_cell
    from ircolor_tpu_torch.train.step import METRIC_KEYS

    base = flagship_train_config()
    if (base.resolved_hw, base.batch_size, base.compute_dtype) != ((H, W), TRAIN_B, "bf16"):
        raise AssertionError(f"{FLAGSHIP.name} no longer resolves to b{TRAIN_B} bf16 training")
    batches = [{"ir": ir, "rgb": gt} for ir, gt in synthetic_batches(4, TRAIN_B)]
    lr = base.lr_G
    d_free = [k for k in METRIC_KEYS if k not in ("loss_G", "loss_G_GAN")]
    one = train_cell(base, batches, 4)
    ref32 = train_cell(base.replace(compute_dtype="f32"), batches, 1)
    counts["sp train unsharded"] = one["launches"]
    log(f"[sp train] {smi}: unsharded b{TRAIN_B} bf16, kernels off: {one['ms']:.1f} ms a step "
        f"({TRAIN_B * 1e3 / one['ms']:.2f} frames/s), peak memory "
        f"{one['peak_gib']['cuda:0']:.2f} GiB; phase 5's kernel step {STEP_MS['train']:.1f} ms, "
        f"peak {PEAK_GIB['train']:.2f} GiB")
    weights = [k for k in one["grads"] if k.endswith(".weight") and one["grads"][k] is not None]
    own_off = {k: leaf_distance(one, ref32, k, lr)[1] for k in weights}
    noisy = {k: v for k, v in own_off.items() if v > 0.01}
    log("[sp train] the unsharded bf16 step's Adam update more than lr/4 from the unsharded f32 "
        f"step's on more than 1% of a leaf: {noisy or 'none'}")
    for n in SP_TRAIN_S:
        cell = train_cell(base.replace(sp_devices=n), batches, 4)
        counts[f"sp train sp{n}"] = cell["launches"]
        rel = {k: abs(cell["losses"][k] - one["losses"][k]) / max(abs(one["losses"][k]), 1e-30)
               for k in METRIC_KEYS}
        log(f"[sp train] S = {n}: step 1 losses vs unsharded (relative): "
            + ", ".join(f"{k} {cell['losses'][k]:.6f}/{one['losses'][k]:.6f} ({rel[k]:.2e})"
                        for k in METRIC_KEYS))
        bad = [k for k in d_free if rel[k] > 2.0**-10]
        for tag, name in (("g.", "G"), ("d.", "D")):
            keys = [k for k in weights if k.startswith(tag)]
            dist = {k: leaf_distance(cell, one, k, lr) for k in keys}
            bad += [(k, r, o) for k, (r, o) in dist.items()
                    if r > 1e-2 or o > max(0.01, noisy.get(k, 0.0))]
            log(f"[sp train] S = {n}, step 1, {name}, {len(keys)} conv weights: gradient at most "
                f"{max(r for r, _ in dist.values()):.2e} relative L2 (bound 1e-2), Adam update "
                f"more than lr/4 apart on at most {max(o for _, o in dist.values()):.5f} of a "
                "leaf (bound 0.01, or the bf16 step's own share where larger): "
                + ", ".join(f"{k} {o:.4f} (own {noisy[k]:.4f})" for k, (_, o) in dist.items()
                            if k in noisy))
        ran = {k: v for k, v in cell["launches"].items() if v}
        if bad or ran:
            raise AssertionError(f"sp train S = {n}: outside the bounds {bad}; kernels run {ran}")
        log(f"[sp train] {smi}: S = {n} on cuda:0, b{TRAIN_B} bf16: {cell['ms']:.1f} ms a step "
            f"({TRAIN_B * 1e3 / cell['ms']:.2f} frames/s; unsharded {one['ms']:.1f} ms), peak "
            f"memory {cell['peak_gib']['cuda:0']:.2f} GiB (unsharded "
            f"{one['peak_gib']['cuda:0']:.2f}); no kernel launched (every launch count 0); last "
            "losses " + ", ".join(f"{k}={v:.4f}" for k, v in cell["last"].items()))
    if any(one["launches"].values()):
        raise AssertionError(f"sp train unsharded (kernels off) launched {one['launches']}")

    # The f32 cell on float batches (decoded as the step decodes them), so
    # that the nudge is one ulp of the input the generator reads.
    f32 = base.replace(compute_dtype="f32", batch_size=2)
    ir, gt = batches[0]["ir"][:2], batches[0]["rgb"][:2]
    b2 = {"ir": (ir.astype(np.float32) / np.float32(65535.0) * np.float32(2.0)
                 - np.float32(1.0)).astype(np.float32),
          "rgb": (gt.astype(np.float32) / np.float32(255.0) * np.float32(2.0)
                  - np.float32(1.0)).astype(np.float32)}
    nudged = {**b2, "ir": np.nextafter(b2["ir"], np.float32(np.inf))}
    one32 = train_cell(f32, [b2], 1)
    sp32 = train_cell(f32.replace(sp_devices=2), [b2], 1)
    g_ref = train_cell(f32, [b2], 1, d_params=sp32["params"], update_d=False)
    d_nudge = train_cell(f32, [nudged], 1)
    g_nudge = train_cell(f32, [nudged], 1, d_params=sp32["params"], update_d=False)
    want = {"loss_D": one32["losses"]["loss_D"],
            **{k: g_ref["losses"][k] for k in METRIC_KEYS if k != "loss_D"}}
    rel = {k: abs(sp32["losses"][k] - want[k]) / max(abs(want[k]), 1e-30) for k in METRIC_KEYS}
    log("[sp train] f32 b2 S = 2: step 1 losses vs unsharded (G phase on the same D'; "
        "relative): " + ", ".join(f"{k} {rel[k]:.2e}" for k in METRIC_KEYS))
    bad = [k for k in METRIC_KEYS if abs(sp32["losses"][k] - want[k]) > 1e-5 * abs(want[k]) + 1e-7]
    for tag, ref, nudge, name in (("d.", one32, d_nudge, "D"), ("g.", g_ref, g_nudge, "G")):
        keys = _live(np, ref["grads"], tag)
        dist = {k: leaf_distance(sp32, ref, k, lr) for k in keys}
        floor = {k: leaf_distance(nudge, ref, k, lr)[0] for k in keys}
        bad += [(k, r, o, floor[k]) for k, (r, o) in dist.items()
                if r > max(1e-4, 2 * floor[k]) or o > 0.01]
        log(f"[sp train] f32 b2 S = 2, {name}, {len(keys)} live leaves: gradient at most "
            f"{max(r for r, _ in dist.values()):.2e} relative L2, Adam update more than lr/4 "
            f"apart on at most {max(o for _, o in dist.values()):.5f} of a leaf (bound 0.01); "
            "leaves past 1e-4 (relative L2 / the one-ulp nudge's): "
            + (", ".join(f"{k} {r:.2e}/{floor[k]:.2e}" for k, (r, _) in dist.items() if r > 1e-4)
               or "none"))
    for label, c in (("sp train f32 sp2", sp32), ("sp train f32 unsharded", one32)):
        counts[label] = c["launches"]
        if any(c["launches"].values()):
            bad.append((label, {k: v for k, v in c["launches"].items() if v}))
    if bad:
        raise AssertionError(f"sp train f32: outside the bounds: {bad}")


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
    t_phase = t0

    def phase_done(what: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        log(f"[time] {what}: {now - t_phase:.1f} s (total {now - t0:.1f} s)")
        t_phase = now

    phase_done("build")
    check_kernels(torch, results)
    check_instance_norm(torch, results)
    check_bwd_kernels(torch, results)
    check_segment_kernels(torch, results)
    phase_done("phases 2, 2b")
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
    phase_done("phase 2c")
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
    phase_done("phases 3, 4")
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

    phase_done("phases 5, 6, 5b, 5c")
    variant_phase(torch, np, counts)
    phase_done("phase 7")
    check_halo_kernels(torch, results)
    phase_done("phase 8a")
    _, sp_noise = spatial_serving_phase(torch, np, counts)
    phase_done("phase 8b")
    spatial_serving_phase(torch, np, counts, (SP_UNEQUAL_H, W), SP_UNEQUAL_SHARDS, " unequal",
                          sp_noise)
    phase_done("phase 8c")
    export_phase(torch, np, {"int8": int8_default, "float": float_default}, counts)
    phase_done("phase 9")
    dp_serving_phase(torch, np, {"int8": int8_default, "float": float_default}, counts)
    phase_done("phase 10a")
    dp_train_phase(torch, np, counts)
    phase_done("phases 10b, 10c")
    sp_train_phase(torch, np, counts, smi)
    phase_done("phase 11")

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
                "conv3x3_reflect_fused_q_halo": "spatial int8 sp2",
                "conv3x3_reflect_fused_halo": "spatial float sp2",
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
