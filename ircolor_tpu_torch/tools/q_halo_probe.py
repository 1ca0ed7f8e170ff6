"""Where row 1h's time goes on the card: the int8 block conv's spatial halo
form (``conv3x3_reflect_fused_q(..., halo="separate")``) at the flagship
bottleneck (32×128×160×256 → 256) split into S = 2 and 4 H-shards, shard 0.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 ircolor_tpu_torch/tools/q_halo_probe.py

For conv1 (the raw input on the per-sample grid) and conv2 (IN + ReLU,
then the fixed 127/6 grid) it reads, three ways a call (device / host /
event ms, ``chip_smoke.split_time_ms``):

- ``call``: the public call with ``sums=True``, as the spatial block runs it;
- ``pass``, ``GEMM``, ``repack``, ``tile sum``: the int8 operand pass
  (``_q_pass``), the s8 GEMM on its output (``_q_gemm``), the K-major
  weight repack (``_q_weights``) and torch's sum of the per-tile partials,
  each alone (the two-launch path's parts);

then row 1's GEMM on the unsharded bottleneck in the same process, each
GEMM's TOP/s, and the bytes that one output block moves from L2 to shared
memory (A and B apart) with the rate they imply at the measured time.

Then the s8 GEMM built from ``csrc/conv_fwd.cu`` with one edit each
(``build/q_halo_probe/``, the same ``nvcc`` flags), timed on the same
operands at S = 2 and 4 and unsharded, device ms, in turns with the
kernel's own library:

- ``B resident``: each ring slot loads its weight box on its first use
  only (the output is wrong by design): no L2 → shared traffic for B;
- ``A resident``: the same for the activations' box.

How far each variant runs faster says how far that operand's traffic sets
the GEMM's pace. Prints the card's name and power limit first.

With ``--fused``: instead, row 1h's one-call kernel (``conv_q_fused_kernel``,
quantizing on its A load) and variants of it with one part switched off,
device ms a call at S = 2 and 4 (conv1, conv2) and on the unsharded reflect
form, in turns with the two-launch path (pass, GEMM, torch's tile sum):

- ``no quantize``: the producers write zeros to the s8 tile;
- ``no copy``: the producers copy nothing into the stages' A buffers;
- ``no wgmma``: the consumers issue no wgmma (their epilogue runs);

and, built with ``IRCOLOR_QL_PROFILE``, the cycles a chunk that one thread
of each role spends in each phase (``PHASES``), over 5 calls.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# The edits of each variant: (text in csrc/conv_fwd.cu, its replacement).
EXPECT = "        mbar_expect_tx(full, STAGE);\n"
A_LOAD = "          tma_load(dst, ta, full, ci0, c0 + dx - a.shift, r0 - a.shift, b);\n"
B_LOAD = "          tma_load(dst + R::A, tb, full, ci0, co0, dx, 0);\n"
VARIANTS = {
    "B resident": (
        (EXPECT, "        mbar_expect_tx(full, S8 && g >= STAGES ? R::A : STAGE);\n"),
        (B_LOAD, "          if (g < STAGES) " + B_LOAD.lstrip()),
    ),
    "A resident": (
        (EXPECT, "        mbar_expect_tx(full, S8 && g >= STAGES ? STAGE - R::A : STAGE);\n"),
        (A_LOAD, "          if (!S8 || g < STAGES) " + A_LOAD.lstrip()),
    ),
}


QUANT = ("          out = quantize16<NORM>(lds16(swz128(buf, sp, 2 * cq)),\n"
         "                                 lds16(swz128(buf, sp, 2 * cq + 1)), qs, zm, zi, "
         "a.qfixed);\n")
COPY = "          sts16(swz64(st, (t + QL_CONVERT * m) / 4, cq), v[m]);\n"
WGMMA = ("            wgmma_s8_n128(acc[t], smem_desc_k64(st + row * TW * A_ROW + ks * 32), "
         "db);\n")
FUSED_VARIANTS = {
    "no quantize": ((QUANT, "          out = make_uint4(sp, 0u, 0u, 0u);\n"),),
    "no copy": ((COPY, "          (void)v[m];\n"),),
    "no wgmma": ((WGMMA, ""),),
    "profiled": (),  # built with IRCOLOR_QL_PROFILE: the phases' clock64 cycles
}
# The phases of ql_profile (csrc/conv_fwd.cu), slot 11 the chunks counted.
PHASES = ("prod: staging wait", "prod: quantize", "prod: tile barrier + next load",
          "prod: stage waits", "prod: copies", "prod: fences + arrivals", "prod: end barrier",
          "cons: stage waits", "cons: wgmma issue + wait", "cons: epilogue", "unused")


def build_variants(build, variants: dict = VARIANTS, key: str = "ILi128ELi5ELb0E") -> dict:
    """Each variant's library, built in parallel; ptxas's lines of its
    kernel (``key`` in the mangled name) printed."""
    src = (build.CSRC / "conv_fwd.cu").read_text()
    out = REPO / "build" / "q_halo_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"q_halo_probe: csrc/conv_fwd.cu has {old.strip()!r} "
                                 f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        tag = f"{'f' if variants is FUSED_VARIANTS else 'g'}{i}"
        cu = out / f"conv_fwd_{tag}.cu"
        cu.write_text(text)
        flags = ["-DIRCOLOR_QL_PROFILE"] if name == "profiled" else []
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-I", str(build.CSRC), "-o",
               str(out / f"libconv_fwd_{tag}.so"), str(cu)]
        procs[name] = (tag, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (tag, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"q_halo_probe: nvcc failed for {name}:\n{log[-4000:]}")
        lines = log.splitlines()
        for j, line in enumerate(lines):
            if "Compiling entry" in line and key in line:
                print(f"[{name}] ptxas: " + " | ".join(
                    s.split(":", 1)[-1].strip() for s in lines[j + 1 : j + 4]), flush=True)
        lib = ctypes.CDLL(str(out / f"libconv_fwd_{tag}.so"))
        p, n = ctypes.c_void_p, ctypes.c_int
        lib.ircolor_conv_q_gemm.argtypes = [p, p, p, n, p, p] + [n] * 5 + [p]
        lib.ircolor_conv_q_gemm.restype = n
        if hasattr(lib, "ircolor_conv_q_fwd"):
            lib.ircolor_conv_q_fwd.argtypes = ([p] * 3 + [ctypes.c_longlong] * 2 + [p] * 5
                                               + [ctypes.c_float] + [p] * 3 + [n] * 6 + [p])
            lib.ircolor_conv_q_fwd.restype = n
        libs[name] = lib
    return libs


def fused_turns(torch, cs, build, resblock, stream_ptr, x, kq, forms, shards) -> dict:
    """Row 1h's one call and its variants, device ms a call, in turns with
    the two-launch path, at shard 0 of each S in ``shards`` and on the
    unsharded reflect form."""
    from ircolor_tpu_torch.parallel.spatial import exchange_halo_rows, shard_h

    libs = build_variants(build, FUSED_VARIANTS, "conv_q_fused")
    b, hb, wb, cb = x.shape
    kt = resblock.q_pack(kq)
    report: dict = {}
    cases = []
    for n in shards:
        xs = shard_h(x, [x.device] * n)
        cases.append((f"S={n}", xs[0], exchange_halo_rows(xs, 1)[0]))
    cases.append(("reflect", x, None))
    for label, x0, hr in cases:
        h = x0.shape[1]
        plan = resblock._conv_plan(b, h, wb, (cb,), cb, "reflect", s8=True)
        halo = "reflect" if hr is None else "separate"
        out = torch.empty((b, h, wb, cb), dtype=torch.bfloat16, device=x.device)
        part = torch.empty((b, plan.ntiles, 2, cb), dtype=torch.float32, device=x.device)
        sums = torch.empty((b, 2, cb), dtype=torch.float32, device=x.device)
        top, bot = (None, None) if hr is None else hr
        for form, sc, kw in forms:
            def run(lib):
                return lambda: build.check(lib.ircolor_conv_q_fwd(
                    x0.data_ptr(), resblock._ptr(top), resblock._ptr(bot), h * wb * cb, wb * cb,
                    kt.data_ptr(), sc.data_ptr(), resblock._ptr(kw.get("qscale")),
                    resblock._ptr(kw.get("mean")), resblock._ptr(kw.get("inv")),
                    resblock._QFIXED, out.data_ptr(), part.data_ptr(), sums.data_ptr(), b, h, wb,
                    cb, cb, plan.grid, stream_ptr(x0)), "probe one call")

            fns = {"two launches": lambda: resblock._q_gemm(
                       resblock._q_pass(x0, **kw, halo=halo, halo_rows=hr), kt, sc,
                       plan)[1].sum(dim=1),
                   "kernel": lambda: resblock._q_fused(x0, kt, sc, plan, **kw, halo=halo,
                                                       halo_rows=hr),
                   **{name: run(lib) for name, lib in libs.items() if name != "profiled"}}
            order = [*fns, *reversed(fns)]
            times: dict = {}
            for name in order:
                times.setdefault(name, []).append(
                    min(r[0] for r in cs.split_time_ms(fns[name], readings=2)))
            print(f"[one call {label} {form}] device ms " + ", ".join(
                f"{nm} {' / '.join(f'{v:.4f}' for v in ts)}" for nm, ts in times.items()),
                flush=True)
            prof = (ctypes.c_ulonglong * 12)()
            lib = libs["profiled"]
            lib.ircolor_ql_profile.argtypes = [ctypes.c_void_p]
            lib.ircolor_ql_profile.restype = ctypes.c_int
            torch.cuda.synchronize()
            build.check(lib.ircolor_ql_profile(ctypes.addressof(prof)), "profile reset")
            for _ in range(5):
                run(lib)()
            torch.cuda.synchronize()
            build.check(lib.ircolor_ql_profile(ctypes.addressof(prof)), "profile read")
            chunks = max(prof[11], 1)
            cyc = {ph: prof[i] / chunks for i, ph in enumerate(PHASES)}
            print(f"[one call {label} {form}] cycles a chunk (one thread of each role, "
                  f"{chunks} chunks): " + ", ".join(f"{ph} {c:.0f}" for ph, c in cyc.items()),
                  flush=True)
            times["cycles"] = cyc
            report.setdefault(label, {})[form] = times
    return report


def main() -> int:
    import torch

    sys.path.insert(0, str(REPO))
    cs = importlib.import_module("chip_smoke")
    from ircolor_tpu_torch.kernels import build, resblock
    from ircolor_tpu_torch.kernels import stream_ptr
    from ircolor_tpu_torch.ops.norm import instance_norm_stats
    from ircolor_tpu_torch.ops.quant import _QCLIP, quantize_weight_per_channel
    from ircolor_tpu_torch.parallel.spatial import exchange_halo_rows, shard_h

    if not torch.cuda.is_available():
        print("q_halo_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    fused = "--fused" in sys.argv[1:]
    libs = {} if fused else build_variants(build)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 8)
    b, hb, wb, cb = cs.B, cs.H // 4, cs.W // 4, cs.NGF * 4
    k = (torch.randn(3, 3, cb, cb, device=dev, generator=gen) * 0.05).to(torch.bfloat16)
    kq, sw = quantize_weight_per_channel(k)
    x = torch.randn(b, hb, wb, cb, device=dev, generator=gen).to(torch.bfloat16)
    m0, i0 = instance_norm_stats(x)
    amax = x.float().abs().amax(dim=(1, 2, 3)).clamp(min=1e-12)
    sc1 = ((amax / 127.0)[:, None] * sw[None, :]).contiguous()
    sc2 = ((_QCLIP / 127.0) * sw[None, :]).expand(b, -1).contiguous()
    forms = (("conv1", sc1, dict(qscale=(127.0 / amax).contiguous())),
             ("conv2", sc2, dict(mean=m0, inv=i0)))
    report: dict = {}
    if fused:
        report = fused_turns(torch, cs, build, resblock, stream_ptr, x, kq, forms, (2, 4))
        print("PROBE " + json.dumps(report), flush=True)
        return 0

    def mean3(rs):
        return [sum(r[j] for r in rs) / len(rs) for j in range(3)]

    def gemm_variants(label, zq, kt, sc, plan, ops, blocks):
        """Device ms of the GEMM and of each variant on the same operands,
        in turns (kernel, variants, variants reversed, kernel)."""
        h, w, c = plan.h, plan.w, zq.shape[-1]
        out = torch.empty((b, h, w, cb), dtype=torch.bfloat16, device=dev)
        part = torch.empty((b, plan.ntiles, 2, cb), dtype=torch.float32, device=dev)

        def run(lib):
            return lambda: build.check(lib.ircolor_conv_q_gemm(
                zq.data_ptr(), kt.data_ptr(), sc.data_ptr(), c, out.data_ptr(), part.data_ptr(),
                b, h, w, cb, plan.grid, stream_ptr(zq)), "probe GEMM")

        order = ["kernel", *libs, *reversed(libs), "kernel"]
        fns = {"kernel": lambda: resblock._q_gemm(zq, kt, sc, plan),
               **{n: run(lib) for n, lib in libs.items()}}
        times: dict = {}
        for name in order:
            times.setdefault(name, []).append(
                min(r[0] for r in cs.split_time_ms(fns[name], readings=2)))
        per_block = {"A": 3 * plan.chunks[0] * 20 * 1024, "B": 3 * plan.chunks[0] * 24 * 1024}
        t = sum(times["kernel"]) / len(times["kernel"])
        rate = blocks * (per_block["A"] + per_block["B"]) / (t * 1e-3) / 1e12
        print(f"[{label}] GEMM device ms " + ", ".join(
            f"{n} {' / '.join(f'{v:.4f}' for v in ts)}" for n, ts in times.items())
            + f"; {ops / (t * 1e-3) / 1e12:.0f} TOP/s; L2 -> shared a block A "
            f"{per_block['A'] / 1024:.0f} KB + B {per_block['B'] / 1024:.0f} KB, "
            f"{blocks} blocks: {rate:.2f} TB/s", flush=True)
        report.setdefault("gemm", {})[label] = {n: ts for n, ts in times.items()}

    for n in (2, 4):
        xs = shard_h(x, [dev] * n)
        hr = exchange_halo_rows(xs, 1)[0]
        x0, hl = xs[0], hb // n
        plan = resblock._conv_plan(b, hl, wb, (cb,), cb, "reflect", s8=True)
        ops = 2 * b * hl * wb * 9 * cb * cb
        for form, sc, kw in forms:
            zq = resblock._q_pass(x0, **kw, halo="separate", halo_rows=hr)
            kt = resblock._q_weights(kq, plan)
            _, partial = resblock._q_gemm(zq, kt, sc, plan)
            parts = {
                "call": lambda: resblock.conv3x3_reflect_fused_q(
                    x0, kq, sc, **kw, halo="separate", halo_rows=hr, sums=True),
                "pass": lambda: resblock._q_pass(x0, **kw, halo="separate", halo_rows=hr),
                "GEMM": lambda: resblock._q_gemm(zq, kt, sc, plan),
                "repack": lambda: resblock._q_weights(kq, plan),
                "tile sum": lambda: partial.sum(dim=1),
            }
            for part, fn in parts.items():
                rs = cs.split_time_ms(fn)
                report.setdefault(f"S={n}", {}).setdefault(form, {})[part] = rs
                d, h, e = mean3(rs)
                print(f"[S={n} {form}] {part}: device / host / event ms {cs.split_text(rs)} "
                      f"(mean {d:.4f} / {h:.4f} / {e:.4f})", flush=True)
            if form == "conv1":
                gemm_variants(f"S={n}", zq, kt, sc, plan, ops, plan.blocks)
        del xs, hr, zq
    plan = resblock._conv_plan(b, hb, wb, (cb,), cb, "reflect", s8=True)
    zq = resblock._q_pass(x, **forms[0][2])
    gemm_variants("unsharded (row 1)", zq, resblock._q_weights(kq, plan), sc1, plan,
                  2 * b * hb * wb * 9 * cb * cb, plan.blocks)
    print("PROBE " + json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
