#!/usr/bin/env python3
"""Where the fused 7×7 head's time goes on the card: ``csrc/head.cu`` and
variants of it with one part switched off, timed at the flagship head
(32×512×640×64 → 3), both forms.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 head_probe.py

Each variant is the kernel's source with one edit, built with the same
``nvcc`` flags into ``build/head_probe/`` and loaded in place of the
kernel's library:

- ``kernel``: the source as it is;
- ``no shift-sum``: the epilogue's dx shift-sum and store skipped;
- ``MMA warps only``: no loads, no normalize or quantize, no shift-sum
  (the staging warps only hand over empty units);
- ``staging warps only``: no MMAs and no shift-sum.

The variants' outputs are wrong by design; only ``kernel`` is checked
against the plain version. Prints ptxas's spill line of each variant's
flagship instantiation, CUDA-event times (ms a launch, mean of 10 after 2
warm-ups, 3 rounds in turns), the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
SHAPE = (32, 512, 640, 64)

NO_MMA = "#define mma(...) do {} while (0)\n#define mma_s8(...) do {} while (0)\n"
EDITS = {
    "mark": "// One block's state",
    "shift": "__device__ __forceinline__ void shift_sum(int r) const {",
    "prepare": "      if ((u % nch()) * KC + q * 8 < C) prepare(ch, u, m, iv);",
    "issue": "  __device__ __forceinline__ void issue(const Chunks& ch, int u) const {",
}


def variants(src: str) -> dict:
    for marker in EDITS.values():
        if marker not in src:
            raise SystemExit(f"head_probe: csrc/head.cu no longer has {marker!r}")
    no_shift = src.replace(EDITS["shift"], EDITS["shift"] + " return;")
    return {
        "kernel": src,
        "no shift-sum": no_shift,
        "MMA warps only": no_shift.replace(EDITS["prepare"], "").replace(
            EDITS["issue"], EDITS["issue"] + " cp_async_commit(); return;"),
        "staging warps only": no_shift.replace(EDITS["mark"], NO_MMA + EDITS["mark"]),
    }


def build_all(build, srcs: dict) -> dict:
    out = REPO / "build" / "head_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(srcs.items()):
        cu = out / f"head_{i}.cu"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(out / f"libhead_{i}.so"), str(cu)]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (i, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"head_probe: nvcc failed for {name}:\n{log[-4000:]}")
        form = None
        for line in log.splitlines():
            found = re.search(r"head_kernelILb(\d)ELi(\d)ELb0E", line)
            if "Compiling entry" in line:
                form = {("0", "4"): "bf16", ("1", "2"): "s8"}.get(found.groups()) if found else None
            elif form and "spill" in line:
                print(f"[{name}] {form}: {line.split(':', 1)[-1].strip()}", flush=True)
        lib = ctypes.CDLL(str(out / f"libhead_{i}.so"))
        p, n = ctypes.c_void_p, ctypes.c_int
        lib.ircolor_conv7x7_head.argtypes = [p] * 7 + [n] * 9 + [p]
        lib.ircolor_conv7x7_head.restype = n
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("head_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from ircolor_tpu_torch.kernels import build, head
    from ircolor_tpu_torch.ops.norm import instance_norm_stats

    libs = build_all(build, variants((build.CSRC / "head.cu").read_text()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(*SHAPE, device="cuda", generator=g).to(torch.bfloat16)
    k = (torch.randn(7, 7, SHAPE[-1], 3, device="cuda", generator=g) * 0.02).to(torch.bfloat16)
    mean, inv = instance_norm_stats(x)

    def ms(fn, iters=10):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    head._lib = libs["kernel"]
    want = head.conv7x7_head_plain(x, mean, inv, k).float()
    got = head.conv7x7_head_pallas(x, mean, inv, k).float()
    tol = 2 * 2.0**-8 * float(want.abs().max())
    ok = float((got - want).abs().max()) <= tol and torch.equal(
        head.conv7x7_head_pallas(x, mean, inv, k, quant=True),
        head.conv7x7_head_q_plain(x, mean, inv, k))
    print(f"[kernel] agrees with the plain versions: {ok}", flush=True)
    for rnd in range(3):
        for name, lib in libs.items():
            head._lib = lib
            t = [ms(lambda q=q: head.conv7x7_head_pallas(x, mean, inv, k, quant=q)) for q in (False, True)]
            print(f"[round {rnd}] {name}: bf16 {t[0]:.3f} ms, s8 {t[1]:.3f} ms", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
