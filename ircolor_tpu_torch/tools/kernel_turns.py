"""One turn of a P C C P comparison (parent, change, change, parent on one
card): the kernel rows of ``chip_smoke.py``'s phases 2, 2b, 2c and 8a, run
from the checkout at ROOT with that checkout's own ``chip_smoke.py`` and
package (each builds its kernels under ``ROOT/build/kernels``). Prints the
rows' CUDA-event times and library calls as one JSON line, ``TURN {...}``.

    for r in build/parent . . build/parent; do
        python3 ircolor_tpu_torch/tools/kernel_turns.py $r; done

The ``TURN`` line also holds phase 8a's device / host / event readings
(``chip_smoke.split_time_ms``) by row, S and part, where the checkout's
phase 8a returns them. With ``--halo``: phase 8a alone.

With ``--host-profile``: instead, ``cProfile`` over 200 calls of row 2's
halo form (conv1, ``sums=True``) at the b4 shard of S = 4, its functions by
their own time: where the host's time a call goes (cProfile's own cost
inflates every entry).

With ``--spatial``: instead, phase 8b (spatial serving at 512×640, S = 2
and 4, with its checks), its frames/s by run as the ``TURN`` line.

With ``--sp-variants``: instead, phases 12b–12e (the model variants on
shards: serving at S = 2 beside the unsharded step, then one spatial
training cell each of 12d and 12e), their frames/s and ms a step by cell as
the ``TURN`` line. Phase 8b does not run in a turn, so 12b's int8 bound
(a multiple of 8b's noise) is not applied; the full script holds it.

With ``--serve``: instead, phase 3's b32 serving frames/s (int8 and
float, 3 batches each) and b1 latencies (int8 configuration (a) and float,
64 frames each: mean and median ms), each with its launch counts checked,
as the ``TURN`` line; where the checkout's wrappers ask
``kernels.exported_op`` whether an export trace runs (the one line they run
in eager for it), also its host µs a call over 10^6 calls.

With ``--sass OTHER``: instead, every ``csrc/conv_fwd.cu`` kernel's SASS
(``cuobjdump -sass``, addresses and encodings stripped) against the same
kernel's in the checkout OTHER, one line a kernel: identical, the count
of differing lines, or present in one checkout only.
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path


def _use(root: Path):
    """Import ``ircolor_tpu_torch`` (and ``chip_smoke``) from ``root``."""
    for name in [m for m in sys.modules if m.startswith("ircolor_tpu_torch") or m == "chip_smoke"]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        return importlib.import_module("ircolor_tpu_torch.kernels.build")
    finally:
        sys.path.pop(0)


def sass_by_kernel(root: Path) -> dict:
    build = _use(root)
    build.load("conv_fwd")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(build._lib_path("conv_fwd"))],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        # The anonymous namespace's mangled name carries a hash of the source.
        line = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "(anon)", line)
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name:
            body = re.sub(r"/\*.*?\*/", "", line).strip()
            if body:
                out[name].append(body)
    return out


def compare_sass(root: Path, other: Path) -> None:
    a, b = sass_by_kernel(root), sass_by_kernel(other)
    for name in sorted(set(a) | set(b)):
        short = name.replace("_ZN7ircolor(anon)", "")[:72]
        if name not in a or name not in b:
            print(f"[sass] {short}: only in {root if name in a else other}")
            continue
        diff = sum(x != y for x, y in zip(a[name], b[name])) + abs(len(a[name]) - len(b[name]))
        state = "identical" if diff == 0 else f"{diff} lines differ"
        print(f"[sass] {short}: {state} ({len(a[name])} / {len(b[name])} lines)")


def turn(root: Path, halo_only: bool = False) -> None:
    import torch

    build = _use(root)
    sys.path.insert(0, str(root))
    cs = importlib.import_module("chip_smoke")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    print(f"[turn {root}] build {time.perf_counter() - t0:.1f} s", flush=True)
    res: list = []
    if not halo_only:
        cs.check_kernels(torch, res)
        cs.check_bwd_kernels(torch, res)
        with torch.inference_mode():
            g5, w5, xs5 = cs.slice5_setup(torch)
            cs.check_slice5_kernels(torch, res, w5, xs5)
            del g5, w5, xs5
        torch.cuda.empty_cache()
    split = cs.check_halo_kernels(torch, res)
    print(f"[turn {root}] phases {time.perf_counter() - t0:.1f} s", flush=True)
    print("TURN " + json.dumps({"root": str(root), "ms": {r["name"]: r["ms"] for r in res},
                                "library_ms": {r["name"]: r.get("library_ms") for r in res},
                                "split": split}), flush=True)


def host_profile(root: Path, calls: int = 200) -> None:
    import cProfile
    import pstats

    import torch

    build = _use(root)
    build.build_all()
    sys.path.insert(0, str(root))
    from ircolor_tpu_torch.kernels import resblock
    from ircolor_tpu_torch.parallel.spatial import exchange_halo_rows, shard_h

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4, 128, 160, 256, device="cuda", generator=g).to(torch.bfloat16)
    k = (torch.randn(3, 3, 256, 256, device="cuda", generator=g) * 0.05).to(torch.bfloat16)
    xs = shard_h(x, [x.device] * 4)
    hr = exchange_halo_rows(xs, 1)[0]

    def call():
        return resblock.conv3x3_reflect_fused(xs[0], k, halo="separate", halo_rows=hr, sums=True)

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(calls):
        call()
    prof.disable()
    host = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    print(f"[host profile {root}] {calls} calls, {host:.4f} ms a call under cProfile", flush=True)
    pstats.Stats(prof, stream=sys.stdout).sort_stats("tottime").print_stats(25)


def spatial_turn(root: Path) -> None:
    """Phase 8b from ROOT's ``chip_smoke.py``; its frames/s read from the
    lines it logs, so that a checkout whose phase returns nothing works."""
    import numpy as np
    import torch

    build = _use(root)
    sys.path.insert(0, str(root))
    cs = importlib.import_module("chip_smoke")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    fps, log = {}, cs.log

    def reading(msg: str) -> None:
        found = re.match(r"\[(spatial [^\]]+)\] ([0-9.]+) frames/s", msg)
        if found:
            fps[found[1]] = float(found[2])
        log(msg)

    cs.log = reading
    t0 = time.perf_counter()
    cs.spatial_serving_phase(torch, np, {})
    print(f"[turn {root}] phase 8b {time.perf_counter() - t0:.1f} s", flush=True)
    print("TURN " + json.dumps({"root": str(root), "frames_per_s": fps}), flush=True)


def sp_variants_turn(root: Path) -> None:
    """Phases 12b–12e from ROOT's ``chip_smoke.py``; frames/s and ms a step
    read from the lines it logs."""
    import numpy as np
    import torch

    build = _use(root)
    sys.path.insert(0, str(root))
    cs = importlib.import_module("chip_smoke")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    out, log, cell = {}, cs.log, {"label": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()

    def reading(msg: str) -> None:
        found = re.match(r"\[(spatial [^\]]+)\] ([0-9.]+) frames/s", msg)
        if found:
            out[found[1]] = float(found[2])
        found = re.match(r"\[(sp train [^\]]+)\]", msg)
        if found:
            cell["label"] = found[1]
        found = re.search(r"S = \d+ on cuda:0: ([0-9.]+) ms a step .*unsharded ([0-9.]+) ms", msg,
                          re.S)
        if found and cell["label"]:
            out[f"{cell['label']} ms a step"] = float(found[1])
            out[f"{cell['label']} unsharded ms a step"] = float(found[2])
        log(msg)

    cs.log = reading
    t0 = time.perf_counter()
    counts: dict = {}
    cs.sp_variant_serving_phase(torch, np, counts, {"int8": {"mean_d": float("inf")}})
    cs.sp_variant_train_phase(torch, np, counts, smi)
    print(f"[turn {root}] phases 12b-12e {time.perf_counter() - t0:.1f} s", flush=True)
    print("TURN " + json.dumps({"root": str(root), **out}), flush=True)


def serve_turn(root: Path) -> None:
    """Phase 3's b32 frames/s and b1 latencies from ROOT's ``chip_smoke.py``."""
    import numpy as np
    import torch

    build = _use(root)
    sys.path.insert(0, str(root))
    cs = importlib.import_module("chip_smoke")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    tails_head = {"norm_relu_blur_down": 2, "conv7x7_head": 1}
    counts: dict = {}
    t0 = time.perf_counter()
    out = {
        "int8_fps": cs.serve(torch, np, "int8", {}, True,
                             {"conv3x3_reflect_fused_q": 18, **tails_head}, counts),
        "float_fps": cs.serve(torch, np, "float", {"quant_int8": False}, False,
                              {"conv3x3_reflect_fused": 18, **tails_head}, counts),
        "b1_int8_ms": cs.latency_b1(torch, np, "int8 (a)", True, {"conv3x3_int8": 24}, counts),
        "b1_float_ms": cs.latency_b1(torch, np, "float", False, {}, counts),
    }
    print(f"[turn {root}] phase 3 {time.perf_counter() - t0:.1f} s", flush=True)
    kernels = importlib.import_module("ircolor_tpu_torch.kernels")
    if hasattr(kernels, "exported_op"):
        t0 = time.perf_counter()
        for _ in range(10**6):
            kernels.exported_op("conv3x3_int8")
        out["exported_op_us"] = time.perf_counter() - t0  # seconds over 10^6 calls = µs a call
    print("TURN " + json.dumps({"root": str(root), **out}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", type=Path, help="the checkout whose kernels this turn runs")
    ap.add_argument("--sass", type=Path, default=None,
                    help="compare csrc/conv_fwd.cu's SASS against this checkout's instead")
    ap.add_argument("--spatial", action="store_true",
                    help="time phase 8b (spatial serving) instead of the kernel rows")
    ap.add_argument("--halo", action="store_true", help="phase 8a's rows alone")
    ap.add_argument("--sp-variants", action="store_true",
                    help="time phases 12b-12e (the variants on shards) instead")
    ap.add_argument("--serve", action="store_true",
                    help="phase 3's b32 frames/s and b1 latencies instead")
    ap.add_argument("--host-profile", action="store_true",
                    help="cProfile row 2's halo form's host path instead")
    args = ap.parse_args()
    if args.sass is not None:
        compare_sass(args.root.resolve(), args.sass.resolve())
    elif args.spatial:
        spatial_turn(args.root.resolve())
    elif args.sp_variants:
        sp_variants_turn(args.root.resolve())
    elif args.serve:
        serve_turn(args.root.resolve())
    elif args.host_profile:
        host_profile(args.root.resolve())
    else:
        turn(args.root.resolve(), args.halo)
    return 0


if __name__ == "__main__":
    sys.exit(main())
