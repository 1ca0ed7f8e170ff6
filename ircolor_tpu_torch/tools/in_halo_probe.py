"""Where row 11h's cluster form spends its device time: the cluster launch
(``csrc/instance_norm.cu``, ``in_cluster_kernel``) on the H-shards of the
256² bottleneck 16×64×64×256 bf16, IN + ReLU, at S = 2 and 4.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 ircolor_tpu_torch/tools/in_halo_probe.py

Builds the source as it is and with one edit each (``build/in_halo_probe/``,
the package's ``nvcc`` flags, all at once) and times each variant's launch
alone, device ms a call by CUDA events over 40 back-to-back launches that
cycle over 4 input sets (L2 cold), in turns with the unedited library at
the plan's slice (base, variant, variant, base):

- ``32-byte slices`` / ``64-byte slices``: the unedited library at the
  slice the plan does not take (the plan takes 64 bytes at both S here);
- ``unstaged``: the unedited library with no staging (every CTA reads x
  three times): what staging saves;
- ``256 threads`` / ``1024 threads``: a block of 256 or 1024 threads (512);
- ``no exchange``: the cluster barriers become block barriers and each CTA
  merges its own statistics S times (wrong output by design): the cost of
  the exchange through distributed shared memory.

Also kernel 11 on the gathered plane and the per-shard form's stats launch
alone. Every variant but ``no exchange`` is held to the base's output
within one bf16 ulp. Prints the card's name and power limit first, then
one line a variant and S.

With ``--host``: instead, where the host's time a cluster-form call goes:
``cProfile`` over 500 calls of ``run_in_spatial`` (S = 2, the same
shards), its functions by their own time (cProfile's own cost inflates
every entry), beside the host ms a call without the profiler.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PLANE = (16, 64, 64, 256)
SMEM = 232448

# name: [(text in csrc/instance_norm.cu, its replacement)], threads a block
VARIANTS = {
    "256 threads": ([("constexpr int NTHREADS = 512;", "constexpr int NTHREADS = 256;")], 256),
    "1024 threads": ([("constexpr int NTHREADS = 512;", "constexpr int NTHREADS = 1024;")], 1024),
    "no exchange": ([("  cluster.sync();  // every rank's", "  __syncthreads();  // every rank's"),
                     ("cluster.map_shared_rank(stat, j)", "stat + 0 * j"),
                     ("  cluster.sync();  // no CTA exits", "  __syncthreads();  // no CTA exits")],
                    512),
}


def _build(name: str, edits: list) -> Path:
    from ircolor_tpu_torch.kernels import build

    src = (build.CSRC / "instance_norm.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: edit target not found: {old!r}")
        src = src.replace(old, new)
    out_dir = REPO / "build" / "in_halo_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = name.replace(" ", "_")
    cu, lib = out_dir / f"{tag}.cu", out_dir / f"lib_{tag}.so"
    cu.write_text(src)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
                    str(cu)], check=True, capture_output=True, text=True)
    return lib


def _bind(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    ints, ptrs = ctypes.POINTER(i), ctypes.POINTER(p)
    lib.ircolor_instance_norm_cluster.argtypes = [i, i, i, i, i, ptrs, ptrs, ptrs, ints, ints, p,
                                                  p, i, i, i, p]
    lib.ircolor_instance_norm.argtypes = [i, i, i, p, p, p, i, i, i, i, p]
    lib.ircolor_instance_norm_stats.argtypes = [i, i, i, p, p, p, i, i, i, i, p]
    return lib


def host_profile() -> None:
    import cProfile
    import io
    import pstats
    import time

    import torch

    from ircolor_tpu_torch.kernels import instance_norm as tin

    gen = torch.Generator(device="cuda").manual_seed(12)
    x = (torch.randn(*PLANE, device="cuda", generator=gen) * 3 + 1).to(torch.bfloat16)
    xs = [p.contiguous() for p in x.split(PLANE[1] // 2, 1)]
    for _ in range(20):
        tin.run_in_spatial(xs, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        tin.run_in_spatial(xs, True)
    host = (time.perf_counter() - t0) * 2  # ms a call over 500 calls
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(500):
        tin.run_in_spatial(xs, True)
    prof.disable()
    torch.cuda.synchronize()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(25)
    print(f"[host] {host:.4f} ms a call (S = 2, bf16 IN + ReLU, 500 calls)\n{text.getvalue()}",
          flush=True)


def main() -> int:
    import torch

    sys.path.insert(0, str(REPO))
    from chip_smoke import bf16_ulps
    from ircolor_tpu_torch.kernels import build
    from ircolor_tpu_torch.kernels import instance_norm as tin

    if not torch.cuda.is_available():
        print("in_halo_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if "--host" in sys.argv[1:]:
        host_profile()
        return 0
    base = build.load("instance_norm")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(lambda kv: _build(kv[0], kv[1][0]), VARIANTS.items())))
    libs = {"base": _bind(build._lib_path("instance_norm")), **{n: _bind(p) for n, p in
                                                               paths.items()}}
    del base
    b, h, w, c = PLANE
    gen = torch.Generator(device="cuda").manual_seed(12)
    planes = [(torch.randn(*PLANE, device="cuda", generator=gen) * 3 + 1).to(torch.bfloat16)
              for _ in range(4)]
    stream = torch.cuda.current_stream().cuda_stream

    def events_ms(fn, iters=40) -> float:
        for k in range(4):
            fn(k)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for k in range(iters):
            fn(k)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    one = [torch.empty_like(x) for x in planes]
    k11 = events_ms(lambda k: libs["base"].ircolor_instance_norm(
        0, 1, 1, planes[k % 4].data_ptr(), None, one[k % 4].data_ptr(), b, h, w, c, stream))
    print(f"kernel 11 on the plane {tuple(PLANE)}: {k11:.4f} ms", flush=True)
    for s in (2, 4):
        rows = h // s
        shards = [[p.contiguous() for p in x.split(rows, 1)] for x in planes]
        outs = [[torch.empty_like(p) for p in sh] for sh in shards]
        stats = torch.empty((2, b, c), device="cuda")

        def arr(ts):
            return (ctypes.c_void_p * s)(*[t.data_ptr() for t in ts])

        args = [(arr(sh), arr(o)) for sh, o in zip(shards, outs)]
        row_arr = (ctypes.c_int * s)(*([rows] * s))
        col_arr = (ctypes.c_int * s)(*([w] * s))

        sb = tin.halo_plan((rows,) * s, w, c, torch.bfloat16, (planes[0].device,) * s).slice_bytes

        def call(lib, threads, slice_bytes, staged=True):
            head = (threads // 32 + 4) * (slice_bytes // 2) * 4
            plane = rows * w * slice_bytes
            cap = plane if staged and head + plane <= SMEM else 0

            def run(k):
                xa, oa = args[k % 4]
                err = lib.ircolor_instance_norm_cluster(
                    0, 1, 1, slice_bytes, s, xa, None, oa, row_arr, col_arr, stats[0].data_ptr(),
                    stats[1].data_ptr(), b, c, cap, stream)
                if err:
                    raise RuntimeError(f"cluster launch: CUDA error {err}")
            return run

        base_run = call(libs["base"], 512, sb)
        base_run(0)
        want = torch.cat(outs[0], 1).clone()
        stat_ms = events_ms(lambda k: libs["base"].ircolor_instance_norm_stats(
            0, 1, sb, shards[k % 4][0].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), b,
            rows, w, c, stream))
        print(f"S={s}: the plan's slice {sb} bytes; the per-shard form's stats launch on one "
              f"shard {stat_ms:.4f} ms", flush=True)
        other = 96 - sb
        cases = [(f"{other}-byte slices", call(libs["base"], 512, other), True),
                 ("unstaged", call(libs["base"], 512, sb, staged=False), True)]
        cases += [(n, call(libs[n], t, sb), n != "no exchange") for n, (_, t) in VARIANTS.items()]
        for name, run, held in cases:
            run(0)
            torch.cuda.synchronize()
            ulps = bf16_ulps(torch, torch.cat(outs[0], 1), want) if held else float("nan")
            turns = [events_ms(base_run), events_ms(run), events_ms(run), events_ms(base_run)]
            print(f"S={s} {name}: {turns[1]:.4f} / {turns[2]:.4f} ms against the base's "
                  f"{turns[0]:.4f} / {turns[3]:.4f} (base, variant, variant, base); "
                  f"vs base {ulps:.3g} bf16 ulps", flush=True)
            if held and not ulps <= 1:
                raise AssertionError(f"S={s} {name}: {ulps} bf16 ulps from the base")
    return 0


if __name__ == "__main__":
    sys.exit(main())
