"""Run one cell of the benchmark once and print its result as the last line
of standard output (README.md):

    python3 -m portbench.run --workload flagship-serve-int8-b32 --seed 7 \
        --seconds 30 --trace 0

The cell, its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``) and the
metrics it reports are found by name from ``BENCHMARK.json``; each
end-to-end metric is read by ``end_to_end/<name>.py`` and each per-layer
metric by ``metrics/<name>.py``. ``--trace 0`` reports the end-to-end
metrics, ``--trace 1`` the per-layer ones, from a profiled sub-window run
after the measured one.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ircolor_tpu")


def _load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_reader_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> dict:
    """Everything a cell names, found by name: its entry, configuration,
    traffic, limits and the readers of the metrics it reports."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return {
        "cell": cell,
        "config": json.loads((ROOT / config["file"]).read_text()),
        "traffic": json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((HERE / "limits" / f"{name}.json").read_text()),
        "end_to_end": {m["name"]: (m, _load_module(HERE / "end_to_end" / f"{m['name']}.py"))
                       for m in bench["end_to_end"] if applies(m)},
        "per_layer": {m["name"]: (m, _load_module(HERE / "metrics" / f"{m['name']}.py"))
                      for m in bench["per_layer"] if applies(m)},
    }


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             setup_t0: float | None = None) -> tuple[dict, list[str]]:
    """One run of a cell: set-up, the measured window, the traced
    sub-window where ``trace``, the comparison. Returns (the result object,
    the lines of numbers compared, for standard error)."""
    import torch

    from portbench import cells, compare, trace as tr

    t0 = _T0 if setup_t0 is None else setup_t0
    cell = cells.kind(spec["traffic"]["kind"])(spec["config"], spec["traffic"], seed, device,
                                                tr.Spans())
    cell.start_wall = time.time() - (time.perf_counter() - t0)
    cell.per_layer = list(spec["per_layer"])
    cell.setup()
    cell.begin_window()
    cell.setup_s = time.perf_counter() - t0
    cell.window(seconds, trace)
    cell.end_window()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded in the measuring process: {found}")

    if trace:
        cell.trace([w for _, mod in spec["per_layer"].values() for w in getattr(mod, "WRAPS", ())])

    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for name, (m, mod) in spec[group].items():
        value = mod.read(cell)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": m["unit"]}

    cell.release()
    if cell.cuda:
        torch.cuda.empty_cache()
    numbers = cell.check()
    ok, checks = compare.judge(numbers, spec["limits"])
    ok = ok and cell.window_failed == 0 and cell.attempted > 0
    dev = {"platform": "gpu" if cell.cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cell.cuda else "cpu",
           "count": spec["cell"]["chips"], "memory_peak_bytes": int(cell.peak_bytes)}
    if trace and cell.summary:
        dev.update(busy_s=cell.summary["busy_s"], window_s=cell.summary["window_s"])
    result = {"correct": bool(ok), "attempted": int(cell.attempted),
              "failed": int(cell.window_failed), "metrics": metrics, "device": dev}
    if trace and cell.summary:
        result["breakdown"] = {"device_ops": cell.summary["device_ops"],
                               "idle_gaps": cell.summary["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    lines = []
    if trace and cell.summary:
        s = cell.summary
        lines.append(f"profile: {s['ops']} device operations, {s['ops_matched']} matched to a "
                     f"launch; kernel ranges {s['range_s']}; calls "
                     f"{ {k: len(v) for k, v in cell.calls.items()} }")
    lines += [f"check {k}: {v!r} (limit {lim!r})" for k, (v, lim) in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)

    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), {n} visible", file=sys.stderr)
        return 2
    card = power_limit()
    result, lines = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(f"card: {card}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
