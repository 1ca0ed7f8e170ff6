"""Export time and graph size of the flagship's serving artifact on the card
(``configs/flagship_512x640.json``, random weights from seed 0): one
``export_inference`` at the given batch, the artifact's size, its graph's
nodes and ``ircolor::`` ops, its load time, and its ms a batch (3 calls
after one warm-up, host clock ending in a synchronize). Prints one JSON
line, ``EXPORT {...}``.

    python3 ircolor_tpu_torch/tools/export_probe.py --batch 32 --int8
    python3 ircolor_tpu_torch/tools/export_probe.py --batch 32 --keep-pallas

The portable int8 artifact is the case to watch: the int8 conv's plain
version (``kernels/conv_int8.py:int_conv_exact``) unrolls over images and
taps, so its graph grows with the batch.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--int8", action="store_true", help="int8 serving (default: float)")
    ap.add_argument("--keep-pallas", action="store_true", help="keep the kernels in the graph")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("export_probe: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from ircolor_tpu_torch.config import Config
    from ircolor_tpu_torch.export import aot
    from ircolor_tpu_torch.kernels import build
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    build.build_all()
    cfg = Config.from_json((ROOT / "configs" / "flagship_512x640.json").read_text()).replace(
        mode="test", seed=0, quant_int8=args.int8, test_batch_size=args.batch)
    h, w = cfg.resolved_hw
    model = IRColorizationModel(cfg, "cuda")
    t0 = time.perf_counter()
    blob = aot.export_inference(model.module, h, w, batch_size=args.batch,
                                keep_pallas=args.keep_pallas)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = aot.load_program(io.BytesIO(blob))
    step = program.module()
    load_s = time.perf_counter() - t0
    ir = torch.rand(args.batch, h, w, 1, device="cuda") * 2 - 1
    with torch.inference_mode():
        step(ir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step(ir)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 3
    print("EXPORT " + json.dumps({
        "batch": args.batch, "int8": args.int8, "keep_pallas": args.keep_pallas,
        "export_s": round(export_s, 3), "mb": round(len(blob) / 1e6, 3),
        "nodes": len(program.graph.nodes), "ircolor_ops": dict(aot.kernel_calls(program)),
        "load_s": round(load_s, 3), "ms_per_batch": round(ms, 3),
        "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
