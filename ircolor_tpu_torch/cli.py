"""Command-line entry point: ``python -m ircolor_tpu_torch train|test|export
[--flag ...]`` (``ircolor_tpu/cli.py``). Every ``Config`` field is a flag, as
in the JAX package, plus ``--config path.json`` and ``--device {cuda,cpu}``
(default ``cuda``: without a card the run stops; ``--device cpu`` is the one
way onto the CPU). ``test --sp-devices N`` runs spatial test mode over N
H-shards (``eval.runner.spatial_generator``: all on the CPU with ``--device
cpu``, else spread over the visible cards); ``train --sp-devices S`` trains
on S H-shards of every image (JAX's GSPMD step on a ``('data', 'sp')``
mesh, every fused kernel off: ``train.loop``), all on the CPU with
``--device cpu``, else on cards 0..S-1 (with ``--dp-devices N`` too, rank
r on cards r·S..r·S+S-1). ``test --sp-devices N --sp-w-devices W`` tiles
each image over an (N / W) × W H×W mesh (as in JAX, ``train`` does not read
``--sp-w-devices``). Both spatial modes take every model variant
(``--norm``, ``--no-antialias``, ``--no-antialias-up``, ``--use-pallas``). ``--dp-devices N`` runs data
parallelism: ``train`` over N ranks, one process each (``train.loop``),
``test`` over N chunks of each batch (``eval.runner.make_infer_fn``), on
the CPU with ``--device cpu``, else on the first N cards (``train`` with
0, the default: every card, fit to the batch). ``export`` writes the serving
step (``--test-g-weights`` baked in, uint8 out) as a ``torch.export``
artifact to ``--export-out`` (``export.aot.run_export``): portable (aten
ops only) by default, with the CUDA kernels inside under
``--export-keep-pallas`` (``cuda`` only)."""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Sequence

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _add_config_flags(parser: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(Config):
        if f.name == "mode":
            continue
        args = ["--" + f.name.replace("_", "-").lower()]
        cased = "--" + f.name.replace("_", "-")
        if cased not in args:
            args.append(cased)
        ann = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", str(f.type))
        if "bool" in {p.strip() for p in ann.split("|")} or isinstance(f.default, bool):
            parser.add_argument(*args, dest=f.name, default=None,
                                action=argparse.BooleanOptionalAction)
        elif f.name in ("train_roots", "test_roots"):
            parser.add_argument(*args, dest=f.name, nargs="+", default=None)
        else:
            parser.add_argument(*args, dest=f.name, default=None)


def _coerce(cfg_field: dataclasses.Field, value: Any) -> Any:
    """Coerce a CLI string by the field's type annotation."""
    if value is None or isinstance(value, (bool, list, tuple)):
        return tuple(value) if isinstance(value, list) else value
    ann = cfg_field.type
    ann = ann if isinstance(ann, str) else getattr(ann, "__name__", str(ann))
    parts = {p.strip() for p in ann.split("|")}
    if value == "none" and "None" in parts:
        return None
    if "int" in parts:
        return int(value)
    if "float" in parts:
        return float(value)
    return value


def build_config(args: argparse.Namespace, mode: str) -> Config:
    if getattr(args, "config", None):
        with open(args.config, "r", encoding="utf-8") as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    overrides: dict[str, Any] = {"mode": mode}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name, None)
        if f.name != "mode" and v is not None:
            overrides[f.name] = _coerce(f, v)
    return cfg.replace(**overrides)


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="ircolor_tpu_torch",
        description="LWIR→RGB colorization on PyTorch + CUDA.",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for name, desc in (("train", "Train on KAIST pairs (--dp-devices N: over N ranks; "
                                 "--sp-devices S: over S H-shards of each image)"),
                       ("test", "Run inference + metrics + exports (--sp-devices S: over "
                                "S H-shards, --sp-w-devices W too: over (S/W)×W H×W tiles; "
                                "--dp-devices N: N chunks a batch)"),
                       ("export", "Write a torch.export serving artifact")):
        p = sub.add_parser(name, help=desc)
        p.add_argument("--config", default=None, help="JSON config file")
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="where to run (default: cuda; no fallback to the CPU)")
        _add_config_flags(p)

    args = parser.parse_args(argv)
    cfg = build_config(args, args.command)
    log.info("Config mode: %s", cfg.mode)
    log.info("OUTPUT_DIR: %s", cfg.output_dir)
    log.info("TEST_G_WEIGHTS: %s", cfg.test_G_weights)
    if cfg.mode == "train":
        from ircolor_tpu_torch.train.loop import train_kaist

        train_kaist(cfg, device=args.device)
        return 0
    if cfg.mode == "export":
        from ircolor_tpu_torch.export.aot import run_export

        run_export(cfg, device=args.device)
        return 0
    from ircolor_tpu_torch.eval.runner import run_test

    run_test(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
