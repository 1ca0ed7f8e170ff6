"""The serving artifact: the whole inference step as a ``torch.export``
program (``ircolor_tpu/export/aot.py``).

``export_inference`` traces ``IR [-1, 1] float32 (B, H, W, C) → uint8 RGB``
(the generator in eval mode, then ``make_infer_fn``'s uint8 step) with the
weights baked in, batch-norm running statistics included, for one batch
size and one device: shapes are static, as in the JAX package, so export
one artifact per batch size. ``torch.export.save`` writes it, and
``torch.export.load`` runs it with no model code.

* **Portable** (the default): the fused kernels' gates are turned off
  (``pallas_block``, ``pallas_norm_blur``, ``pallas_head``, ``use_pallas``,
  as the JAX export strips its Pallas kernels), and every ``ircolor::`` op
  still traced (on the int8 route, the int8 conv) is replaced by its plain
  version (``kernels/library.py:PLAIN``; the int8 conv's is bit-identical
  to the kernel). The artifact holds aten ops only and loads in a process
  that never imports this package. The int8 conv's plain version loops
  over images and taps, so an int8 artifact's graph grows with the batch.
* **keep_pallas**: the serving kernels stay in the graph as the
  ``torch.library`` ops of ``kernels/library.py`` (the counterpart of the
  JAX artifact's ``tpu_custom_call``s): a CUDA artifact launches the same
  hand-written kernels as the eager step, and loading it needs this
  package (``load_exported`` registers the ops). On a CPU device the ops
  run their plain versions. ``run_export`` takes it on ``cuda`` only.
"""

from __future__ import annotations

import collections
import copy
import io
import os

import torch

from ircolor_tpu_torch.eval.metrics import quantize_to_uint8_01
from ircolor_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# The gates of the fused kernels, off in the portable artifact.
_KERNEL_GATES = ("pallas_block", "pallas_norm_blur", "pallas_head", "use_pallas")
_DEVICES = ("cuda", "cpu")


class ServingStep(torch.nn.Module):
    """The exported step: the generator, then the uint8 prediction of
    ``eval/runner.py:make_infer_fn``."""

    def __init__(self, generator: torch.nn.Module):
        super().__init__()
        self.generator = generator

    def forward(self, ir: torch.Tensor) -> torch.Tensor:
        fake = self.generator(ir)
        return (quantize_to_uint8_01((fake + 1.0) / 2.0) * 255.0).to(torch.uint8)


def kernel_calls(program: torch.export.ExportedProgram) -> collections.Counter:
    """How many times the program's graph calls each ``ircolor::`` op."""
    return collections.Counter(
        node.target.name()
        for node in program.graph.nodes
        if node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload)
        and node.target.namespace == "ircolor"
    )


def without_kernels(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` with the fused kernels' gates off: the route
    that the portable artifact traces."""
    plain = copy.deepcopy(module)
    for m in plain.modules():
        for gate in _KERNEL_GATES:
            if getattr(m, gate, False):
                setattr(m, gate, False)
    return plain


def export_inference(
    module: torch.nn.Module,
    height: int,
    width: int,
    *,
    batch_size: int = 16,
    input_nc: int = 1,
    device: str | torch.device | None = None,
    keep_pallas: bool = False,
) -> bytes:
    """``torch.export.save`` bytes of the serving step of ``module`` (the
    port's generator; it is copied, not changed) at ``(batch_size, height,
    width, input_nc)``, traced on ``device`` (default: the module's own).
    ``keep_pallas``: the serving kernels stay in the graph as ``ircolor::``
    ops (a warning where no gate let one in); else a portable aten-only
    graph (module docstring)."""
    from ircolor_tpu_torch.kernels import library

    generator = (copy.deepcopy(module) if keep_pallas else without_kernels(module)).eval()
    if device is not None:
        generator = generator.to(device)
    dev = next(generator.parameters()).device
    example = torch.zeros((batch_size, height, width, input_nc), dtype=torch.float32, device=dev)
    with torch.no_grad():
        program = torch.export.export(ServingStep(generator), (example,), strict=False)
    calls = kernel_calls(program)
    if keep_pallas and not calls:
        log.warning("WARNING: keep_pallas requested but no fused kernel engaged for this "
                    "config (dtype, area and shape gates): the artifact serves the plain graph.")
    if not keep_pallas and calls:
        log.warning("WARNING: the portable artifact runs %s on plain versions (the int8 conv's "
                    "float64 one is ~10x the eager step at 512x640 b32 on an H100, PERF.md §6); "
                    "--export-keep-pallas keeps the kernels", sorted(calls))
        program = program.run_decompositions(library.PLAIN)
        if left := kernel_calls(program):
            raise RuntimeError(f"ircolor ops left in the portable artifact: {dict(left)}")
    # The artifact keeps its example input: a broadcast zero (one element
    # stored), not the batch of zeros traced above (42 MB at 512×640 b32).
    program.example_inputs = ((torch.zeros((), device=dev).expand(example.shape),), {})
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def save_exported(path: str, blob: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)


def load_program(source) -> torch.export.ExportedProgram:
    """The ``ExportedProgram`` of an artifact (a path or a file object),
    after registering the ``ircolor`` ops it may call."""
    from ircolor_tpu_torch.kernels import library  # noqa: F401 (registers the ircolor ops)

    return torch.export.load(source)


def load_exported(path: str):
    """The artifact at ``path`` as a callable: uint8 RGB (B, H, W, 3) of an
    IR batch on the device it was traced for."""
    return load_program(path).module()


def artifact_has_kernels(blob: bytes) -> bool:
    """True iff the artifact's graph calls an ``ircolor::`` op (a kernel)."""
    return bool(kernel_calls(load_program(io.BytesIO(blob))))


def _export_device(cfg, device: str | torch.device | None = None) -> torch.device:
    """The device an artifact is traced for: ``cfg.export_platforms`` (one of
    ``cuda``, ``cpu``) where set, else ``device``. A torch artifact is
    traced for one device: a list of several raises ``ValueError``."""
    from ircolor_tpu_torch.models.wrapper import resolve_device

    if cfg.export_platforms:
        names = [p.strip() for p in cfg.export_platforms.split(",") if p.strip()]
        if len(names) != 1 or names[0] not in _DEVICES:
            raise ValueError(
                f"export_platforms={cfg.export_platforms!r}: a torch.export artifact is traced "
                f"for one device; name one of {_DEVICES}")
        device = names[0]
    return resolve_device(device)


def run_export(cfg, device: str | torch.device | None = None) -> str:
    """The CLI's ``export`` mode: the generator of ``cfg`` with
    ``test_G_weights`` (``.pth`` or ``.msgpack``; random weights from
    ``cfg.seed`` with a warning where it is unset or missing), exported at
    ``cfg.resolved_hw`` and ``resolved_test_batch_size`` and written to
    ``cfg.export_out``. ``export_keep_pallas`` keeps the kernels in the
    graph and needs ``cuda``. Returns the output path."""
    from ircolor_tpu_torch.models.wrapper import IRColorizationModel

    dev = _export_device(cfg, device)
    if cfg.export_keep_pallas and dev.type != "cuda":
        raise ValueError(
            f"--export-keep-pallas embeds the CUDA kernels: it needs device 'cuda', got {dev}")
    model = IRColorizationModel(cfg, dev)
    if cfg.test_G_weights is not None and os.path.isfile(cfg.test_G_weights):
        log.info("Loading generator weights from: %s", cfg.test_G_weights)
        model.load_weights(cfg.test_G_weights)
    else:
        log.warning("WARNING: cfg.test_G_weights is None or does not exist; "
                    "exporting a randomly initialized generator.")
    h, w = cfg.resolved_hw
    b = cfg.resolved_test_batch_size
    blob = export_inference(model.module, h, w, batch_size=b, input_nc=cfg.input_nc, device=dev,
                            keep_pallas=cfg.export_keep_pallas)
    save_exported(cfg.export_out, blob)
    kind = ("kernel" if cfg.export_keep_pallas and artifact_has_kernels(blob)
            else "portable (aten ops only)")
    log.info("Exported %s serving artifact: %s (%.1f MB, %dx%d b%d, %s)",
             kind, cfg.export_out, len(blob) / 1e6, h, w, b, dev)
    return cfg.export_out
