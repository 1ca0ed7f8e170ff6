"""Generator wrapper: construction from Config, weight loading, forward
(``ircolor_tpu/models/wrapper.py``).

Random init is N(0, init_gain) kernels, N(1, init_gain) batch-norm
weights and zero biases from a ``torch.Generator`` seeded with ``cfg.seed``
— the same distribution as the JAX package, not the same numbers. ``.pth``
loading is permissive like the reference: a ``{'state_dict': ...}`` wrapper
is unwrapped, missing keys keep their init, extra or mis-shaped keys are
ignored, with a warning either way; batch-norm running statistics load
with the weights (the module serves in eval mode, on them). The JAX
package's ``.msgpack`` exports (params only) load the same way.
"""

from __future__ import annotations

import os

import torch

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.models.generator import ResnetUNetGenerator
from ircolor_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


# The JAX package's ``conv_precision`` names (``ops/conv.py:_PRECISIONS``),
# read on the f32 path only. Each maps to whether cuDNN convs and matmuls may
# use TF32: ``highest`` is full f32 (XLA's HIGHEST); ``high`` and ``default``
# let XLA take reduced-precision passes, and TF32 is the card's nearest
# counterpart of those.
_PRECISIONS = {"default": True, "high": True, "highest": False}


def resolve_precision(cfg: Config) -> bool | None:
    """Whether TF32 is allowed for ``cfg``: None on bf16 (the JAX package
    reads ``conv_precision`` only on f32), else by name; an unknown name
    raises ``KeyError``, as ``ops.conv.resolve_precision`` does."""
    if cfg.compute_dtype != "f32":
        return None
    return _PRECISIONS[cfg.conv_precision]


def reject_unported(cfg: Config) -> None:
    """Raise ``ValueError`` for the config the JAX runner refuses: a W mesh
    axis without an H one (``runner.py:179-184``). Every mode of the JAX
    package runs: data parallelism (``dp_devices``), the 1-D H mesh
    (``sp_devices > 1``) in test mode and in training, and 2-D H×W tiling
    (``sp_w_devices > 1`` with it) in test mode, with every model variant;
    training does not read ``sp_w_devices``, as in JAX
    (``train.state.without_sp_w``)."""
    if cfg.sp_w_devices > 1 and cfg.sp_devices <= 1:
        raise ValueError(
            f"sp_w_devices={cfg.sp_w_devices} requires sp_devices > 1 "
            "(the W axis is a factor of the spatial mesh: sp_devices "
            "total devices tiled (sp_devices/sp_w_devices)×sp_w_devices); "
            "set --sp-devices as well"
        )


def generator_from_config(cfg: Config) -> ResnetUNetGenerator:
    """Build the generator per cfg (the JAX wrapper's: reflect padding, no
    dropout; ``norm``, ``no_antialias``, ``no_antialias_up`` and ``remat``
    from the config). On the f32 path
    ``conv_precision`` sets TF32 for convolutions and matmuls
    (``resolve_precision``): off for ``highest`` (the default: the JAX f32
    parity path runs HIGHEST-precision convs), on for ``high`` and
    ``default``."""
    reject_unported(cfg)
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
    tf32 = resolve_precision(cfg)
    if tf32 is not None:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return ResnetUNetGenerator(
        input_nc=cfg.input_nc,
        output_nc=cfg.output_nc,
        ngf=cfg.ngf,
        n_blocks=cfg.n_blocks,
        norm=cfg.norm,
        no_antialias=cfg.no_antialias,
        no_antialias_up=cfg.no_antialias_up,
        remat=cfg.remat,
        dtype=_DTYPES[cfg.compute_dtype],
        use_pallas=cfg.use_pallas,
        pallas_block=cfg.pallas_block,
        pallas_block_bwd=cfg.pallas_block_bwd,
        pallas_encdec_bwd=cfg.pallas_encdec_bwd,
        pallas_norm_blur=cfg.pallas_norm_blur,
        pallas_norm_blur_min_area=cfg.pallas_norm_blur_min_area,
        pallas_norm_blur_min_launch=cfg.pallas_norm_blur_min_launch,
        pallas_head=cfg.pallas_head,
        pallas_head_min_area=cfg.pallas_head_min_area,
        pallas_head_min_launch=cfg.pallas_head_min_launch,
        quant_int8=cfg.resolved_quant_int8,
        quant_fixed_u2=cfg.quant_fixed_u2,
        quant_head=cfg.quant_head,
    )


def load_state_permissive(module: torch.nn.Module, state: dict) -> None:
    """``load_state_dict(strict=False)`` that also skips mis-shaped entries."""
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    own = module.state_dict()
    usable = {
        k: v for k, v in state.items() if k in own and tuple(v.shape) == tuple(own[k].shape)
    }
    missing = sorted(set(own) - set(usable))
    unused = sorted(set(state) - set(usable))
    if missing:
        log.warning("load_weights: %d entries kept their init (missing in ckpt): %s",
                    len(missing), missing[:5])
    if unused:
        log.warning("load_weights: %d ckpt entries unused: %s", len(unused), unused[:5])
    module.load_state_dict(usable, strict=False)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    the CPU. Raises where CUDA is asked for (or defaulted to) and absent —
    there is no silent move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: ircolor_tpu_torch runs on the GPU; pass "
            "device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


class IRColorizationModel:
    """Holds the generator on an explicit device (default: the card)."""

    def __init__(self, cfg: Config, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        module = generator_from_config(cfg)
        module.init_weights(
            cfg.init_type, cfg.init_gain, torch.Generator().manual_seed(cfg.seed)
        )
        self.module = module.to(self.device).eval()

    def load_weights(self, path: str) -> None:
        """A ``.pth`` / ``.pt`` generator state dict, or else the JAX
        package's ``.msgpack`` export of the params (``train.checkpoint.
        load_netg_state``); non-strict either way."""
        from ircolor_tpu_torch.train.checkpoint import load_netg_state

        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        load_state_permissive(self.module, load_netg_state(path, self.module))
        self.module.to(self.device)

    @torch.inference_mode()
    def __call__(self, ir: torch.Tensor) -> torch.Tensor:
        """IR (B, H, W, 1) in [-1, 1] → RGB (B, H, W, 3) in [-1, 1]."""
        return self.module(ir.to(self.device))
