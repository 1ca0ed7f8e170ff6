"""The port's hand-written Hopper kernels, each behind a Python wrapper.

Every wrapper takes the JAX function's NHWC signature and dispatches on the
device of its input alone: a CPU tensor runs the plain PyTorch version in
the same module; a CUDA tensor launches the kernel (built from ``csrc/`` at
first use) or raises — no fallback, no silent move to the CPU — on the
tensor's own card and its current stream (``on_input_card``). The wrapper
adds one to its entry in ``LAUNCHES`` where it launches, and nowhere else.
Inside a ``torch.export`` trace the serving wrappers call their
``torch.library`` op instead (``library.py``, ``exported_op``), whose CUDA
kernel is the wrapper again.

  resblock.conv3x3_reflect_fused    ← pallas_resblock.conv3x3_reflect_fused
  resblock.conv3x3_reflect_fused_q  ← pallas_resblock.conv3x3_reflect_fused_q
    (both also in the spatial halo forms ``halo="separate"`` /
    ``"provided"``, counted apart as ``*_halo``; the card runs
    ``"provided"`` as ``"separate"`` on the slab's rows (the int8 form
    reads them in place); ``resblock.resnet_block_pallas(_q)_spatial``
    run them)
  resblock.conv3x3_dgrad_fused      ← pallas_resblock.conv3x3_dgrad_fused
  resblock.conv3x3_wgrad_fused      ← pallas_resblock.conv3x3_wgrad_fused
    (both also in the enc/dec segment modes: ``pad="zero"``, ``mask_p``,
    no aux; counted apart as ``*_seg``; ``encdec.conv_in_relu_fused`` ←
    pallas_encdec.conv_in_relu_fused runs them)
  resblock.conv3x3_sum_fused        ← pallas_resblock.conv3x3_sum_fused
  blur.norm_relu_blur_down_pallas   ← pallas_blur.norm_relu_blur_down_pallas
  blur.blur_downsample_pallas       ← pallas_blur.blur_downsample_pallas
  head.conv7x7_head_pallas          ← pallas_head.conv7x7_head_pallas
  head.conv7x7_head_pallas(quant=True) ← the same with quant=True (outc_head_q)
  conv_int8.conv3x3_int8            ← XLA's int8 conv in ops/quant.conv2d_int8(_fixed)
    (stride 1 or 2; the stride-2 form, the no_antialias down convs, counted
    apart as ``conv3x3_int8_s2``)
  instance_norm.run_in / run_in_res ← pallas_kernels._run_in / _run_in_res
  block.conv3x3_stats / conv3x3_norm_in_stats ← pallas_block.conv3x3_stats /
    conv3x3_norm_in_stats
  conv.conv3x3_valid_pallas(_v2)    ← pallas_conv.conv3x3_valid_pallas(_v2)
    (one kernel, one count: ``conv3x3_valid``)

``conv3x3_reflect_fused``, ``conv3x3_sum_fused``, ``block.*`` and ``conv.*``
run the bf16 conv of ``csrc/conv_fwd.cu`` in its reflect, zero and VALID
halo modes; ``conv3x3_reflect_fused_q`` and ``conv_int8.conv3x3_int8`` run
the same GEMM on s8 operands (the int8 block conv in a form of its own
that quantizes the input on its load, with no pass). ``conv3x3_sum_fused``, ``block.*``,
``conv.*`` and ``blur_downsample_pallas`` are, like the JAX functions, on
no generator route: the JAX tools call them, and so does ``chip_smoke.py``.
"""

from __future__ import annotations

import functools

import torch

LAUNCHES: dict[str, int] = {
    "conv3x3_reflect_fused": 0,
    "conv3x3_reflect_fused_q": 0,
    "conv3x3_reflect_fused_halo": 0,
    "conv3x3_reflect_fused_q_halo": 0,
    "norm_relu_blur_down": 0,
    "conv7x7_head": 0,
    "conv7x7_head_q": 0,
    "conv3x3_int8": 0,
    "conv3x3_int8_s2": 0,
    "conv3x3_dgrad_fused": 0,
    "conv3x3_wgrad_fused": 0,
    "conv3x3_dgrad_fused_seg": 0,
    "conv3x3_wgrad_fused_seg": 0,
    "fused_instance_norm": 0,
    "fused_instance_norm_residual": 0,
    "blur_downsample": 0,
    "conv3x3_valid": 0,
    "conv3x3_stats": 0,
    "conv3x3_norm_in_stats": 0,
    "conv3x3_sum_fused": 0,
}


def exported_op(name: str):
    """The ``torch.library`` op ``ircolor::name`` if a ``torch.export``
    trace is running, else None: a serving wrapper calls the op in a trace
    (its FakeTensors have no storage to launch on) and dispatches on its
    input's device itself in eager, with no op dispatch in between."""
    if not torch.compiler.is_exporting():
        return None
    from ircolor_tpu_torch.kernels import library

    return library.op(name)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (a ``None`` entry matches any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def on_input_card(fn):
    """Decorate a function that launches kernels through ctypes: it runs
    with the card of its first tensor argument (or of the first tensor of a
    list argument) as the current device. A ctypes launch goes to the
    thread's current device, so without this a tensor on another card than
    the current one (a shard of a spatial mesh over several cards) would be
    read by a launch on the wrong card."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        for a in (*args, *kwargs.values()):
            t = a[0] if isinstance(a, (list, tuple)) and a else a
            if isinstance(t, torch.Tensor):
                break
        else:
            raise TypeError(f"{fn.__name__}: no tensor argument")
        if not t.is_cuda or t.device.index == torch.cuda.current_device():
            return fn(*args, **kwargs)
        with torch.cuda.device(t.device):
            return fn(*args, **kwargs)

    return run


def stream_ptr(t: torch.Tensor) -> int:
    """The current stream of ``t``'s card (its ``cudaStream_t``, as
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives it, without
    making a ``Stream`` object), for a launch on that card; raises unless
    it is the current device (``on_input_card``)."""
    index = t.device.index
    if torch.cuda.current_device() != index:
        raise RuntimeError(f"a launch on {t.device} with cuda:{torch.cuda.current_device()} "
                           "current: the launcher must run under on_input_card")
    return torch._C._cuda_getCurrentRawStream(index)
