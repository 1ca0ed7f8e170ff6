"""ircolor_tpu_torch — the PyTorch + CUDA port of ``ircolor_tpu``.

The same LWIR→RGB colorization system, for one NVIDIA H100. The JAX package
beside it stays the reference; this package imports ``torch`` and never
``jax``, ``ircolor_tpu``, ``cv2``, ``PIL`` or ``triton`` at import time.

Module names mirror the JAX package so a reader can find each counterpart:

  config    — the same ``Config`` fields and defaults
  ops       — reflect pads, instance norm, blur-pool down/up, align-corners
              resize (plain torch); int8 quantization and the int8 conv
              route
  kernels   — the hand-written Hopper kernels (``csrc/*.cu``) behind Python
              wrappers, each beside its plain PyTorch version
  models    — ``ResnetUNetGenerator`` and ``NLayerDiscriminator`` with the
              reference state_dict names
  losses    — hinge GAN, TV, SSIM, the VGG-16 perceptual tower
  compat    — JAX param trees (numpy) → port state_dicts
  eval      — the serving step (``make_infer_fn``) and ``run_test``
  train     — LR schedule, train state, the D-then-G step, checkpoints,
              ``train_kaist``
  data, export, utils — KAIST pairs and batch loading, host-side I/O,
              Top-K/CSV, logging

Layout: activations are contiguous NHWC tensors, the JAX package's layout
and the kernels'. torch's NCHW operators receive ``x.permute(0, 3, 1, 2)``,
a zero-copy ``channels_last`` view (``ops/layout.py``).
"""

__version__ = "0.1.0"

from ircolor_tpu_torch.config import Config  # noqa: F401
