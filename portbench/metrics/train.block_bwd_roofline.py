"""Rows 5 and 6, the block dgrad and wgrad (``kernels/resblock.py:
conv3x3_dgrad_fused`` -> ``csrc/conv_fwd.cu``, ``conv3x3_wgrad_fused`` ->
``csrc/wgrad.cu``): the calls' least time over the device time of the
kernels they launch, %."""

from portbench import roofline
from portbench.readers import roofline as share


def _dgrad(args, kwargs):
    return roofline.block_dgrad(*args[0].shape)


def _wgrad(args, kwargs):
    return roofline.block_wgrad(*args[0].shape)


WRAPS = [("ircolor_tpu_torch.kernels.resblock", "conv3x3_dgrad_fused", "block_dgrad", _dgrad),
         ("ircolor_tpu_torch.kernels.resblock", "conv3x3_wgrad_fused", "block_wgrad", _wgrad)]


def read(run):
    return share(run, "train", ("block_dgrad", "block_wgrad"))
