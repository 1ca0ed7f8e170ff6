"""Row 1, the int8 block conv (``kernels/resblock.py:conv3x3_reflect_fused_q``
-> ``csrc/conv_fwd.cu``): the calls' least time over the device time of the
kernels they launch, %."""

from portbench import roofline
from portbench.readers import roofline as share


def _count(args, kwargs):
    x, kq = args[0], args[1]
    b, h, w, c = x.shape
    return roofline.block_conv_q(b, h, w, c, kq.shape[-1])


WRAPS = [("ircolor_tpu_torch.kernels.resblock", "conv3x3_reflect_fused_q", "block_q", _count)]


def read(run):
    return share(run, "serve", ("block_q",))
