"""Training losses (``ircolor_tpu/losses``): hinge GAN, anisotropic TV,
Gaussian-window SSIM and the VGG-16 perceptual tower. Inputs are NHWC."""

from ircolor_tpu_torch.losses.gan import hinge_d_loss, hinge_g_loss
from ircolor_tpu_torch.losses.ssim import ssim_index, ssim_loss
from ircolor_tpu_torch.losses.tv import tv_loss
from ircolor_tpu_torch.losses.vgg import VGG16Features, load_vgg16

__all__ = [
    "hinge_d_loss",
    "hinge_g_loss",
    "tv_loss",
    "ssim_loss",
    "ssim_index",
    "VGG16Features",
    "load_vgg16",
]
