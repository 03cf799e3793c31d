"""Losses and image-quality metrics."""

from .losses import (
    PHASE_LOSSES,
    amp_loss,
    amp_phs_loss,
    focal_freq_loss,
    focal_sincos_phase_gradient_loss,
    focal_sincos_phase_loss,
    mse,
    phase_sincos_gradient_loss,
    plain_phase_loss,
    total_variation,
    total_variation_for_poh,
    total_variation_loss,
)
from .metrics import psnr, ssim
from .perceptual import VGG19Features, load_vgg19_params, make_vgg19, perceptual_loss

__all__ = [
    "PHASE_LOSSES",
    "amp_loss",
    "amp_phs_loss",
    "focal_freq_loss",
    "focal_sincos_phase_gradient_loss",
    "focal_sincos_phase_loss",
    "mse",
    "phase_sincos_gradient_loss",
    "plain_phase_loss",
    "total_variation",
    "total_variation_for_poh",
    "total_variation_loss",
    "psnr",
    "ssim",
    "VGG19Features",
    "load_vgg19_params",
    "make_vgg19",
    "perceptual_loss",
]
