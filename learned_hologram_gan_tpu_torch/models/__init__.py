"""Model layer: the two-stage generator and the WGAN-GP critic."""

from .discriminator import FakeDiscriminator, WGANGPDiscriminator192
from .generator import (
    AP2POH,
    Generator,
    RGBD2AP,
    double_phase_encode,
    generator_apply_fused,
    generator_apply_quant,
    make_generator,
    make_generator_plan,
)

__all__ = [
    "AP2POH",
    "FakeDiscriminator",
    "Generator",
    "RGBD2AP",
    "WGANGPDiscriminator192",
    "double_phase_encode",
    "generator_apply_fused",
    "generator_apply_quant",
    "make_generator",
    "make_generator_plan",
]
