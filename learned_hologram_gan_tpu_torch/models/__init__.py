"""Model layer: the two-stage generator."""

from .generator import (
    AP2POH,
    Generator,
    RGBD2AP,
    double_phase_encode,
    make_generator,
    make_generator_plan,
)

__all__ = [
    "AP2POH",
    "Generator",
    "RGBD2AP",
    "double_phase_encode",
    "make_generator",
    "make_generator_plan",
]
