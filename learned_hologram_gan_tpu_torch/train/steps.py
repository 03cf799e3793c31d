"""Inference step (counterpart of
``learned_hologram_gan_tpu/train/steps.py:build_infer_fn``)."""

from __future__ import annotations

from typing import Callable

import torch

from ..models.generator import Generator
from ..ops.asm import PropagatorPlan


def build_infer_fn(generator: Generator) -> Callable:
    """POH inference forward (reference generatePOH.py:41-43): eval mode,
    no autograd."""

    def infer(gen_plan: PropagatorPlan, rgbd: torch.Tensor) -> torch.Tensor:
        generator.eval()
        with torch.inference_mode():
            return generator(gen_plan, rgbd)

    return infer
