"""The two-stage generator: RGBD -> amp/phase -> phase-only hologram
(counterpart of ``learned_hologram_gan_tpu/models/generator.py``).

* :class:`RGBD2AP` (reference RGBD2AP.py:15-50): a UNet maps the 4-channel
  RGBD stack to 6 channels; amplitude = 1.1 * the first three, phase =
  2*pi * the last three.
* :class:`AP2POH` (reference AP2POH.py:16-116): backward ASM propagation to
  the SLM plane, a shared radially-symmetric per-colour conv on the real
  and imaginary parts, then double-phase encoding.
* :class:`Generator` composes them (reference generator.py:15-59).

The propagator state is an explicit :class:`~..ops.asm.PropagatorPlan`
argument, as in the JAX package.  Layout is NCHW throughout.  Both stages
run their convolutions in full float32 (TF32 off, ``full_f32_convs``),
whatever the caller's global setting.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..config import GeneratorConfig
from ..nn.blocks import (
    ChannelWiseSymmetricConv,
    FakeChannelWiseSymmetricConv,
    UNet,
    full_f32_convs,
    init_weights,
)
from ..ops import asm
from ..ops import masks as masks_lib
from ..utils.normalize import amplitude_normalizor


class RGBD2AP(nn.Module):
    """Stage 1: RGBD (B, 4, H, W) -> (amp, phs), each (B, 3, H, W)."""

    def __init__(self, amplitude_scaler: float = 1.1, base_features: int = 64):
        super().__init__()
        self.amplitude_scaler = amplitude_scaler
        self.unet = UNet(in_channels=4, output_channels=6, base_features=base_features)

    @full_f32_convs()
    def forward(self, rgbd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        y = self.unet(rgbd).float()
        amp = self.amplitude_scaler * y[:, :3]
        phs = (2.0 * np.pi) * y[:, 3:]
        return amp, phs


def double_phase_encode(amp: torch.Tensor, phs: torch.Tensor) -> torch.Tensor:
    """``phs +/- acos(amp)`` interleaved by complementary cell-size-1
    checkerboards (reference AP2POH.py:86-96, masks at :37-49).  ``amp``
    must lie strictly below 1.  (B, C, H, W) -> (B, C, H, W)."""
    h, w = amp.shape[-2], amp.shape[-1]
    board = masks_lib.checkerboard_mask(h, w, cell_size=1, invert=False).to(amp.device)
    acos_amp = torch.arccos(amp)
    return (1.0 - board) * (phs + acos_amp) + board * (phs - acos_amp)


class AP2POH(nn.Module):
    """Stage 2: image-plane (amp, phs) -> SLM-plane phase-only hologram."""

    def __init__(self, kernel_size: int = 3, use_modulation: bool = True):
        super().__init__()
        cls = ChannelWiseSymmetricConv if use_modulation else FakeChannelWiseSymmetricConv
        self.modulation = cls(kernel_size)

    @full_f32_convs()
    def forward(
        self, plan: asm.PropagatorPlan, amp_z: torch.Tensor, phs_z: torch.Tensor
    ) -> torch.Tensor:
        g0 = asm.propagate_ap2c_backward(plan, amp_z, phs_z)  # (B, 3, H, W)
        b = g0.shape[0]
        # the same conv weights on the real and imaginary parts, in one call
        both = self.modulation(torch.cat([g0.real, g0.imag], dim=0)).float()
        re, im = both[:b], both[b:]
        amp = torch.sqrt(re * re + im * im)
        phs = torch.atan2(im, re)
        return double_phase_encode(amplitude_normalizor(amp), phs)


class Generator(nn.Module):
    """``part2(part1(RGBD))`` -> POH phase map; fully convolutional."""

    def __init__(self, config: GeneratorConfig = GeneratorConfig()):
        super().__init__()
        self.config = config
        self.part1 = RGBD2AP(config.amplitude_scaler, config.unet_base_features)
        self.part2 = AP2POH(config.kernel_size, config.use_modulation)

    def forward(self, plan: asm.PropagatorPlan, rgbd: torch.Tensor) -> torch.Tensor:
        amp_hat, phs_hat = self.part1(rgbd)
        return self.part2(plan, amp_hat, phs_hat)


def make_generator(
    config: GeneratorConfig,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> Generator:
    """A :class:`Generator` initialized from ``seed`` on the CPU with the JAX
    package's scheme, then moved to ``device``, in eval mode."""
    model = Generator(config)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def make_generator_plan(
    config: GeneratorConfig, device: str | torch.device = "cuda"
) -> asm.PropagatorPlan:
    """The fixed-distance plan a Generator propagates through (reference
    AP2POH.py:51-62: same optics, single distance, default 1 mm)."""
    return asm.make_plan(config.optics(), distances=[config.distance], device=device)
