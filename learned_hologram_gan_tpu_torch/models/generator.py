"""The two-stage generator: RGBD -> amp/phase -> phase-only hologram
(counterpart of ``learned_hologram_gan_tpu/models/generator.py``).

* :class:`RGBD2AP` (reference RGBD2AP.py:15-50): a UNet maps the 4-channel
  RGBD stack to 6 channels; amplitude = 1.1 * the first three, phase =
  2*pi * the last three.
* :class:`AP2POH` (reference AP2POH.py:16-116): backward ASM propagation to
  the SLM plane, a shared radially-symmetric per-colour conv on the real
  and imaginary parts, then double-phase encoding.
* :class:`Generator` composes them (reference generator.py:15-59).
* :func:`generator_apply_fused` is its eval-only forward with stage 1
  through the BN-folded fused UNet (``nn/fused_unet.py``, kernel K5), and
  :func:`generator_apply_quant` with stage 1 in int8 (``nn/quant.py``).

The propagator state is an explicit :class:`~..ops.asm.PropagatorPlan`
argument, as in the JAX package.  Layout is NCHW throughout.
``GeneratorConfig.dtype`` is the convolutions' compute dtype, as in the JAX
package (``models/generator.py:147-158``): the UNet, its up-convs and head,
and the modulation conv run in it, and the head output and the
modulation's Re/Im come back to float32; the ASM, the amplitude
normalization and the double-phase encoding stay float32.  Float32
convolutions run in full float32 (TF32 off, ``full_f32_convs``), whatever
the caller's global setting.
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
    compute_dtype,
    full_f32_convs,
    init_weights,
)
from ..ops import asm
from ..ops import masks as masks_lib
from ..utils.normalize import amplitude_normalizor


class RGBD2AP(nn.Module):
    """Stage 1: RGBD (B, 4, H, W) -> (amp, phs), each (B, 3, H, W).
    ``fourier`` builds the UNet of FourierBlocks (the JAX package's
    ``RGBD2AP.fourier``)."""

    def __init__(self, amplitude_scaler: float = 1.1, base_features: int = 64,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 polyphase_level0: bool = False, fourier: bool = False):
        super().__init__()
        self.amplitude_scaler = amplitude_scaler
        self.unet = UNet(in_channels=4, output_channels=6, base_features=base_features,
                         dtype=dtype, remat=remat, polyphase_level0=polyphase_level0,
                         fourier=fourier)

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

    def __init__(self, kernel_size: int = 3, use_modulation: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cls = ChannelWiseSymmetricConv if use_modulation else FakeChannelWiseSymmetricConv
        self.modulation = cls(kernel_size, dtype)

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
    """``part2(part1(RGBD))`` -> POH phase map; fully convolutional.
    ``fourier`` gives stage 1 the fourier UNet (:class:`RGBD2AP`)."""

    def __init__(self, config: GeneratorConfig = GeneratorConfig(), fourier: bool = False):
        super().__init__()
        self.config = config
        dtype = compute_dtype(config.dtype)
        self.part1 = RGBD2AP(config.amplitude_scaler, config.unet_base_features, dtype, config.remat,
                             config.polyphase_level0, fourier)
        self.part2 = AP2POH(config.kernel_size, config.use_modulation, dtype)

    def forward(self, plan: asm.PropagatorPlan, rgbd: torch.Tensor) -> torch.Tensor:
        amp_hat, phs_hat = self.part1(rgbd)
        return self.part2(plan, amp_hat, phs_hat)


@torch.no_grad()
def generator_apply_fused(
    generator: Generator,
    plan: asm.PropagatorPlan,
    rgbd: torch.Tensor,
    *,
    polyphase_level0: bool = False,
) -> torch.Tensor:
    """Eval-only Generator forward with the fused-UNet fast path.

    The math of ``generator(plan, rgbd)`` in eval mode: stage 1 runs through
    :func:`~..nn.fused_unet.unet_apply_fused` (BatchNorm folded; every
    residual block through K5 on a CUDA tensor, through its plain version on
    a CPU tensor; ``polyphase_level0`` computes level 0 in the
    space-to-depth phase domain), then the 1.1x amplitude / 2*pi phase
    split and stage 2 as the module runs it.  The RGBD input enters the
    UNet in the generator's compute dtype, as the JAX function casts it.
    A UNet the fast path does not take (the fourier UNet) runs the module's
    own eval-mode forward, as the JAX function falls back to
    ``generator.apply``.
    """
    from ..nn.fused_unet import supported, unet_apply_fused

    unet = generator.part1.unet
    if not supported(unet):
        was_training = generator.training
        generator.eval()
        try:
            return generator(plan, rgbd)
        finally:
            generator.train(was_training)
    y = unet_apply_fused(
        unet, rgbd.permute(0, 2, 3, 1).to(unet.dtype), polyphase_level0=polyphase_level0,
    )
    y = y.permute(0, 3, 1, 2).float()
    amp = generator.part1.amplitude_scaler * y[:, :3]
    phs = (2.0 * np.pi) * y[:, 3:]
    return generator.part2(plan, amp, phs)


@torch.no_grad()
def generator_apply_quant(
    generator: Generator,
    qtree: dict,
    plan: asm.PropagatorPlan,
    rgbd: torch.Tensor,
) -> torch.Tensor:
    """Eval-only Generator forward with the int8 stage-1 UNet.

    ``qtree`` comes from ``nn/quant.py`` over ``generator.part1.unet``: a
    full-integer tree (it has ``"edges"``) runs :func:`~..nn.quant.
    unet_apply_q8`, a dynamic one :func:`~..nn.quant.unet_apply_quant` in
    the generator's compute dtype.  Then the 1.1x amplitude / 2*pi phase
    split and stage 2 in float, as the module runs it.  Raises
    ``ValueError`` for a UNet the quant walker does not know.
    """
    from ..nn.fused_unet import supported
    from ..nn.quant import unet_apply_q8, unet_apply_quant

    unet = generator.part1.unet
    if not supported(unet):
        raise ValueError(
            "generator_apply_quant supports only the standard UNet parameter layout "
            "(no fourier/nested blocks, every residual block with its 1x1 shortcut); "
            "use the generator's forward instead"
        )
    x = rgbd.permute(0, 2, 3, 1)
    if "edges" in qtree:
        y = unet_apply_q8(qtree, x)
    else:
        y = unet_apply_quant(qtree, unet, x, dtype=unet.dtype)
    y = y.permute(0, 3, 1, 2).float()
    amp = generator.part1.amplitude_scaler * y[:, :3]
    phs = (2.0 * np.pi) * y[:, 3:]
    return generator.part2(plan, amp, phs)


def make_generator(
    config: GeneratorConfig,
    seed: int = 0,
    device: str | torch.device = "cuda",
    fourier: bool = False,
) -> Generator:
    """A :class:`Generator` (with the fourier UNet if asked) initialized
    from ``seed`` on the CPU with the JAX package's scheme, then moved to
    ``device``, in eval mode."""
    model = Generator(config, fourier)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def make_generator_plan(
    config: GeneratorConfig, device: str | torch.device = "cuda", cache_h: bool = True
) -> asm.PropagatorPlan:
    """The fixed-distance plan a Generator propagates through (reference
    AP2POH.py:51-62: same optics, single distance, default 1 mm);
    ``cache_h=False`` keeps no transfer function (:func:`asm.make_plan`)."""
    return asm.make_plan(config.optics(), distances=[config.distance], device=device,
                         cache_h=cache_h)
