"""Optics and generator configuration (counterpart of
``learned_hologram_gan_tpu/config.py``).

Carried: the padded-grid geometry (with ``pad_cols_override``), the
physics constants, the generator widths, compute dtype, ``remat`` and
``polyphase_level0``, and the critic, loss and training dataclasses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# reference trainingModel.py:18
DEFAULT_SEED = 122731

# Model-layer default (reference generator.py:24, watermelon.py:57,79)
DEFAULT_WAVELENGTHS: Tuple[float, float, float] = (638e-9, 520e-9, 450e-9)
DEFAULT_PIXEL_PITCH = 3.74e-6


@dataclasses.dataclass(frozen=True)
class OpticsConfig:
    """Geometry and physics of the hologram / SLM plane.

    ``pad_size`` is the row padding; the column padding follows the aspect
    ratio like the reference: ``pad_cols = int(pad_size * cols / rows)``,
    unless ``pad_cols_override`` sets it (at 4K the aspect-derived width is
    FFT-hostile; ``utils/fftlen.good_fft_pads`` picks a 5-smooth one).
    """

    rows: int = 192
    cols: int = 192
    pad_size: int = 0
    filter_radius_coefficient: float = 0.5
    pixel_pitch: float = DEFAULT_PIXEL_PITCH
    wavelengths: Tuple[float, ...] = DEFAULT_WAVELENGTHS
    pad_cols_override: Optional[int] = None

    @property
    def pad_rows(self) -> int:
        return self.pad_size

    @property
    def pad_cols(self) -> int:
        if self.pad_cols_override is not None:
            return self.pad_cols_override
        return int(self.pad_size * (self.cols / self.rows))

    @property
    def padded_rows(self) -> int:
        return self.rows + 2 * self.pad_rows

    @property
    def padded_cols(self) -> int:
        return self.cols + 2 * self.pad_cols


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """Two-stage generator (reference generator.py:15-59)."""

    rows: int = 192
    cols: int = 192
    pad_size: int = 160
    filter_radius_coefficient: float = 0.5
    kernel_size: int = 3
    pixel_pitch: float = DEFAULT_PIXEL_PITCH
    wavelengths: Tuple[float, ...] = DEFAULT_WAVELENGTHS
    distance: float = 1e-3
    amplitude_scaler: float = 1.1  # reference RGBD2AP.py:22
    unet_base_features: int = 64  # reference UNet encoder1 width
    use_modulation: bool = True  # False = ablation fakeChannelWiseSymmetricConv
    dtype: str = "float32"  # conv compute dtype, "float32" or "bfloat16"; parameters stay float32
    remat: bool = False  # recompute each UNet block's activations in the backward (1080p/4K)
    polyphase_level0: bool = False  # UNet level 0 in the space-to-depth phase domain (exact)
    pad_cols_override: Optional[int] = None  # see OpticsConfig

    def optics(self) -> OpticsConfig:
        return OpticsConfig(
            rows=self.rows,
            cols=self.cols,
            pad_size=self.pad_size,
            filter_radius_coefficient=self.filter_radius_coefficient,
            pixel_pitch=self.pixel_pitch,
            wavelengths=self.wavelengths,
            pad_cols_override=self.pad_cols_override,
        )


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """WGAN-GP patch critic (reference discriminator.py:5-51)."""

    feature_d: int = 32
    dtype: str = "float32"  # conv compute dtype, as GeneratorConfig.dtype


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Weighted generator-loss mix (reference watermelon.py:92-116,418-445).

    ``phase_loss`` selects the phase-term variant of the ablations:
    "focal_sincos_gradient" (the full model), "plain", "focal_sincos" or
    "sincos_gradient".  ``perceptual`` is "vgg19" (pretrained weights
    required), "random" (the explicit untrained-VGG opt-in) or "none".
    """

    phs_gradient_loss_weight: float = 1.0
    perceptual_loss_weight: float = 1.0
    pixel_loss_weight: float = 1.0
    tv_loss_weight: float = 1e-3
    discriminator_loss_weight: float = 1.0
    phase_loss: str = "focal_sincos_gradient"
    perceptual: str = "vgg19"
    perceptual_weights_path: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Full GAN training schedule (reference watermelon.py:92-116)."""

    use_gan: bool = True  # False = watermelon_without_GAN family
    epoch_num: int = 2
    lr_G: float = 1e-3
    lr_D: float = 1e-3
    discriminator_train_ratio: int = 2
    discriminator_lambda: float = 10.0
    checkpoint_interval: int = 5
    info_print_interval: int = 100
    info_plot_interval: int = 600
    seed: int = DEFAULT_SEED
    batch_size: int = 4
