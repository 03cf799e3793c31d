"""Optics and generator configuration (counterpart of
``learned_hologram_gan_tpu/config.py``).

Only the fields the inference slice reads are carried: the padded-grid
geometry, the physics constants and the generator widths.  The JAX
package's training dataclasses, its TPU-only switches (``remat``,
``polyphase_level0``) and ``pad_cols_override`` have no counterpart here
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Model-layer default (reference generator.py:24, watermelon.py:57,79)
DEFAULT_WAVELENGTHS: Tuple[float, float, float] = (638e-9, 520e-9, 450e-9)
DEFAULT_PIXEL_PITCH = 3.74e-6


@dataclasses.dataclass(frozen=True)
class OpticsConfig:
    """Geometry and physics of the hologram / SLM plane.

    ``pad_size`` is the row padding; the column padding follows the aspect
    ratio like the reference: ``pad_cols = int(pad_size * cols / rows)``.
    """

    rows: int = 192
    cols: int = 192
    pad_size: int = 0
    filter_radius_coefficient: float = 0.5
    pixel_pitch: float = DEFAULT_PIXEL_PITCH
    wavelengths: Tuple[float, ...] = DEFAULT_WAVELENGTHS

    @property
    def pad_rows(self) -> int:
        return self.pad_size

    @property
    def pad_cols(self) -> int:
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

    def optics(self) -> OpticsConfig:
        return OpticsConfig(
            rows=self.rows,
            cols=self.cols,
            pad_size=self.pad_size,
            filter_radius_coefficient=self.filter_radius_coefficient,
            pixel_pitch=self.pixel_pitch,
            wavelengths=self.wavelengths,
        )
