"""Frequency- and spatial-domain masks (counterpart of
``learned_hologram_gan_tpu/ops/masks.py``).

Each grid is built in numpy float32 in the JAX package's operation order and
returned as a CPU ``torch.Tensor``; plans move it to their device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def radial_frequency_grid(rows: int, cols: int) -> torch.Tensor:
    """``sqrt(u^2 + v^2) * min(rows, cols)`` on the fftfreq grid, with
    ``u = fftfreq(rows)`` down the rows and ``v = fftfreq(cols)`` across
    the columns (reference utilities.py:276-296)."""
    shorter = min(rows, cols)
    u = np.fft.fftfreq(rows).astype(np.float32)[:, None]
    v = np.fft.fftfreq(cols).astype(np.float32)[None, :]
    return torch.from_numpy(
        (np.sqrt(u * u + v * v) * shorter).astype(np.float32)
    )


def circular_frequency_mask(
    rows: int,
    cols: int,
    radius: float,
    decay_rate: Optional[float] = None,
    validate: bool = True,
) -> torch.Tensor:
    """Hard (or exponentially decaying) circular low-pass: 1 where
    ``D <= radius``, else 0 or ``exp(-decay * (D - radius))``
    (reference utilities.py:206-243)."""
    shorter = min(rows, cols)
    if validate and radius > shorter / 2:
        raise ValueError(
            f"The radius {radius} is larger than the half of the sample size "
            f"{shorter / 2}"
        )
    d = radial_frequency_grid(rows, cols)
    if decay_rate is not None:
        outside = torch.exp(-decay_rate * (d - radius))
    else:
        outside = torch.zeros_like(d)
    return torch.where(d > radius, outside, torch.ones_like(d))


def differentiable_circular_mask(
    radial_grid: torch.Tensor, radius: torch.Tensor | float
) -> torch.Tensor:
    """Sigmoid-edged circular low-pass ``sigmoid(radius - D)``,
    differentiable in ``radius`` (reference angular_spectrum_method.py:426-436)."""
    return torch.sigmoid(1.0 * (radius - radial_grid))


def square_frequency_mask(rows: int, cols: int, x: int = 0, y: int = 0) -> torch.Tensor:
    """Centred square pass band of half-extent (x, y), ifftshifted
    (reference utilities.py:299-324)."""
    if 2 * x > rows or 2 * y > cols:
        raise ValueError("The mask size is too large.")
    mask = np.zeros((rows, cols), dtype=np.float32)
    mask[rows // 2 - x : rows // 2 + 1 + x, cols // 2 - y : cols // 2 + 1 + y] = 1.0
    return torch.from_numpy(np.ascontiguousarray(np.fft.ifftshift(mask)))


def band_limit_mask(
    rows: int,
    cols: int,
    pixel_pitch: float,
    wavelengths: Sequence[float],
    distances,
) -> torch.Tensor:
    """Matsushima-style band limit per (distance, wavelength), a float32
    (D, C, rows, cols) mask (reference angular_spectrum_method.py:173-193):
    ``u_limit = 1 / (sqrt((2 du z)^2 + 1) lambda)`` with ``du = 1/(rows
    pitch)``, ``dv = 1/(cols pitch)``, and the AND of ``|fx| < u_limit`` and
    ``|fy| < v_limit``.  Computed in float32 in the JAX package's order."""
    f32 = np.float32
    wl = np.asarray(wavelengths, dtype=f32)  # (C,)
    z = np.atleast_1d(np.asarray(distances, dtype=f32))  # (D,)
    freq_x = np.fft.fftfreq(rows, pixel_pitch).astype(f32)
    freq_y = np.fft.fftfreq(cols, pixel_pitch).astype(f32)
    d_u = f32(1.0 / (rows * pixel_pitch))
    d_v = f32(1.0 / (cols * pixel_pitch))
    u_limit = f32(1.0) / (np.sqrt((f32(2.0) * d_u * z[:, None]) ** 2 + f32(1.0)) * wl[None, :])
    v_limit = f32(1.0) / (np.sqrt((f32(2.0) * d_v * z[:, None]) ** 2 + f32(1.0)) * wl[None, :])
    mask_u = np.abs(freq_x)[None, None, :, None] < u_limit[:, :, None, None]
    mask_v = np.abs(freq_y)[None, None, None, :] < v_limit[:, :, None, None]
    return torch.from_numpy((mask_u & mask_v).astype(f32))


def checkerboard_mask(
    height: int, width: int, cell_size: int = 4, invert: bool = False
) -> torch.Tensor:
    """``(x // cell + y // cell) % 2`` checkerboard, optionally inverted
    (reference utilities.py:354-382)."""
    x = np.arange(width).reshape(1, -1) // cell_size
    y = np.arange(height).reshape(-1, 1) // cell_size
    board = ((x + y) % 2).astype(np.float32)
    if invert:
        board = 1.0 - board
    return torch.from_numpy(board)
