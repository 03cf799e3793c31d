"""Frequency- and spatial-domain masks (counterpart of
``learned_hologram_gan_tpu/ops/masks.py``; the factories the inference slice
uses).

Each grid is built in numpy float32 in the JAX package's operation order and
returned as a CPU ``torch.Tensor``; plans move it to their device.
"""

from __future__ import annotations

from typing import Optional

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
