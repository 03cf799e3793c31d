"""Field normalizers (reference utilities.py:53-84)."""

from __future__ import annotations

import torch


def amplitude_normalizor(amp: torch.Tensor) -> torch.Tensor:
    """Scale each channel to strictly < 1 by its spatial max * 1.01, which
    keeps ``acos(amp)`` defined in the double-phase encoder."""
    m = torch.amax(amp, dim=(-2, -1), keepdim=True)
    return amp / (m * 1.01)


def tensor_normalizor_2d(x: torch.Tensor) -> torch.Tensor:
    """Per-channel min-max normalization over the last two axes."""
    mx = torch.amax(x, dim=(-2, -1), keepdim=True)
    mn = torch.amin(x, dim=(-2, -1), keepdim=True)
    return (x - mn) / (mx - mn)
