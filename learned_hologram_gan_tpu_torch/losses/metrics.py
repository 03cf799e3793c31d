"""PSNR and SSIM (counterpart of ``learned_hologram_gan_tpu/losses/metrics.py``).

torchmetrics' conventions with ``data_range=None``: the dynamic range is
``max - min`` over the union of both inputs; SSIM uses an 11x11 gaussian
window (sigma 1.5, applied as two separable 11-tap passes, no padding),
k1 = 0.01, k2 = 0.03, averaged over batch, channels and pixels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _data_range(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.maximum(preds.max(), target.max()) - torch.minimum(preds.min(), target.min())


def psnr(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the whole batch."""
    preds, target = preds.float(), target.float()
    rng = _data_range(preds, target)
    return 10.0 * torch.log10(rng**2 / ((preds - target) ** 2).mean())


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2 * sigma**2))
    g /= g.sum()
    return g.astype(np.float32)


def ssim(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    plane_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Structural similarity of NCHW inputs, the mean over batch, channels
    and pixels.

    The moments are taken about a global shift (the mean of both inputs),
    which leaves every variance and covariance unchanged and keeps
    ``E[x^2] - mu^2`` well conditioned.  ``plane_chunk`` bounds the memory
    of the moment stack: the range and shift are global, the blur runs
    ``plane_chunk`` (b, c) planes at a time, and the per-chunk means are
    combined with plane-count weights, which is the unchunked mean.
    """
    rng = _data_range(preds, target).float()
    # the 1e-30 floor only matters when rng == 0 (SSIM exactly 1, not 0/0)
    c1 = (k1 * rng) ** 2 + 1e-30
    c2 = (k2 * rng) ** 2 + 1e-30
    b, c = preds.shape[0], preds.shape[1]
    x_all = preds.reshape(b * c, *preds.shape[2:])
    y_all = target.reshape(b * c, *target.shape[2:])
    shift = 0.5 * (x_all.float().mean() + y_all.float().mean())
    n = b * c
    if plane_chunk is None or plane_chunk >= n:
        return _ssim_planes(x_all, y_all, shift, c1, c2, kernel_size, sigma)
    total = torch.zeros((), dtype=torch.float32, device=preds.device)
    for start in range(0, n, plane_chunk):
        xc = x_all[start : start + plane_chunk]
        yc = y_all[start : start + plane_chunk]
        total = total + xc.shape[0] * _ssim_planes(xc, yc, shift, c1, c2, kernel_size, sigma)
    return total / n


def _ssim_planes(x, y, shift, c1, c2, kernel_size, sigma) -> torch.Tensor:
    """Mean SSIM over a stack of (H, W) plane pairs, given global stats."""
    x = x.float() - shift
    y = y.float() - shift
    planes = torch.cat([x, y, x * x, y * y, x * y], dim=0)[None]  # (1, 5n, H, W)
    nch = planes.shape[1]
    g = torch.from_numpy(_gaussian_1d(kernel_size, sigma)).to(planes.device)
    krow = g.reshape(1, 1, kernel_size, 1).expand(nch, 1, kernel_size, 1)
    kcol = g.reshape(1, 1, 1, kernel_size).expand(nch, 1, 1, kernel_size)
    blurred = F.conv2d(F.conv2d(planes, krow, groups=nch), kcol, groups=nch)[0]
    blurred = blurred.reshape(5, x.shape[0], *blurred.shape[-2:])
    mu_xs, mu_ys = blurred[0], blurred[1]  # shifted means
    sig_x = blurred[2] - mu_xs * mu_xs
    sig_y = blurred[3] - mu_ys * mu_ys
    sig_xy = blurred[4] - mu_xs * mu_ys
    mu_x, mu_y = mu_xs + shift, mu_ys + shift  # luminance uses the true means
    num = (2 * mu_x * mu_y + c1) * (2 * sig_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sig_x + sig_y + c2)
    return (num / den).mean()
