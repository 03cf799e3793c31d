"""Loss functions (counterpart of ``learned_hologram_gan_tpu/losses/losses.py``;
reference loss_func.py:66-208).

Every function takes and returns float32 tensors in NCHW layout.  The
"focal" variants weight the error map by its own detached, max-normalized
magnitude: gradients flow through the raw difference only (``.detach()``
where the JAX package has ``stop_gradient``).

Inside ``parallel.collectives.data_parallel`` (each rank holding its rows
of the batch) the terms that reduce across samples reduce over the global
batch, as the JAX package's do over a batch-sharded axis: the focal
weights' normalizing maximum, and the TV difference's batch means.  A
batch mean of a per-sample quantity needs nothing: the train step
averages the ranks' values.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import data_max, data_mean


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """Mean |dx| + mean |dy| (reference loss_func.py:66-77)."""
    d1 = x[:, :, :, 1:] - x[:, :, :, :-1]
    d2 = x[:, :, 1:, :] - x[:, :, :-1, :]
    return d1.abs().mean() + d2.abs().mean()


def total_variation_for_poh(x: torch.Tensor) -> torch.Tensor:
    """Stride-2 TV, for checkerboard-encoded POHs (reference :80-91)."""
    d1 = x[:, :, :, 2:] - x[:, :, :, :-2]
    d2 = x[:, :, 2:, :] - x[:, :, :-2, :]
    return d1.abs().mean() + d2.abs().mean()


def total_variation_loss(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """| TV(y_hat) - TV(y) | (reference :94-98), each TV over the global
    batch."""
    return (data_mean(total_variation(y_hat)) - data_mean(total_variation(y))).abs()


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def amp_loss(amp_hat: torch.Tensor, amp: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """MSE + alpha * TV-difference (reference :101-104)."""
    return mse(amp_hat, amp) + alpha * total_variation_loss(amp_hat, amp)


def amp_phs_loss(amp_hat, phs_hat, amp, phs, alpha: float = 1.0) -> torch.Tensor:
    """MSE + alpha * TV on the (amp, sin phs, cos phs) channel stack
    (reference :107-120); phases in radians, taken as given."""
    hat = torch.cat([amp_hat, torch.sin(phs_hat), torch.cos(phs_hat)], dim=1)
    tgt = torch.cat([amp, torch.sin(phs), torch.cos(phs)], dim=1)
    return mse(hat, tgt) + alpha * total_variation_loss(hat, tgt)


def focal_freq_loss(fake_freq: torch.Tensor, real_freq: torch.Tensor) -> torch.Tensor:
    """Self-weighted frequency L2 (reference :123-132; defined but unused)."""
    diff = (fake_freq - real_freq).abs()
    w = (diff / data_max(diff.max())).detach()
    return ((diff * w) ** 2).mean()


def _sincos(phase: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.sin(phase), torch.cos(phase)], dim=1)


def _gradient_diffs(fake_phase, real_phase):
    f, r = _sincos(fake_phase), _sincos(real_phase)
    d1 = ((f[:, :, :, 1:] - f[:, :, :, :-1]) - (r[:, :, :, 1:] - r[:, :, :, :-1])).abs()
    d2 = ((f[:, :, 1:, :] - f[:, :, :-1, :]) - (r[:, :, 1:, :] - r[:, :, :-1, :])).abs()
    return d1, d2


def focal_sincos_phase_gradient_loss(fake_phase, real_phase) -> torch.Tensor:
    """Self-weighted L1 on spatial gradients of (sin, cos) phase
    (reference :135-163)."""
    d1, d2 = _gradient_diffs(fake_phase, real_phase)
    w1 = (d1 / data_max(d1.max())).detach()
    w2 = (d2 / data_max(d2.max())).detach()
    return (d1 * w1).mean() + (d2 * w2).mean()


def phase_sincos_gradient_loss(fake_phase, real_phase) -> torch.Tensor:
    """Unweighted variant (reference :166-184)."""
    d1, d2 = _gradient_diffs(fake_phase, real_phase)
    return d1.mean() + d2.mean()


def focal_sincos_phase_loss(fake_phase, real_phase) -> torch.Tensor:
    """Self-weighted L1 directly on (sin, cos) phase (reference :187-203)."""
    d = (_sincos(fake_phase) - _sincos(real_phase)).abs()
    w = (d / data_max(d.max())).detach()
    return (d * w).mean()


def plain_phase_loss(fake_phase, real_phase) -> torch.Tensor:
    """Mean |difference| (reference :206-208)."""
    return (fake_phase - real_phase).abs().mean()


PHASE_LOSSES = {
    "focal_sincos_gradient": focal_sincos_phase_gradient_loss,
    "sincos_gradient": phase_sincos_gradient_loss,
    "focal_sincos": focal_sincos_phase_loss,
    "plain": plain_phase_loss,
}
