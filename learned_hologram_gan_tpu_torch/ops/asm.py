"""Band-limited angular-spectrum (ASM) propagation on ``torch.fft``.

Counterpart of ``learned_hologram_gan_tpu/ops/asm.py`` for the inference
slice.  The propagation is
``crop(ifft2(fft2(pad(A * exp(i*phi))) * H * mask))`` with
``H = exp(-2*pi*i * z * w)`` and ``w = sqrt(max(1/lambda^2 - fx^2 - fy^2, 0))``
(reference angular_spectrum_method.py:68-94, :155-171, :195-213).  Because
``w`` is real, |H| == 1 and backward propagation multiplies by ``conj(H)``.

Two branches, as in the JAX package:
  * fused: :func:`_fused_apply` hands the unpadded field to
    ``ops/cuda/spectral.propagate_planes`` (kernel K1 on a CUDA tensor, its
    plain version on a CPU tensor), which never writes a padded plane;
  * composable: pad -> ``torch.fft.fft2`` -> multiply -> ``ifft2`` -> crop,
    for grids K1 does not support.
Complex tensors are complex64; the public layout is NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import OpticsConfig
from . import masks as masks_lib


@dataclasses.dataclass(frozen=True)
class PropagatorPlan:
    """Precomputed grids for ASM propagation, on one device.

      w_grid:    (C, Rp, Cp) float32 per-wavelength w values.
      mask:      (Rp, Cp) float32 circular low-pass (the imaging aperture,
                 reference :60-62, :141-153).
      H:         (D, C, Rp, Cp) complex64 cached transfer functions, or None
                 without a distance stack.
      distances: (D,) float32 fixed distance stack, or None.
    """

    w_grid: torch.Tensor
    mask: torch.Tensor
    H: Optional[torch.Tensor]
    distances: Optional[torch.Tensor]

    rows: int
    cols: int
    pad_rows: int
    pad_cols: int
    pixel_pitch: float
    wavelengths: Tuple[float, ...]
    filter_radius_coefficient: float

    @property
    def padded_rows(self) -> int:
        return self.rows + 2 * self.pad_rows

    @property
    def padded_cols(self) -> int:
        return self.cols + 2 * self.pad_cols


def make_plan(
    optics: OpticsConfig,
    distances: Optional[Sequence[float]] = None,
    device: str | torch.device = "cuda",
) -> PropagatorPlan:
    """Build a :class:`PropagatorPlan` on ``device``.

    ``distances`` fixes the distance stack (one element for the fixed-distance
    propagator); its complex H stack is cached for the composable branch
    (the fused branch computes H itself).
    """
    rp, cp = optics.padded_rows, optics.padded_cols
    w_grid = torch.from_numpy(
        _w_grid(rp, cp, optics.pixel_pitch, _inv_wl_sq(optics.wavelengths))
    ).to(device)
    radius = min(rp, cp) * optics.filter_radius_coefficient
    mask = masks_lib.circular_frequency_mask(rp, cp, radius).to(device)

    h = None
    dist = None
    if distances is not None:
        dist = torch.from_numpy(
            np.atleast_1d(np.asarray(distances, dtype=np.float32))
        ).to(device)
        h = _transfer_function(w_grid, dist)

    return PropagatorPlan(
        w_grid=w_grid,
        mask=mask,
        H=h,
        distances=dist,
        rows=optics.rows,
        cols=optics.cols,
        pad_rows=optics.pad_rows,
        pad_cols=optics.pad_cols,
        pixel_pitch=optics.pixel_pitch,
        wavelengths=tuple(optics.wavelengths),
        filter_radius_coefficient=optics.filter_radius_coefficient,
    )


def _fftfreq_f32(n: int, d: float) -> np.ndarray:
    """fftfreq with float32 rounding: the integer sequence (exact in f32)
    times the f32-rounded scale ``1/(n*d)``, the order the JAX package and
    the torch reference use (numpy's f64-then-cast differs by 1 ulp, which
    reaches ~1e-3 in the transfer function's phase)."""
    k = (np.fft.fftfreq(n) * n).astype(np.float32)
    return k * np.float32(1.0 / (n * d))


def _inv_wl_sq(wavelengths: Sequence[float]) -> np.ndarray:
    """(C,) float32 ``1/lambda^2``, rounded as the JAX package rounds it."""
    return (1.0 / np.asarray(wavelengths, dtype=np.float32) ** 2).astype(np.float32)


def _w_grid(
    rows: int, cols: int, pixel_pitch: float, inv_wl_sq: np.ndarray
) -> np.ndarray:
    """(C, rows, cols) float32 grid of ``w = sqrt(max(1/lambda^2 - fx^2 -
    fy^2, 0))``, fx down the rows and fy across the columns, for the (C,)
    float32 ``inv_wl_sq`` = ``1/lambda^2``.

    Computed in numpy float32 in the JAX package's operation order; numpy's
    float32 sqrt is correctly rounded, which torch's CPU sqrt is not on
    every input.
    """
    fx = _fftfreq_f32(rows, pixel_pitch)[:, None]
    fy = _fftfreq_f32(cols, pixel_pitch)[None, :]
    sq = (fx * fx + fy * fy)[None, :, :]
    inv_wl_sq = np.asarray(inv_wl_sq, dtype=np.float32)[:, None, None]
    return np.sqrt(np.clip((inv_wl_sq - sq).astype(np.float32), 0.0, None))


def _transfer_function(w_grid: torch.Tensor, distances: torch.Tensor) -> torch.Tensor:
    """H = exp(-2*pi*i * z * w): (D, C, Rp, Cp) complex64, with the phase
    rounded as ``((-2*pi) * z) * w`` in float32."""
    sign = torch.tensor(np.float32(-2.0 * np.pi), device=w_grid.device)
    theta = (sign * distances)[:, None, None, None] * w_grid[None]
    return torch.complex(torch.cos(theta), torch.sin(theta))


def _h_stack(plan: PropagatorPlan) -> torch.Tensor:
    if plan.H is None:
        raise ValueError(
            "This primitive needs a plan built with a fixed distance stack; "
            "pass distances=[...] to make_plan()."
        )
    return plan.H


def _fixed_h(plan: PropagatorPlan) -> torch.Tensor:
    """The (C, Rp, Cp) transfer function of the plan's first distance."""
    return _h_stack(plan)[0]


def pad(plan: PropagatorPlan, x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last two axes to the padded sampling grid."""
    if plan.pad_rows == 0 and plan.pad_cols == 0:
        return x
    return F.pad(x, (plan.pad_cols, plan.pad_cols, plan.pad_rows, plan.pad_rows))


def crop(plan: PropagatorPlan, x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pad`: the central (rows, cols) window."""
    if plan.pad_rows == 0 and plan.pad_cols == 0:
        return x
    return x[
        ...,
        plan.pad_rows : plan.pad_rows + plan.rows,
        plan.pad_cols : plan.pad_cols + plan.cols,
    ]


def field(amp: torch.Tensor, phs: torch.Tensor) -> torch.Tensor:
    """Complex field A * exp(i*phi) as complex64 (also the port's
    counterpart of the JAX package's ``utils.misc.complex_plain``)."""
    amp = amp.float()
    phs = phs.float()
    return torch.complex(amp * torch.cos(phs), amp * torch.sin(phs))


def _angle(x: torch.Tensor) -> torch.Tensor:
    return torch.atan2(x.imag, x.real)


# ---------------------------------------------------------------------------
# Fused branch: ops/cuda/spectral.propagate_planes (kernel K1)
# ---------------------------------------------------------------------------


def _fused_ok(plan: PropagatorPlan) -> bool:
    from .cuda import spectral

    return spectral.supported(plan.padded_rows, plan.padded_cols)


def fused_args(
    plan: PropagatorPlan,
    g: torch.Tensor,
    distances: torch.Tensor,
    *,
    conj_h: bool = False,
    use_mask: bool = True,
):
    """The ``propagate_planes`` arguments ``(fr, fi, wl2, dists, mask, cfg)``
    for unpadded (B, C, rows, cols) complex planes ``g``."""
    b, cch = g.shape[0], g.shape[1]
    rows, cols = plan.rows, plan.cols
    fr = g.real.float().reshape(b * cch, rows, cols).contiguous()
    fi = g.imag.float().reshape(b * cch, rows, cols).contiguous()
    wl2 = torch.from_numpy(np.tile(_inv_wl_sq(plan.wavelengths), b)[:, None]).to(g.device)
    dvec = distances.float().reshape(-1, 1).contiguous()
    mask = plan.mask if use_mask else None
    cfg = (
        float(plan.pixel_pitch), bool(conj_h), False, False, int(dvec.shape[0]),
        plan.padded_rows, plan.padded_cols,
        (plan.pad_rows, rows, plan.pad_cols, cols),
    )
    return fr, fi, wl2, dvec, mask, cfg


def _fused_apply(
    plan: PropagatorPlan,
    g: torch.Tensor,
    distances: torch.Tensor,
    *,
    conj_h: bool = False,
    use_mask: bool = True,
) -> torch.Tensor:
    """Propagate unpadded (B, C, rows, cols) complex planes to every distance.

    Returns (B, D, C, rows, cols) complex64, already cropped to the plan's
    central window.
    """
    from .cuda import spectral

    args = fused_args(plan, g, distances, conj_h=conj_h, use_mask=use_mask)
    outr, outi = spectral.propagate_planes(*args)
    b, cch, num_d = g.shape[0], g.shape[1], args[-1][4]
    out = torch.complex(outr, outi).reshape(b, cch, num_d, plan.rows, plan.cols)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# Primitives of the inference slice
# ---------------------------------------------------------------------------


def propagate_ap2c_backward(
    plan: PropagatorPlan, amp_z: torch.Tensor, phs_z: torch.Tensor
) -> torch.Tensor:
    """Image-plane amp/phase -> complex SLM-plane field: G_z * conj(H), no
    aperture mask (reference propagate_AP2C_backward, :374-384)."""
    g = field(amp_z, phs_z)
    if _fused_ok(plan) and plan.distances is not None:
        out = _fused_apply(
            plan, g, plan.distances[:1], conj_h=True, use_mask=False
        )
        return out[:, 0]
    gz = torch.fft.fft2(pad(plan, g))
    return crop(plan, torch.fft.ifft2(gz * torch.conj(_fixed_h(plan))))


def propagate_poh2ap_forward(
    plan: PropagatorPlan, poh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """POH -> (amp, phase) at the plan's fixed distance (reference :414-424)."""
    g = field(torch.ones_like(poh), poh)
    if _fused_ok(plan) and plan.distances is not None:
        gz = _fused_apply(plan, g, plan.distances[:1])[:, 0]
        return gz.abs(), _angle(gz)
    g0 = torch.fft.fft2(pad(plan, g))
    gz = crop(plan, torch.fft.ifft2(g0 * (_fixed_h(plan) * plan.mask)))
    return gz.abs(), _angle(gz)


def propagate_batch_multi(
    plan: PropagatorPlan,
    amp: torch.Tensor,
    phs: torch.Tensor,
    distances: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batch x multi-distance propagation -> (B*D, C, rows, cols) amplitudes,
    row ``b*D + d`` being sample b at distance d (reference :503-522)."""
    use_plan_stack = distances is None
    if use_plan_stack:
        if plan.distances is None:
            raise ValueError("plan has no distance stack and none was passed")
        distances = plan.distances
    distances = torch.atleast_1d(distances.float())
    g = field(amp, phs)
    if _fused_ok(plan):
        out = _fused_apply(plan, g, distances).abs()
        return out.reshape(out.shape[0] * out.shape[1], *out.shape[2:])
    g0 = torch.fft.fft2(pad(plan, g))  # (B, C, Rp, Cp)
    h = _h_stack(plan) if use_plan_stack else _transfer_function(plan.w_grid, distances)
    gz = g0[:, None] * (h * plan.mask)[None]  # (B, D, C, Rp, Cp)
    gz = gz.reshape(gz.shape[0] * gz.shape[1], *gz.shape[2:])
    return crop(plan, torch.fft.ifft2(gz)).abs()
