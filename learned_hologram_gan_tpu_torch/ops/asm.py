"""Band-limited angular-spectrum (ASM) propagation on ``torch.fft``.

Counterpart of ``learned_hologram_gan_tpu/ops/asm.py``: the fixed-distance,
focal-stack and base primitives, and ``freq2amp_at``, the serving focal
stack at any distances.  The propagation is
``crop(ifft2(fft2(pad(A * exp(i*phi))) * H * mask))`` with
``H = exp(-2*pi*i * z * w)`` and ``w = sqrt(max(1/lambda^2 - fx^2 - fy^2, 0))``
(reference angular_spectrum_method.py:68-94, :155-171, :195-213).  Because
``w`` is real, |H| == 1 and backward propagation multiplies by ``conj(H)``.

Two branches, as in the JAX package:
  * fused: :func:`_fused_apply` hands the unpadded field to
    ``ops/cuda/spectral.propagate_planes`` (kernel K1 on a CUDA tensor, its
    plain version on a CPU tensor), which never writes a padded plane;
  * composable: pad -> :func:`_fft2` -> multiply -> :func:`_ifft2` -> crop,
    for grids K1 does not support, and the spectrum primitives.  ``_fft2``
    and ``_ifft2`` are ``ops/cuda/fft`` (kernel K3 on a CUDA tensor,
    ``torch.fft`` on a CPU tensor or a grid K3 rejects).
A plan built with ``cache_h=False`` keeps no transfer-function stack: each
primitive computes the H it needs from the float32 w-grid, bit for bit the
cached values (the memory lever at 1080p and 4K).  ``sequential=True`` in
:func:`propagate_batch_multi` and :func:`freq2ap_all_distances` loops over
the distances with one padded plane set in flight, on the composable branch
(K3 per distance on a CUDA tensor), as the JAX package's ``lax.map`` does.
Complex tensors are complex64; the public layout is NCHW.

Two multi-device forms (``parallel/``), as in the JAX package.  A plan
bound to a mesh (:meth:`PropagatorPlan.with_spatial`) keeps the padded
planes row-sharded: :func:`pad` hands each rank its rows of the padded
grid, :func:`_fft2`/:func:`_ifft2` are the pencil FFT on those rows
(``parallel/fft.py``), the transfer functions and masks are cut to the
same rows, and :func:`crop` joins the rows on every rank once the columns
are cropped.  So under a binding a padded spectrum a primitive returns
(:func:`propagate_poh2freq_forward`, :func:`filter_ap2filtered_freq`) is
this rank's rows, and the primitives that take one expect that.  The
fused branch never runs there: no K1, K2 or K3.  A distance-sharded plan (``parallel.shard_distance_stack``) has
each rank compute the planes of its own distances in
:func:`propagate_batch_multi`, :func:`freq2ap_all_distances` and
:func:`freq2ap_random_distances`, the results joined on every rank.
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
      radial_grid: (Rp, Cp) float32 fftfreq radius grid of the sigmoid
                 (differentiable) low-pass (reference :315-319, :426-436).
      H:         (D, C, Rp, Cp) complex64 cached transfer functions, or None
                 without a distance stack or with ``cache_h=False``; with
                 ``distance_shard``, this rank's D / p of them.
      distances: (D,) float32 fixed distance stack, or None.
      spatial:   (mesh, axis name) binding the row-sharded pencil FFT
                 (:meth:`with_spatial`), or None.
      distance_shard: (mesh, axis name) splitting the distance stack over
                 the ranks (``parallel.shard_distance_stack``), or None.
    """

    w_grid: torch.Tensor
    mask: torch.Tensor
    radial_grid: torch.Tensor
    H: Optional[torch.Tensor]
    distances: Optional[torch.Tensor]

    rows: int
    cols: int
    pad_rows: int
    pad_cols: int
    pixel_pitch: float
    wavelengths: Tuple[float, ...]
    filter_radius_coefficient: float
    spatial: Optional[tuple] = None
    distance_shard: Optional[tuple] = None

    @property
    def padded_rows(self) -> int:
        return self.rows + 2 * self.pad_rows

    @property
    def padded_cols(self) -> int:
        return self.cols + 2 * self.pad_cols

    @property
    def num_distances(self) -> int:
        return 0 if self.distances is None else int(self.distances.shape[0])

    def replace(self, **kw) -> "PropagatorPlan":
        return dataclasses.replace(self, **kw)

    def with_spatial(self, mesh, axis_name: Optional[str] = None) -> "PropagatorPlan":
        """Bind the row-sharded padded planes and pencil FFT over ``mesh``'s
        ``axis_name`` (its first axis by default) to this plan; every rank
        of the axis then runs the plan's primitives together, and both
        padded dims must divide by the axis size.  ``mesh=None`` unbinds."""
        if mesh is None:
            return self.replace(spatial=None)
        return self.replace(spatial=(mesh, axis_name or mesh.axis_names[0]))


def make_plan(
    optics: OpticsConfig,
    distances: Optional[Sequence[float]] = None,
    device: str | torch.device = "cuda",
    cache_h: bool = True,
) -> PropagatorPlan:
    """Build a :class:`PropagatorPlan` on ``device``.

    ``distances`` fixes the distance stack (one element for the fixed-distance
    propagator); with ``cache_h`` its complex H stack is cached for the
    composable branch (the fused branch computes H itself).  ``cache_h=False``
    keeps only the float32 w-grid, saving D*C*Rp*Cp*8 bytes: H is computed
    where it is used.
    """
    rp, cp = optics.padded_rows, optics.padded_cols
    w_grid = torch.from_numpy(
        _w_grid(rp, cp, optics.pixel_pitch, _inv_wl_sq(optics.wavelengths))
    ).to(device)
    radius = min(rp, cp) * optics.filter_radius_coefficient
    mask = masks_lib.circular_frequency_mask(rp, cp, radius).to(device)
    radial_grid = masks_lib.radial_frequency_grid(rp, cp).to(device)

    h = None
    dist = None
    if distances is not None:
        dist = torch.from_numpy(
            np.atleast_1d(np.asarray(distances, dtype=np.float32))
        ).to(device)
        if cache_h:
            h = _transfer_function(w_grid, dist)

    return PropagatorPlan(
        w_grid=w_grid,
        mask=mask,
        radial_grid=radial_grid,
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


def transfer_function(plan: PropagatorPlan, distances: torch.Tensor) -> torch.Tensor:
    """The (D, C, Rp, Cp) transfer-function stack for any ``distances`` (D,),
    computed from the plan's w-grid (this rank's rows under a spatial
    binding)."""
    distances = torch.atleast_1d(torch.as_tensor(distances, dtype=torch.float32,
                                                 device=plan.w_grid.device))
    return _transfer_function(_w(plan), distances)


def _need_distances(plan: PropagatorPlan) -> None:
    if plan.distances is None:
        raise ValueError(
            "This primitive needs a plan built with a fixed distance stack; "
            "pass distances=[...] to make_plan()."
        )


def _h_stack(plan: PropagatorPlan) -> torch.Tensor:
    """The plan's (D, C, Rp, Cp) transfer stack: cached, or computed from
    the w-grid when the plan was built with ``cache_h=False`` or holds
    only its rank's share (``distance_shard``)."""
    if plan.H is not None and plan.distance_shard is None:
        return _rows(plan, plan.H)
    _need_distances(plan)
    return _transfer_function(_w(plan), plan.distances)


def _fixed_h(plan: PropagatorPlan) -> torch.Tensor:
    """The (C, Rp, Cp) transfer function of the plan's first distance."""
    if plan.H is not None and plan.distance_shard is None:
        return _rows(plan, plan.H[0])
    _need_distances(plan)
    return _transfer_function(_w(plan), plan.distances[:1])[0]


def pad(plan: PropagatorPlan, x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last two axes to the padded sampling grid; under a
    spatial binding, this rank's rows of it (the gradient joins the
    ranks' rows again)."""
    if plan.pad_rows or plan.pad_cols:
        x = F.pad(x, (plan.pad_cols, plan.pad_cols, plan.pad_rows, plan.pad_rows))
    if plan.spatial is None:
        return x
    from ..parallel import collectives

    return collectives.scatter(x, -2, _spatial_axis(plan)[0])


def crop(plan: PropagatorPlan, x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pad`: the central (rows, cols) window.  Under a
    spatial binding ``x`` is this rank's rows: the columns are cropped
    first, then the rows join on every rank."""
    if plan.spatial is not None:
        from ..parallel import collectives

        x = collectives.gather(x[..., plan.pad_cols : plan.pad_cols + plan.cols], -2,
                               _spatial_axis(plan)[0])
        return x[..., plan.pad_rows : plan.pad_rows + plan.rows, :]
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


# A spatial binding (PropagatorPlan.with_spatial): the padded planes' rows
# are split over the mesh axis from pad() to crop(), and every operand a
# primitive multiplies them by is cut to the same rows.


def _spatial_axis(plan: PropagatorPlan) -> Tuple[object, int, int]:
    """(group, size, this rank's index) of a spatially bound plan's axis."""
    mesh, axis = plan.spatial
    group, size, index = mesh.axis(axis)
    if plan.padded_rows % size or plan.padded_cols % size:
        raise ValueError(f"padded grid {plan.padded_rows} x {plan.padded_cols} does not split "
                         f"into {size} ranks")
    return group, size, index


def _rows(plan: PropagatorPlan, t: torch.Tensor) -> torch.Tensor:
    """``t``'s rows (axis -2) of the padded grid that this rank holds under
    a spatial binding; ``t`` itself without one."""
    if plan.spatial is None:
        return t
    _, size, index = _spatial_axis(plan)
    per = plan.padded_rows // size
    return t[..., index * per : (index + 1) * per, :]


def _w(plan: PropagatorPlan) -> torch.Tensor:
    return _rows(plan, plan.w_grid)


def _mask(plan: PropagatorPlan) -> torch.Tensor:
    return _rows(plan, plan.mask)


def _spectrum_mean(plan: PropagatorPlan, x: torch.Tensor) -> torch.Tensor:
    """The mean of a padded-grid tensor over all its rows (the ranks' row
    blocks are equal, so the mean of their means)."""
    if plan.spatial is None:
        return torch.mean(x)
    from ..parallel import collectives

    group, size, _ = _spatial_axis(plan)
    return collectives.reduce_from_ranks(torch.mean(x), group) / size


def _fft2(x: torch.Tensor, plan: Optional[PropagatorPlan] = None) -> torch.Tensor:
    if plan is not None and plan.spatial is not None:
        from ..parallel import fft as pfft

        return pfft.pencil_fft2(x, _spatial_axis(plan)[0])
    from .cuda import fft

    return fft.fft2(x)


def _ifft2(x: torch.Tensor, plan: Optional[PropagatorPlan] = None) -> torch.Tensor:
    if plan is not None and plan.spatial is not None:
        from ..parallel import fft as pfft

        return pfft.pencil_fft2(x, _spatial_axis(plan)[0], inverse=True)
    from .cuda import fft

    return fft.ifft2(x)


# ---------------------------------------------------------------------------
# Fused branch: ops/cuda/spectral.propagate_planes (kernel K1)
# ---------------------------------------------------------------------------


def _fused_ok(plan: PropagatorPlan) -> bool:
    if plan.spatial is not None:
        return False  # the pencil FFT composes the spatial path instead
    from .cuda import spectral

    return spectral.supported(plan.padded_rows, plan.padded_cols)


def fused_args(
    plan: PropagatorPlan,
    g: torch.Tensor,
    distances: torch.Tensor,
    *,
    conj_h: bool = False,
    from_spectrum: bool = False,
    per_plane: bool = False,
    use_mask: bool = True,
    mask_override: Optional[torch.Tensor] = None,
):
    """The ``propagate_planes`` arguments ``(fr, fi, wl2, dists, mask, cfg)``
    for unpadded (B, C, rows, cols) complex planes ``g``, or the padded
    (B, C, Rp, Cp) spectrum when ``from_spectrum``.  With ``per_plane``,
    ``distances`` holds one distance per sample, shared by its channels.
    ``mask_override``, an (Rp, Cp) float32 mask, replaces the plan's mask
    and wins over ``use_mask``."""
    b, cch = g.shape[0], g.shape[1]
    shape = g.shape[-2:]
    fr = g.real.float().reshape(b * cch, *shape).contiguous()
    fi = g.imag.float().reshape(b * cch, *shape).contiguous()
    wl2 = torch.from_numpy(np.tile(_inv_wl_sq(plan.wavelengths), b)[:, None]).to(g.device)
    if per_plane:
        dvec = distances.float().reshape(-1).repeat_interleave(cch)[:, None].contiguous()
        num_d = 1
    else:
        dvec = distances.float().reshape(-1, 1).contiguous()
        num_d = int(dvec.shape[0])
    if mask_override is not None:
        mask = mask_override
    else:
        mask = plan.mask if use_mask else None
    cfg = (
        float(plan.pixel_pitch), bool(conj_h), bool(from_spectrum), bool(per_plane),
        num_d, plan.padded_rows, plan.padded_cols,
        (plan.pad_rows, plan.rows, plan.pad_cols, plan.cols),
    )
    return fr, fi, wl2, dvec, mask, cfg


def _fused_apply(
    plan: PropagatorPlan,
    g: torch.Tensor,
    distances: torch.Tensor,
    *,
    conj_h: bool = False,
    from_spectrum: bool = False,
    per_plane: bool = False,
    use_mask: bool = True,
    mask_override: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Propagate unpadded (B, C, rows, cols) complex planes (the padded
    (B, C, Rp, Cp) spectrum when ``from_spectrum``) to every distance.

    Returns (B, D, C, rows, cols) complex64, already cropped to the plan's
    central window (D = 1 when ``per_plane``, whose distances are one per
    sample).
    """
    from .cuda import spectral

    args = fused_args(plan, g, distances, conj_h=conj_h, from_spectrum=from_spectrum,
                      per_plane=per_plane, use_mask=use_mask, mask_override=mask_override)
    outr, outi = spectral.propagate_planes(*args)
    b, cch, num_d = g.shape[0], g.shape[1], args[-1][4]
    out = torch.complex(outr, outi).reshape(b, cch, num_d, plan.rows, plan.cols)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# Base propagation primitives (reference base class :68-139)
# ---------------------------------------------------------------------------


def propagate(
    plan: PropagatorPlan,
    amp: torch.Tensor,
    phs: torch.Tensor,
    distances: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Amplitude+phase -> |field| at ``distances`` (reference __call__ :68-94).

    As in the reference base class, the input batch axis and the distance
    axis are the *same* leading axis (a field with leading dim 1 or D
    broadcasts against H of leading dim D).  For batch x distance use
    :func:`propagate_batch_multi`.  On a grid K1 supports, a (1, C, rows,
    cols) field goes to every distance in one call, and a batch of B
    against 1 or B distances takes one distance per sample (``per_plane``).
    """
    use_plan_stack = distances is None
    if use_plan_stack:
        _need_distances(plan)
        distances = plan.distances
    distances = torch.atleast_1d(torch.as_tensor(distances, dtype=torch.float32,
                                                 device=plan.w_grid.device))
    g = field(amp, phs)
    if _fused_ok(plan) and g.dim() == 4:
        b, d = g.shape[0], int(distances.shape[0])
        if b == 1:
            return _fused_apply(plan, g, distances)[0].abs()
        if d in (1, b):
            z = distances.expand(b).contiguous()
            return _fused_apply(plan, g, z, per_plane=True)[:, 0].abs()
    h = _h_stack(plan) if use_plan_stack else _transfer_function(_w(plan), distances)
    g0 = _fft2(pad(plan, g), plan)
    return crop(plan, _ifft2(g0 * (h * _mask(plan)), plan)).abs()


def propagate_p2i(
    plan: PropagatorPlan, phs: torch.Tensor, distances: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Phase-only -> intensity |field|^2 (reference propagate_P2I :131-139)."""
    return propagate(plan, torch.ones_like(phs), phs, distances) ** 2


def propagate_ap2ap(
    plan: PropagatorPlan,
    amp_phs: torch.Tensor,
    distances: Optional[torch.Tensor] = None,
    backward: bool = False,
) -> torch.Tensor:
    """6-channel amp/phase -> 6-channel amp/phase at ``distances``.

    Input (B, 6, rows, cols), channels interleaved per colour [a_r, p_r,
    a_g, p_g, a_b, p_b]; output [amps(3), phases(3)] (reference :96-129,
    :338-368).  ``backward=True`` multiplies by conj(H), the fixed-distance
    subclass's backward direction (reference :365-367).  The input is at
    the unpadded (rows, cols) grid and is padded here, as in the JAX
    package (the reference pads an input it assumes already padded).
    """
    b = amp_phs.shape[0]
    ap = amp_phs.reshape(b, 3, 2, amp_phs.shape[-2], amp_phs.shape[-1])
    g = field(ap[:, :, 0], ap[:, :, 1])
    h = _h_stack(plan) if distances is None else transfer_function(plan, distances)
    if backward:
        h = torch.conj(h)
    gz = crop(plan, _ifft2(_fft2(pad(plan, g), plan) * h, plan))
    return torch.cat([gz.abs(), _angle(gz)], dim=1)


# ---------------------------------------------------------------------------
# Fixed-distance primitives (reference subclass :263-466)
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
    gz = _fft2(pad(plan, g), plan)
    return crop(plan, _ifft2(gz * torch.conj(_fixed_h(plan)), plan))


def propagate_poh2freq_forward(plan: PropagatorPlan, poh: torch.Tensor) -> torch.Tensor:
    """Phase-only hologram -> filtered image-plane spectrum, the full padded
    (B, C, Rp, Cp) complex64 (reference :386-392)."""
    g0 = _fft2(pad(plan, field(torch.ones_like(poh), poh)), plan)
    return g0 * (_fixed_h(plan) * _mask(plan))


def propagate_poh2ap_forward(
    plan: PropagatorPlan, poh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """POH -> (amp, phase) at the plan's fixed distance (reference :414-424)."""
    g = field(torch.ones_like(poh), poh)
    if _fused_ok(plan) and plan.distances is not None:
        gz = _fused_apply(plan, g, plan.distances[:1])[:, 0]
        return gz.abs(), _angle(gz)
    g0 = _fft2(pad(plan, g), plan)
    gz = crop(plan, _ifft2(g0 * (_fixed_h(plan) * _mask(plan)), plan))
    return gz.abs(), _angle(gz)


def _sigmoid_mask(plan: PropagatorPlan, filter_radius_coefficient) -> torch.Tensor:
    radius = min(plan.padded_rows, plan.padded_cols) * filter_radius_coefficient
    return masks_lib.differentiable_circular_mask(_rows(plan, plan.radial_grid), radius)


def propagate_poh2ap_forward_with_spectrum_loss(
    plan: PropagatorPlan,
    poh: torch.Tensor,
    filter_radius_coefficient: torch.Tensor | float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """POH -> (amp, phase, spectrum_loss) through the sigmoid-edged low-pass
    (reference :394-412): ``spectrum_loss = mean(|G0| - |G_filtered|)`` over
    the full padded spectrum, the energy the POH puts outside the pass
    band.  Runs on :func:`_fft2`/:func:`_ifft2` (K3 on a CUDA tensor, its
    adjoint in the backward)."""
    g0 = _fft2(pad(plan, field(torch.ones_like(poh), poh)), plan)
    gz_f = g0 * (_fixed_h(plan) * _sigmoid_mask(plan, filter_radius_coefficient))
    spectrum_loss = _spectrum_mean(plan, g0.abs() - gz_f.abs())
    gz = crop(plan, _ifft2(gz_f, plan))
    return gz.abs(), _angle(gz), spectrum_loss


def differentiable_lowpass_filter(
    plan: PropagatorPlan,
    amp: torch.Tensor,
    phs: torch.Tensor,
    filter_radius_coefficient: torch.Tensor | float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Low-pass an amp/phase pair through the sigmoid-edged mask, without
    propagating (reference AP2POH.py:75-84); K3 on a CUDA tensor."""
    g = _ifft2(_fft2(pad(plan, field(amp, phs)), plan) * _sigmoid_mask(plan, filter_radius_coefficient), plan)
    g = crop(plan, g)
    return g.abs(), _angle(g)


# ---------------------------------------------------------------------------
# Multi-distance focal-stack primitives (reference subclass :469-552)
# ---------------------------------------------------------------------------
#
# On a distance-sharded plan (parallel.shard_distance_stack) each rank
# computes the planes of its own distances (the random draw: its share of
# the sample pairs) from the replicated spectrum, and the planes join on
# every rank (parallel/collectives.gather): the results are the unsharded
# ones, and the gradient of the replicated input sums every rank's share.


def _shard(plan: PropagatorPlan):
    """(group, size, index) of a distance-sharded plan's mesh axis."""
    mesh, axis = plan.distance_shard
    return mesh.axis(axis)


def _local_plan(plan: PropagatorPlan) -> PropagatorPlan:
    """A distance-sharded plan cut to this rank's distances (its H is
    already this rank's share)."""
    _, size, index = _shard(plan)
    per = plan.num_distances // size
    return plan.replace(distances=plan.distances[index * per:(index + 1) * per], distance_shard=None)


def _join_distances(planes: torch.Tensor, b: int, group) -> torch.Tensor:
    """(..., B * D/p, C, rows, cols) sample-major planes of every rank ->
    (..., B * D, C, rows, cols), row ``b*D + d`` sample b at distance d."""
    from ..parallel import collectives

    lead = planes.shape[:-4]
    planes = planes.reshape(*lead, b, -1, *planes.shape[-3:])
    planes = collectives.gather(planes, len(lead) + 1, group)
    return planes.reshape(*lead, -1, *planes.shape[-3:])



def _sequential_planes(plan: PropagatorPlan, g0: torch.Tensor, distances: torch.Tensor, outs):
    """For each distance z in turn, ``crop(ifft2(g0 * H(z) * mask))``, one
    padded plane set in flight: each ``fn`` of ``outs``, a list of
    (fn, out) pairs with ``out`` a (B, D, C, rows, cols) tensor, writes
    ``fn(plane)`` into ``out[:, d]``."""
    for d in range(int(distances.shape[0])):
        h = _transfer_function(_w(plan), distances[d : d + 1])[0]
        plane = crop(plan, _ifft2(g0 * (h * _mask(plan)), plan))
        for fn, out in outs:
            out[:, d] = fn(plane)


def propagate_batch_multi(
    plan: PropagatorPlan,
    amp: torch.Tensor,
    phs: torch.Tensor,
    distances: Optional[torch.Tensor] = None,
    sequential: bool = False,
) -> torch.Tensor:
    """Batch x multi-distance propagation -> (B*D, C, rows, cols) amplitudes,
    row ``b*D + d`` being sample b at distance d (reference :503-522).

    ``sequential=True`` propagates one distance at a time instead of
    building the (B, D, C, Rp, Cp) spectrum stack: peak memory is one padded
    plane set whatever D (the single-card 1080p/4K mode)."""
    use_plan_stack = distances is None
    if use_plan_stack and plan.distance_shard is not None:
        from ..parallel import collectives

        group = _shard(plan)[0]
        amp, phs = collectives.copy_to_ranks(amp, group), collectives.copy_to_ranks(phs, group)
        out = propagate_batch_multi(_local_plan(plan), amp, phs, sequential=sequential)
        return _join_distances(out, amp.shape[0], group)
    if use_plan_stack:
        if plan.distances is None:
            raise ValueError("plan has no distance stack and none was passed")
        distances = plan.distances
    distances = torch.atleast_1d(distances.float())
    g = field(amp, phs)
    if _fused_ok(plan) and not sequential:
        out = _fused_apply(plan, g, distances).abs()
        return out.reshape(out.shape[0] * out.shape[1], *out.shape[2:])
    g0 = _fft2(pad(plan, g), plan)  # (B, C, Rp, Cp)
    if sequential:
        b, d = g0.shape[0], int(distances.shape[0])
        out = g0.real.new_empty(b, d, g0.shape[1], plan.rows, plan.cols)
        _sequential_planes(plan, g0, distances, [(torch.abs, out)])
        return out.reshape(b * d, *out.shape[2:])
    h = _h_stack(plan) if use_plan_stack else _transfer_function(_w(plan), distances)
    gz = g0[:, None] * (h * _mask(plan))[None]  # (B, D, C, Rp, Cp)
    gz = gz.reshape(gz.shape[0] * gz.shape[1], *gz.shape[2:])
    return crop(plan, _ifft2(gz, plan)).abs()


def filter_ap2filtered_freq(
    plan: PropagatorPlan, amp: torch.Tensor, phs: torch.Tensor
) -> torch.Tensor:
    """Target amp/phase -> aperture-filtered padded spectrum (reference
    :548-552).  ``phs`` is the dataset's normalized [0, 1] phase, scaled by
    2*pi here like the reference."""
    g0 = _fft2(pad(plan, field(amp, (2.0 * np.pi) * phs)), plan)
    return g0 * _mask(plan)


def freq2ap_all_distances(
    plan: PropagatorPlan, g0: torch.Tensor, sequential: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectrum (B, C, Rp, Cp) -> (amp, phase) at every cached distance,
    each (B*D, C, rows, cols), row ``b*D + d`` being sample b at distance d
    (reference :524-531).  ``sequential=True`` propagates one distance at a
    time, one padded plane set in flight (the single-card 1080p/4K
    evaluation mode, as :func:`propagate_batch_multi`)."""
    if plan.distance_shard is not None:
        from ..parallel import collectives

        group = _shard(plan)[0]
        amp, phs = freq2ap_all_distances(_local_plan(plan), collectives.copy_to_ranks(g0, group),
                                         sequential)
        both = _join_distances(torch.stack([amp, phs]), g0.shape[0], group)
        return both[0], both[1]
    if sequential:
        _need_distances(plan)
        b, d = g0.shape[0], plan.num_distances
        amp = g0.real.new_empty(b, d, g0.shape[1], plan.rows, plan.cols)
        phs = torch.empty_like(amp)
        _sequential_planes(plan, g0, plan.distances, [(torch.abs, amp), (_angle, phs)])
        return amp.reshape(b * d, *amp.shape[2:]), phs.reshape(b * d, *phs.shape[2:])
    if _fused_ok(plan) and plan.distances is not None:
        out = _fused_apply(plan, g0, plan.distances, from_spectrum=True)
        gz = out.reshape(out.shape[0] * out.shape[1], *out.shape[2:])
        return gz.abs(), _angle(gz)
    gz = g0[:, None] * (_h_stack(plan) * _mask(plan))[None]  # (B, D, C, Rp, Cp)
    gz = crop(plan, _ifft2(gz.reshape(gz.shape[0] * gz.shape[1], *gz.shape[2:]), plan))
    return gz.abs(), _angle(gz)


def freq2amp_at(
    plan: PropagatorPlan, g0: torch.Tensor, distances: torch.Tensor
) -> torch.Tensor:
    """Spectrum (B, C, Rp, Cp) -> amplitude (B, D, C, rows, cols) at any
    ``distances`` (D,), H computed for them (the serving focal stack; the
    reference's forward_from_filtered_frequency, :524-531, is pinned to the
    cached stack).  On a grid K1 supports, one ``from_spectrum`` call of
    ``propagate_planes``; else the ``torch.fft`` chain with
    ``transfer_function(plan, distances) * plan.mask``."""
    distances = torch.atleast_1d(torch.as_tensor(distances, dtype=torch.float32,
                                                 device=plan.w_grid.device))
    if _fused_ok(plan):
        return _fused_apply(plan, g0, distances, from_spectrum=True).abs()
    gz = g0[:, None] * (transfer_function(plan, distances) * _mask(plan))[None]
    b, d = gz.shape[0], gz.shape[1]
    gz = crop(plan, _ifft2(gz.reshape(b * d, *gz.shape[2:]), plan))
    return gz.abs().reshape(b, d, *gz.shape[1:])


def draw_distance_indices(
    plan: PropagatorPlan, batch: int, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """(batch,) distinct indices into the plan's distance stack, a random
    permutation's head drawn from ``generator`` on the CPU (reference
    randperm, :536).  Needs batch <= num_distances."""
    num_d = plan.num_distances
    if batch > num_d:
        raise ValueError(
            f"random-distance draw needs batch <= num_distances (got batch {batch}, "
            f"{num_d} cached distances): distances are drawn without "
            "replacement, matching the reference's randperm (:536)."
        )
    return torch.randperm(num_d, generator=generator)[:batch]


def freq2ap_random_distances(
    plan: PropagatorPlan, g0: torch.Tensor, idx: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair each (hat, target) sample with one cached distance.

    ``g0`` is a (2B, C, Rp, Cp) stack, generated ("hat") half first, then
    target; hat[i] and target[i] both go to distance ``idx[i]`` (reference
    :533-546; :func:`draw_distance_indices` draws ``idx``).  Returns
    ((2B, C, rows, cols) amp, phase).
    """
    b = g0.shape[0] // 2
    if tuple(idx.shape) != (b,):
        raise ValueError(f"need one distance index per sample pair, got {tuple(idx.shape)}")
    idx = idx.to(plan.distances.device)
    if plan.distance_shard is not None:
        return _random_distances_sharded(plan, g0, idx)
    if _fused_ok(plan):
        z = plan.distances[idx]
        gz = _fused_apply(plan, g0, torch.cat([z, z]), from_spectrum=True, per_plane=True)[:, 0]
        return gz.abs(), _angle(gz)
    if plan.H is not None:
        h = _rows(plan, plan.H)[idx] * _mask(plan)  # (B, C, Rp, Cp)
    else:
        # on the fly: only the B drawn distances are built
        h = _transfer_function(_w(plan), plan.distances[idx]) * _mask(plan)
    gz = g0.reshape(2, b, *g0.shape[1:]) * h[None]
    gz = crop(plan, _ifft2(gz.reshape(2 * b, *g0.shape[1:]), plan))
    return gz.abs(), _angle(gz)


def _random_distances_sharded(
    plan: PropagatorPlan, g0: torch.Tensor, idx: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`freq2ap_random_distances` on a distance-sharded plan: the 2B
    (sample, distance) planes split evenly over the ranks (the last
    padded by repeating it), each rank's with H for its planes' distances,
    joined on every rank."""
    from ..parallel import collectives

    group, size, index = _shard(plan)
    n = g0.shape[0]
    z = plan.distances[idx]
    z = torch.cat([z, z])
    per = -(-n // size)
    pad_n = per * size - n
    if pad_n:
        g0 = torch.cat([g0, g0[-1:].expand(pad_n, *g0.shape[1:])])
        z = torch.cat([z, z[-1:].expand(pad_n)])
    g_local = collectives.scatter(g0, 0, group)
    z_local = z[index * per:(index + 1) * per]
    whole = plan.replace(H=None, distance_shard=None)
    if _fused_ok(whole):
        gz = _fused_apply(whole, g_local, z_local, from_spectrum=True, per_plane=True)[:, 0]
    else:
        h = _transfer_function(whole.w_grid, z_local) * whole.mask
        gz = crop(whole, _ifft2(g_local * h, whole))
    gz = collectives.gather(gz, 0, group)[:n]
    return gz.abs(), _angle(gz)


def hat_target_random_distances(
    gen_plan: PropagatorPlan,
    multi_plan: PropagatorPlan,
    poh: torch.Tensor,
    target_amp: torch.Tensor,
    target_phs: torch.Tensor,
    idx: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-H hat/target random-distance reconstruction.

    The composition of :func:`propagate_poh2freq_forward`,
    :func:`filter_ap2filtered_freq` and :func:`freq2ap_random_distances`
    (reference :386-392, :548-552, :533-546), with the hat branch's fixed
    SLM -> image H and its focal H folded into one transfer function,
    H(z1) * H(z2) == H(z1 + z2) on the shared w-grid: neither branch builds a
    padded spectrum.  Masks as in the composed path: the hat gets
    ``gen.mask * multi.mask``, the target ``multi.mask ** 2``.  Summing the
    distances re-rounds the transfer function's phase, so the outputs differ
    from the composed path's by O(1e-3) relative, as the JAX package's do.

    ``idx`` (B,) indexes the multi plan's distance stack (as for
    :func:`freq2ap_random_distances`); hat[i] and target[i] share
    ``idx[i]``.  On a grid K1 supports both branches are one field-input,
    ``per_plane`` call of ``propagate_planes`` with the mask above; else
    ``torch.fft``.  Returns (hat_amp, target_amp, hat_phs, target_phs), each
    (B, C, rows, cols).
    """
    if (
        gen_plan.padded_rows != multi_plan.padded_rows
        or gen_plan.padded_cols != multi_plan.padded_cols
        or gen_plan.pixel_pitch != multi_plan.pixel_pitch
        or gen_plan.wavelengths != multi_plan.wavelengths
    ):
        raise ValueError(
            "two-H hat path needs gen and multi plans on the same padded "
            "grid/pitch/wavelengths (shared w-grid); got "
            f"{(gen_plan.padded_rows, gen_plan.padded_cols)} vs "
            f"{(multi_plan.padded_rows, multi_plan.padded_cols)}."
        )
    num_d = multi_plan.num_distances
    b = poh.shape[0]
    if b > num_d:
        raise ValueError(
            f"random-distance draw needs batch <= num_distances (got batch "
            f"{b}, {num_d} cached distances)."
        )
    if gen_plan.distances is None:
        raise ValueError("gen_plan needs its fixed distance (make_plan(distances=[z]))")
    if tuple(idx.shape) != (b,):
        raise ValueError(f"need one distance index per sample, got {tuple(idx.shape)}")
    z = multi_plan.distances[idx.to(multi_plan.distances.device)]  # (B,)
    z_hat = gen_plan.distances[0] + z
    hat_mask = _rows(multi_plan, gen_plan.mask * multi_plan.mask)
    tgt_mask = _mask(multi_plan) * _mask(multi_plan)
    g_hat = field(torch.ones_like(poh), poh)
    g_tgt = field(target_amp, (2.0 * np.pi) * target_phs)
    if _fused_ok(multi_plan):
        hat = _fused_apply(multi_plan, g_hat, z_hat, per_plane=True, mask_override=hat_mask)[:, 0]
        tgt = _fused_apply(multi_plan, g_tgt, z, per_plane=True, mask_override=tgt_mask)[:, 0]
    else:
        h_hat = _transfer_function(_w(multi_plan), z_hat) * hat_mask  # (B, C, Rp, Cp)
        h_tgt = _transfer_function(_w(multi_plan), z) * tgt_mask
        hat = crop(multi_plan, _ifft2(_fft2(pad(multi_plan, g_hat), multi_plan) * h_hat, multi_plan))
        tgt = crop(multi_plan, _ifft2(_fft2(pad(multi_plan, g_tgt), multi_plan) * h_tgt, multi_plan))
    return hat.abs(), tgt.abs(), _angle(hat), _angle(tgt)
