"""Kernels K1 and K2: fused band-limited ASM propagation and its backward.

Counterpart of ``learned_hologram_gan_tpu/ops/pallas/spectral.py:
propagate_planes`` (``_planes_fwd_impl`` / ``_planes_bwd_impl`` +
``_middle_pass``, the ``pl.pallas_call`` at spectral.py:686) with the same
signature and all of its modes (``mask`` is any (rp, cp) float32 mask on
the planes' device: the plan's, or a caller's such as the two-H hat path's
product of two plans' masks).  The forward on a CUDA tensor:

  1. column transform of the field, zero-padded to ``cp`` columns
     (``torch.fft.fft``; the JAX package runs this as a plain XLA GEMM),
     skipped in ``from_spectrum`` mode, whose input is the padded spectrum;
  2. the row pass in ``csrc/k1_asm_propagate.cu`` (K1): row FFT of the
     nonzero rows (skipped in ``from_spectrum`` mode) -> H * mask computed in
     the kernel -> inverse row FFT, writing only the cropped rows, for every
     distance (``per_plane``: one distance per plane), its FFTs in registers
     on ``csrc/fft_hopper.cuh`` with the plan of :mod:`.fft_plan`;
  3. inverse column transform and column crop (``torch.fft.ifft``).

The backward is the conjugate transpose of that map (K2, the same file,
on the same FFT core and plans, with K1's block shapes): column transform
of the embedded cotangent, then the adjoint row pass, which sums the
distances in the spectrum, then the inverse column transform and crop (or,
with ``from_spectrum``, the full padded spectrum).

:func:`propagate_planes_reference` and :func:`propagate_planes_adjoint_reference`
are the plain versions.  :func:`propagate_planes` is a
``torch.autograd.Function`` on the real planes ``(fr, fi) -> (re, im)``: on
CPU tensors its forward and backward run the plain versions, on CUDA tensors
they launch K1 and K2 or raise.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import asm
from . import fft_plan

KERNEL_NAME = "k1_asm_propagate"

Cfg = Tuple[float, bool, bool, bool, int, int, int, Optional[Tuple[int, int, int, int]]]


def _pick_cpb(plan: fft_plan.FftPlan, keep_spectrum: bool) -> Optional[int]:
    """K1's and K2's columns per block (:func:`.fft_plan.k1_columns`): at
    least 8 (64-byte row segments) where they fit."""
    return fft_plan.k1_columns(plan, keep_spectrum)


@functools.lru_cache(maxsize=None)
def supported(rp: int, cp: int) -> bool:
    """True if K1 and K2 handle a (rp, cp) padded grid: rp a length with an
    FFT plan (:func:`.fft_plan.make_plan`: n = 2^a 3^b 5^c up to 16384,
    every power of two) whose block fits with the second array kept (every
    mode then fits), any cp (a ragged last block is masked)."""
    try:
        plan = fft_plan.make_plan(rp)
    except ValueError:
        return False
    return _pick_cpb(plan, True) is not None


def _unpack(cfg: Cfg):
    pitch, conj_h, from_spectrum, per_plane, num_d, rp, cp, crop = cfg
    if per_plane and num_d != 1:
        raise ValueError("propagate_planes: per_plane mode takes num_d == 1")
    r0, rows, c0, cols = crop if crop is not None else (0, rp, 0, cp)
    return pitch, conj_h, from_spectrum, per_plane, num_d, rp, cp, r0, rows, c0, cols


def _transfer(wl2, dists, mask, cfg: Cfg) -> torch.Tensor:
    """H * mask for every plane: (P, D, rp, cp) complex64, D = 1 when
    per_plane (plane p at distance dists[p])."""
    pitch, conj_h, _, per_plane, _, rp, cp, *_ = _unpack(cfg)
    # H from the port's w-grid, one grid per distinct 1/lambda^2
    wl2_u, plane_wl = np.unique(wl2.reshape(-1).cpu().numpy(), return_inverse=True)
    w_u = torch.from_numpy(asm._w_grid(rp, cp, pitch, wl2_u)).to(wl2.device)
    w = w_u[torch.from_numpy(plane_wl.reshape(-1)).to(wl2.device)]  # (P, rp, cp)
    z = dists.reshape(-1).float()
    if per_plane:
        sign = torch.tensor(np.float32(-2.0 * np.pi), device=w.device)
        theta = (sign * z)[:, None, None] * w  # the f32 order of _transfer_function
        h = torch.complex(torch.cos(theta), torch.sin(theta))[:, None]  # (P, 1, rp, cp)
    else:
        h = asm._transfer_function(w, z).transpose(0, 1)  # (P, D, rp, cp)
    if conj_h:
        h = torch.conj(h)
    return h * mask if mask is not None else h


def propagate_planes_reference(fr, fi, wl2, dists, mask, cfg: Cfg):
    """Plain PyTorch version of the forward (same arguments).

    fr/fi: (P, rows, cols) float32 unpadded field, or the (P, rp, cp) padded
    spectrum when ``from_spectrum``.  wl2: (P, 1) float32 ``1/lambda^2`` per
    plane.  dists: (D, 1) float32, or (P, 1) when ``per_plane``.  mask:
    (rp, cp) float32 or None.  Returns ``(re, im)``, each (P, D, rows, cols)
    float32 (D = 1 when ``per_plane``).
    """
    _, _, from_spectrum, _, _, rp, cp, r0, rows, c0, cols = _unpack(cfg)
    g = torch.complex(fr.float(), fi.float())
    if from_spectrum:
        spec = g
    else:
        spec = torch.fft.fft2(F.pad(g, (c0, cp - cols - c0, r0, rp - rows - r0)))
    out = torch.fft.ifft2(spec[:, None] * _transfer(wl2, dists, mask, cfg))
    out = out[..., r0 : r0 + rows, c0 : c0 + cols]
    return out.real.contiguous(), out.imag.contiguous()


def propagate_planes_adjoint_reference(gr, gi, wl2, dists, mask, cfg: Cfg):
    """Plain PyTorch version of the backward: the conjugate transpose M^H of
    the forward's complex-linear map M, applied to ``gr + i*gi``
    (P, D, rows, cols).  Returns ``(re, im)`` of the input's shape."""
    _, _, from_spectrum, _, _, rp, cp, r0, rows, c0, cols = _unpack(cfg)
    g = torch.complex(gr.float(), gi.float())
    g = F.pad(g, (c0, cp - cols - c0, r0, rp - rows - r0))
    # adjoint of ifft2 is fft2 / (rp * cp); of the product with H, conj(H)
    acc = (torch.fft.fft2(g) * torch.conj(_transfer(wl2, dists, mask, cfg))).sum(1)
    if from_spectrum:
        out = acc / (rp * cp)
    else:
        # adjoint of the padded fft2 is (rp * cp) * ifft2, then the crop
        out = torch.fft.ifft2(acc)[..., r0 : r0 + rows, c0 : c0 + cols]
    return out.real.contiguous(), out.imag.contiguous()


@functools.lru_cache(maxsize=None)
def _kernel_fns(defines: Tuple[str, ...] = ()):
    from .build import load_library

    lib = load_library(KERNEL_NAME, defines)
    k1, k2 = lib.k1_asm_row_pass, lib.k2_asm_row_adjoint
    for fn in (k1, k2):  # the same arguments
        fn.argtypes = (
            [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 9
            + [ctypes.c_float] * 3
            + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    err = lib.k1_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return k1, k2, err


def _as_contig(t: torch.Tensor, shape, name: str) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"propagate_planes: {name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if t.dtype != torch.float32:
        raise ValueError(f"propagate_planes: {name} must be float32, got {t.dtype}")
    return t.contiguous()


def _launch(adjoint: bool, x: torch.Tensor, wl2, dists, mask, cfg: Cfg) -> torch.Tensor:
    pitch, conj_h, from_spectrum, per_plane, num_d, rp, cp, r0, rows, c0, cols = _unpack(cfg)
    name = "K2" if adjoint else "K1"
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError(f"{name} is built for sm_90a (Hopper) only")
    if not supported(rp, cp):
        raise ValueError(f"{name} does not support a ({rp}, {cp}) padded grid")
    p = x.shape[0]
    if adjoint:
        in_shape, out_shape = (p, num_d, rows, cp), (p, rp if from_spectrum else rows, cp)
    else:
        in_shape, out_shape = (p, rp if from_spectrum else rows, cp), (p, num_d, rows, cp)
    if x.dtype != torch.complex64 or tuple(x.shape) != in_shape:
        raise ValueError(f"{name}: input must be complex64 {in_shape}, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    wl2 = _as_contig(wl2, (p, 1), "wl2")
    dists = _as_contig(dists, (p if per_plane else num_d, 1), "dists")
    if mask is not None:
        mask = _as_contig(mask, (rp, cp), "mask")
    for t in (wl2, dists, mask):
        if t is not None and t.device != x.device:
            raise ValueError("propagate_planes: all tensors must be on one device")
    out = torch.empty(out_shape, dtype=torch.complex64, device=x.device)
    plan, ints, tw = fft_plan.device_plan(rp, x.device)
    k1, k2, err_str = _kernel_fns(fft_plan.build_defines(plan))
    code = (k2 if adjoint else k1)(
        x.data_ptr(), out.data_ptr(), wl2.data_ptr(), dists.data_ptr(),
        None if mask is None else mask.data_ptr(), tw.data_ptr(), ints.ctypes.data,
        p, rows, cp, rp, r0, num_d, _pick_cpb(plan, num_d > 1), int(from_spectrum), int(per_plane),
        float(np.float32(1.0 / (rp * pitch))),
        float(np.float32(1.0 / (cp * pitch))),
        float(np.float32(2.0 * np.pi if conj_h else -2.0 * np.pi)),
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"{name} launch failed: {err_str(code).decode()} ({code})")
    return out


def row_pass(x: torch.Tensor, wl2, dists, mask, cfg: Cfg) -> torch.Tensor:
    """Launch K1 on the column-transformed (P, rows, cp) complex64 spectrum
    (the padded (P, rp, cp) spectrum when ``from_spectrum``); returns
    (P, D, rows, cp) complex64 (rows cropped, columns not)."""
    out = _launch(False, x, wl2, dists, mask, cfg)
    row_pass.launches += 1
    row_pass.launches_by_mode[_mode(cfg)] += 1
    return out


def row_adjoint(g: torch.Tensor, wl2, dists, mask, cfg: Cfg) -> torch.Tensor:
    """Launch K2 on the column-transformed (P, D, rows, cp) complex64
    cotangent; returns (P, rows, cp), or (P, rp, cp) when ``from_spectrum``."""
    out = _launch(True, g, wl2, dists, mask, cfg)
    row_adjoint.launches += 1
    row_adjoint.launches_by_mode[_mode(cfg)] += 1
    return out


def _mode(cfg: Cfg) -> str:
    """The launch counters' name for ``cfg``'s mode: its input (``field``
    or ``from_spectrum``; ``conj_h`` is field input with conj(H)), then
    ``+per_plane`` where each plane has its own distance."""
    _, conj_h, from_spectrum, per_plane, *_ = cfg
    name = "from_spectrum" if from_spectrum else ("conj_h" if conj_h else "field")
    return name + "+per_plane" if per_plane else name


def _forward_cuda(fr, fi, wl2, dists, mask, cfg: Cfg):
    _, _, from_spectrum, _, _, rp, cp, r0, rows, c0, cols = _unpack(cfg)
    g = torch.complex(fr.float(), fi.float())
    if not from_spectrum:
        g = torch.fft.fft(F.pad(g, (c0, cp - cols - c0)), dim=-1)  # (P, rows, cp)
    y = row_pass(g, wl2, dists, mask, cfg)
    y = torch.fft.ifft(y, dim=-1)[..., c0 : c0 + cols]
    return y.real.contiguous(), y.imag.contiguous()


def _adjoint_cuda(gr, gi, wl2, dists, mask, cfg: Cfg):
    _, _, from_spectrum, _, _, rp, cp, r0, rows, c0, cols = _unpack(cfg)
    g = torch.complex(gr.float(), gi.float())
    # adjoint of the column ifft + crop: embed, fft / cp; the 1/cp cancels
    # against the adjoint of the forward column fft, which is cp * ifft
    x = torch.fft.fft(F.pad(g, (c0, cp - cols - c0)), dim=-1)  # (P, D, rows, cp)
    y = row_adjoint(x, wl2, dists, mask, cfg)
    if from_spectrum:
        y = y / cp
    else:
        y = torch.fft.ifft(y, dim=-1)[..., c0 : c0 + cols]
    return y.real.contiguous(), y.imag.contiguous()


class _PropagatePlanes(torch.autograd.Function):
    """(fr, fi) -> (re, im); the backward is the real transpose, i.e. M^H
    on ``gr + i*gi``.  ``wl2``, ``dists`` and ``mask`` get no gradient."""

    @staticmethod
    def forward(ctx, fr, fi, wl2, dists, mask, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(wl2, dists, mask)
        if fr.device.type == "cpu":
            return propagate_planes_reference(fr, fi, wl2, dists, mask, cfg)
        return _forward_cuda(fr, fi, wl2, dists, mask, cfg)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gr, gi):
        wl2, dists, mask = ctx.saved_tensors
        if gr.device.type == "cpu":
            dr, di = propagate_planes_adjoint_reference(gr, gi, wl2, dists, mask, ctx.cfg)
        else:
            dr, di = _adjoint_cuda(gr, gi, wl2, dists, mask, ctx.cfg)
        return dr, di, None, None, None, None


def propagate_planes(fr, fi, wl2, dists, mask, cfg: Cfg):
    """Fused, differentiable ASM propagation of P planes to D distances.

    Same arguments and result as :func:`propagate_planes_reference`.  CPU
    tensors take the plain versions (forward and backward); CUDA tensors
    launch K1 (forward) and K2 (backward).
    """
    return _PropagatePlanes.apply(fr, fi, wl2, dists, mask, cfg)


def reset_launch_counts() -> None:
    row_pass.launches = 0
    row_pass.launches_by_mode = collections.Counter()
    row_adjoint.launches = 0
    row_adjoint.launches_by_mode = collections.Counter()


# launches of K1 and K2 (incremented only where the kernel is launched)
reset_launch_counts()
