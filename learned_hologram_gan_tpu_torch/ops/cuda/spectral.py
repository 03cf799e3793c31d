"""Kernel K1: fused band-limited ASM propagation, forward.

Counterpart of ``learned_hologram_gan_tpu/ops/pallas/spectral.py:
propagate_planes`` (``_planes_fwd_impl`` + ``_middle_pass``, the
``pl.pallas_call`` at spectral.py:686) with the same signature, forward
only.  The pipeline on a CUDA tensor:

  1. column transform of the unpadded field, zero-padded to ``cp`` columns
     (``torch.fft.fft``; the JAX package runs this as a plain XLA GEMM);
  2. the row pass in ``csrc/k1_asm_propagate.cu``: row FFT of the ``rows``
     nonzero rows -> H * mask computed in the kernel -> inverse row FFT,
     writing only the cropped rows, for every distance;
  3. inverse column transform and column crop (``torch.fft.ifft``).

:func:`propagate_planes_reference` is the plain version: pad -> ``fft2`` ->
H * mask -> ``ifft2`` -> crop, with H from ``asm._w_grid`` and
``asm._transfer_function``.  The
wrapper takes it only for tensors on the CPU; on a CUDA tensor it launches
the kernel or raises.

The JAX function's ``from_spectrum`` and ``per_plane`` modes (and the
``mask_override`` callers built on them) serve training only and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import asm

KERNEL_NAME = "k1_asm_propagate"
# dynamic shared memory a Hopper block may use (227 KB)
_SMEM_LIMIT = 232448

Cfg = Tuple[float, bool, bool, bool, int, int, int, Optional[Tuple[int, int, int, int]]]


def _smem_bytes(rp: int, tc: int) -> int:
    # stage-1 spectrum + per-distance buffer, (rp, tc) complex each, + twiddles
    return (2 * rp * tc + rp // 2) * 8


def _pick_tc(rp: int, cp: int) -> Optional[int]:
    # the widest tile that divides cp and fits: at rp = 1024 a 4-column block
    # takes 67 KB, so three share an SM
    for tc in (4, 2, 1):
        if cp % tc == 0 and _smem_bytes(rp, tc) <= _SMEM_LIMIT:
            return tc
    return None


def supported(rp: int, cp: int) -> bool:
    """True if K1 handles a (rp, cp) padded grid: rp a power of two whose
    (rp, tc) buffers fit in shared memory for some tile width tc | cp."""
    return rp >= 2 and rp & (rp - 1) == 0 and _pick_tc(rp, cp) is not None


def _check_cfg(cfg: Cfg):
    pitch, conj_h, from_spectrum, per_plane, num_d, rp, cp, crop = cfg
    if from_spectrum or per_plane:
        raise NotImplementedError(
            "propagate_planes: the from_spectrum and per_plane modes are "
            "training-only and not ported yet"
        )
    r0, rows, c0, cols = crop if crop is not None else (0, rp, 0, cp)
    return pitch, conj_h, num_d, rp, cp, r0, rows, c0, cols


def propagate_planes_reference(fr, fi, wl2, dists, mask, cfg: Cfg):
    """Plain PyTorch version of :func:`propagate_planes` (same arguments).

    fr/fi: (P, rows, cols) float32 unpadded field.  wl2: (P, 1) float32
    ``1/lambda^2`` per plane.  dists: (D, 1) float32.  mask: (rp, cp) float32
    or None.  Returns ``(re, im)``, each (P, D, rows, cols) float32.
    """
    pitch, conj_h, num_d, rp, cp, r0, rows, c0, cols = _check_cfg(cfg)
    g = torch.complex(fr.float(), fi.float())
    g = F.pad(g, (c0, cp - cols - c0, r0, rp - rows - r0))
    spec = torch.fft.fft2(g)  # (P, rp, cp)

    # H from the port's w-grid, one grid per distinct 1/lambda^2
    wl2_u, plane_wl = np.unique(wl2.reshape(-1).cpu().numpy(), return_inverse=True)
    w_u = torch.from_numpy(asm._w_grid(rp, cp, pitch, wl2_u)).to(fr.device)
    w = w_u[torch.from_numpy(plane_wl.reshape(-1)).to(fr.device)]  # (P, rp, cp)
    h = asm._transfer_function(w, dists.reshape(-1).float())  # (D, P, rp, cp)
    if conj_h:
        h = torch.conj(h)
    if mask is not None:
        h = h * mask
    out = torch.fft.ifft2(spec[:, None] * h.transpose(0, 1))
    out = out[..., r0 : r0 + rows, c0 : c0 + cols]
    return out.real.contiguous(), out.imag.contiguous()


@functools.lru_cache(maxsize=None)
def _twiddles(rp: int, device: torch.device) -> torch.Tensor:
    """(rp/2,) complex64 table of exp(2*pi*i*k/rp), computed in float64."""
    k = np.arange(rp // 2, dtype=np.float64)
    tw = np.exp(2j * np.pi * k / rp).astype(np.complex64)
    return torch.from_numpy(tw).to(device)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from .build import load_library

    lib = load_library(KERNEL_NAME)
    fn = lib.k1_asm_row_pass
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 7
        + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    err = lib.k1_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _as_contig(t: torch.Tensor, shape, name: str) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"propagate_planes: {name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if t.dtype != torch.float32:
        raise ValueError(f"propagate_planes: {name} must be float32, got {t.dtype}")
    return t.contiguous()


def row_pass(x: torch.Tensor, wl2, dists, mask, cfg: Cfg) -> torch.Tensor:
    """Launch K1 on the column-transformed (P, rows, cp) complex64 spectrum;
    returns (P, D, rows, cp) complex64 (rows cropped, columns not)."""
    pitch, conj_h, num_d, rp, cp, r0, rows, c0, cols = _check_cfg(cfg)
    if x.device.type != "cuda":
        raise ValueError(f"row_pass needs a CUDA tensor, got {x.device}")
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError("K1 is built for sm_90a (Hopper) only")
    if not supported(rp, cp):
        raise ValueError(f"K1 does not support a ({rp}, {cp}) padded grid")
    tc = _pick_tc(rp, cp)
    p = x.shape[0]
    if x.dtype != torch.complex64 or tuple(x.shape) != (p, rows, cp):
        raise ValueError(f"row_pass: x must be complex64 ({p}, {rows}, {cp})")
    x = x.contiguous()
    wl2 = _as_contig(wl2, (p, 1), "wl2")
    dists = _as_contig(dists, (num_d, 1), "dists")
    if mask is not None:
        mask = _as_contig(mask, (rp, cp), "mask")
    for t in (wl2, dists, mask):
        if t is not None and t.device != x.device:
            raise ValueError("propagate_planes: all tensors must be on one device")
    out = torch.empty((p, num_d, rows, cp), dtype=torch.complex64, device=x.device)
    tw = _twiddles(rp, x.device)
    fn, err_str = _kernel_fn()
    code = fn(
        x.data_ptr(), out.data_ptr(), wl2.data_ptr(), dists.data_ptr(),
        None if mask is None else mask.data_ptr(), tw.data_ptr(),
        p, rows, cp, rp, r0, num_d, tc,
        float(np.float32(1.0 / (rp * pitch))),
        float(np.float32(1.0 / (cp * pitch))),
        float(np.float32(2.0 * np.pi if conj_h else -2.0 * np.pi)),
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"K1 launch failed: {err_str(code).decode()} ({code})")
    propagate_planes.launches += 1
    return out


def propagate_planes(fr, fi, wl2, dists, mask, cfg: Cfg):
    """Fused ASM propagation of P planes to D distances, cropped.

    Same arguments and result as :func:`propagate_planes_reference`.  CPU
    tensors take the plain version; CUDA tensors launch K1.
    """
    if fr.device.type == "cpu":
        return propagate_planes_reference(fr, fi, wl2, dists, mask, cfg)
    _, _, _, rp, cp, r0, rows, c0, cols = _check_cfg(cfg)
    g = torch.complex(fr.float(), fi.float())
    x = torch.fft.fft(F.pad(g, (c0, cp - cols - c0)), dim=-1)  # (P, rows, cp)
    y = row_pass(x, wl2, dists, mask, cfg)
    y = torch.fft.ifft(y, dim=-1)[..., c0 : c0 + cols]
    return y.real.contiguous(), y.imag.contiguous()


# launches of K1 (incremented only where the kernel is launched)
propagate_planes.launches = 0
