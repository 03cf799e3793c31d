"""Kernel K3: the one-axis FFT, and ``fft2``/``ifft2`` built on it.

Counterpart of ``learned_hologram_gan_tpu/ops/pallas/spectral.py:_dft_pass``
(the ``pl.pallas_call`` at spectral.py:320) as ``fft2_pallas`` /
``ifft2_pallas`` (:362-391) use it: a 2-D transform over the last two axes
is two one-axis passes (axis -1, then axis -2), each a launch of
``csrc/k3_fft.cu`` on a CUDA tensor, the register-resident FFT of
``csrc/fft_hopper.cuh`` with the plan of :mod:`.fft_plan`.

:func:`fft2` and :func:`ifft2` are ``torch.autograd.Function``s on complex
tensors with torch's (conjugate Wirtinger) convention: the backward of the
unnormalised ``fft2`` over N points is ``N * ifft2(g)``, the unnormalised
inverse transform, and that of ``ifft2`` is ``fft2(g) / N``, what
``torch.fft``'s own autograd does.  (The JAX package's ``_fft2_bwd`` returns
``fft2(g)``, which is right only under JAX's cotangent convention.)  On CPU
tensors forward and backward run the plain version, :func:`fft_axis_reference`
(``torch.fft``); grids that :func:`supported` rejects go to ``torch.fft``
directly, as the JAX package's ``_fft2_impl`` goes to ``jnp.fft``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import fft_plan

KERNEL_NAME = "k3_fft"


def _pick_lpb(plan: fft_plan.FftPlan, columns: bool) -> Optional[int]:
    """Lines per block: along axis -1 blocks of 128 threads or one line
    (within ``plan.line_threads``); along axis -2 at least 8 interleaved
    columns (64-byte row segments) where they fit.  At n = 1024 that is 4
    lines (34 KB) along axis -1 and 8 columns (68 KB) along -2."""
    if columns:
        return fft_plan.k3_columns(plan)
    return fft_plan.lines_per_block(plan, 1, plan.buffer * 8, plan.line_threads)


@functools.lru_cache(maxsize=None)
def supported_length(n: int) -> bool:
    """True if K3 transforms lines of length ``n``: n = 2^a 3^b 5^c from 2
    to 16384 that has a plan (:func:`.fft_plan.make_plan`; every power of
    two has one) whose block fits along either axis."""
    try:
        plan = fft_plan.make_plan(n)
    except ValueError:
        return False
    return _pick_lpb(plan, False) is not None and _pick_lpb(plan, True) is not None


def supported(rows: int, cols: int) -> bool:
    """True if K3 runs a 2-D transform of (rows, cols) planes."""
    return supported_length(rows) and supported_length(cols)


def fft_axis_reference(x: torch.Tensor, axis: int, inverse: bool, scale: float) -> torch.Tensor:
    """Plain version of :func:`fft_axis`: ``scale`` times the unnormalised
    (inverse) DFT of complex ``x`` along ``axis`` (-1 or -2)."""
    fn = torch.fft.ifft if inverse else torch.fft.fft
    return fn(x, dim=axis, norm="forward" if inverse else "backward") * scale


@functools.lru_cache(maxsize=None)
def _kernel_fn(defines: Tuple[str, ...] = ()):
    from .build import load_library

    lib = load_library(KERNEL_NAME, defines)
    fn = lib.k3_fft_axis
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    err = lib.k3_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def fft_axis(x: torch.Tensor, axis: int, inverse: bool, scale: float) -> torch.Tensor:
    """Launch K3: ``scale`` times the unnormalised (inverse) DFT of complex64
    ``x`` (..., R, C) along ``axis`` (-1 or -2).  CUDA tensors only."""
    if x.device.type != "cuda":
        raise ValueError(f"K3 needs a CUDA tensor, got {x.device}")
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError("K3 is built for sm_90a (Hopper) only")
    if x.dtype != torch.complex64 or x.dim() < 2:
        raise ValueError(f"K3 takes complex64 (..., R, C), got {x.dtype} {tuple(x.shape)}")
    if axis not in (-1, -2):
        raise ValueError(f"K3 transforms axis -1 or -2, not {axis}")
    rows, cols = x.shape[-2], x.shape[-1]
    n = cols if axis == -1 else rows
    if not supported_length(n):
        raise ValueError(f"K3 does not support length {n}")
    planes = x.numel() // (rows * cols)
    if planes > 65535:
        raise ValueError(f"K3 takes at most 65535 planes, got {planes}")
    x = x.contiguous()
    y = torch.empty_like(x)
    plan, ints, tw = fft_plan.device_plan(n, x.device)
    fn, err_str = _kernel_fn(fft_plan.build_defines(plan))
    code = fn(
        x.data_ptr(), y.data_ptr(), tw.data_ptr(), ints.ctypes.data,
        planes, rows, cols, int(axis == -1), _pick_lpb(plan, axis == -2), int(inverse),
        float(scale),
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"K3 launch failed: {err_str(code).decode()} ({code})")
    fft_axis.launches += 1
    return y


# launches of K3 (incremented only where the kernel is launched)
fft_axis.launches = 0


def _transform2(x: torch.Tensor, inverse: bool, scale: float) -> torch.Tensor:
    """``scale`` times the unnormalised 2-D (inverse) DFT over the last two
    axes, as two one-axis passes, the scale applied once."""
    one = fft_axis if x.device.type == "cuda" else fft_axis_reference
    return one(one(x, -1, inverse, 1.0), -2, inverse, scale)


class _FFT2(torch.autograd.Function):
    """Forward: ``fft2`` (``inverse=False``) or ``ifft2`` over the last two
    axes.  Backward: the adjoint, under torch's complex convention."""

    @staticmethod
    def forward(ctx, x, inverse):
        ctx.inverse = inverse
        n = x.shape[-2] * x.shape[-1]
        return _transform2(x, inverse, 1.0 / n if inverse else 1.0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        n = g.shape[-2] * g.shape[-1]
        # adjoint of F is conj(F) (the unnormalised inverse); of conj(F)/N, F/N
        if ctx.inverse:
            return _transform2(g, False, 1.0 / n), None
        return _transform2(g, True, 1.0), None


def fft2(x: torch.Tensor) -> torch.Tensor:
    """2-D FFT over the last two axes of complex64 ``x``; differentiable."""
    if not supported(x.shape[-2], x.shape[-1]):
        return torch.fft.fft2(x)
    return _FFT2.apply(x, False)


def ifft2(x: torch.Tensor) -> torch.Tensor:
    """2-D inverse FFT over the last two axes of complex64 ``x``;
    differentiable."""
    if not supported(x.shape[-2], x.shape[-1]):
        return torch.fft.ifft2(x)
    return _FFT2.apply(x, True)
