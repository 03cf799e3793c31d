"""Kernel K3: the one-axis FFT, and ``fft2``/``ifft2`` built on it.

Counterpart of ``learned_hologram_gan_tpu/ops/pallas/spectral.py:_dft_pass``
(the ``pl.pallas_call`` at spectral.py:320) as ``fft2_pallas`` /
``ifft2_pallas`` (:362-391) use it: a 2-D transform over the last two axes
is two one-axis passes (axis -1, then axis -2), each a launch of
``csrc/k3_fft.cu`` on a CUDA tensor.

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
from typing import Optional

import numpy as np
import torch

KERNEL_NAME = "k3_fft"
# dynamic shared memory a Hopper block may use (227 KB)
_SMEM_LIMIT = 232448


def _smem_bytes(n: int, tl: int) -> int:
    return (n * tl + n // 2) * 8


def _pick_tl(n: int, lines: int) -> Optional[int]:
    # the most lines per block that divide `lines` and fit: at n = 1024 an
    # 8-line block takes 68 KB, three to an SM
    for tl in (8, 4, 2, 1):
        if lines % tl == 0 and _smem_bytes(n, tl) <= _SMEM_LIMIT:
            return tl
    return None


def supported_length(n: int) -> bool:
    """True if K3 transforms lines of length ``n``: a power of two whose
    single-line block fits in shared memory."""
    return n >= 2 and n & (n - 1) == 0 and _smem_bytes(n, 1) <= _SMEM_LIMIT


def supported(rows: int, cols: int) -> bool:
    """True if K3 runs a 2-D transform of (rows, cols) planes."""
    return supported_length(rows) and supported_length(cols)


def fft_axis_reference(x: torch.Tensor, axis: int, inverse: bool, scale: float) -> torch.Tensor:
    """Plain version of :func:`fft_axis`: ``scale`` times the unnormalised
    (inverse) DFT of complex ``x`` along ``axis`` (-1 or -2)."""
    fn = torch.fft.ifft if inverse else torch.fft.fft
    return fn(x, dim=axis, norm="forward" if inverse else "backward") * scale


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """(n/2,) complex64 table of exp(2*pi*i*k/n), computed in float64."""
    k = np.arange(n // 2, dtype=np.float64)
    return torch.from_numpy(np.exp(2j * np.pi * k / n).astype(np.complex64)).to(device)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from .build import load_library

    lib = load_library(KERNEL_NAME)
    fn = lib.k3_fft_axis
    fn.argtypes = (
        [ctypes.c_void_p] * 3
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
    n, lines = (cols, rows) if axis == -1 else (rows, cols)
    if not supported_length(n):
        raise ValueError(f"K3 does not support length {n}")
    planes = x.numel() // (rows * cols)
    if planes > 65535:
        raise ValueError(f"K3 takes at most 65535 planes, got {planes}")
    x = x.contiguous()
    y = torch.empty_like(x)
    fn, err_str = _kernel_fn()
    code = fn(
        x.data_ptr(), y.data_ptr(), _twiddles(n, x.device).data_ptr(),
        planes, rows, cols, int(axis == -1), _pick_tl(n, lines), int(inverse),
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
