"""2-D FFT computed as batched matrix products (four-step Cooley-Tukey).

Counterpart of ``learned_hologram_gan_tpu/ops/mxu_fft.py``, the JAX
package's ``"mxu"`` FFT backend (:func:`..asm.set_fft_backend`).  The
length-N DFT along an axis is computed with the four-step algorithm

    N = N1 * N2,  x viewed as A[n1, n2]   (n = n1*N2 + n2)
    B = DFT_{N1} @ A            (columns transform, a batched GEMM)
    C = B * twiddle             (omega_N^{k1*n2}, elementwise)
    X = C @ DFT_{N2}^T          (rows transform, a batched GEMM)
    X[k1, k2] == FFT(x)[k2*N1 + k1]  (transposed digit order, undone by a
                                      reshape and a transpose)

Complex arithmetic is carried as separate float32 planes, four real
products per complex product (``torch.matmul``, full float32: the port
leaves ``torch.backends.cuda.matmul.allow_tf32`` at False).  The JAX
package computes these products outside any Pallas kernel (XLA GEMMs), so
the port leaves them to ``torch.matmul`` as well.  The DFT matrices and
twiddles are built in float64 and rounded to float32, as the JAX package
builds them.  An axis with no factor pair (a prime, or a length below 4)
falls back to ``torch.fft``, as the JAX package's falls back to ``jnp.fft``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch


def best_factor_pair(n: int) -> Optional[Tuple[int, int]]:
    """(N1, N2) with N1*N2 == n, both > 1, as near-square as possible."""
    for n1 in range(int(math.isqrt(n)), 1, -1):
        if n % n1 == 0:
            return n1, n // n1
    return None


@functools.lru_cache(maxsize=None)
def _dft_mats(n: int, inverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) of the n-point DFT matrix W[j, k] = exp(-+2*pi*i*j*k/n)."""
    j = np.arange(n)[:, None].astype(np.float64)
    k = np.arange(n)[None, :].astype(np.float64)
    theta = 2.0 * np.pi / n * (1.0 if inverse else -1.0) * j * k
    return np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddle(n1: int, n2: int, inverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) of omega_N^{+-k1*n2}, shape (n1, n2)."""
    n = n1 * n2
    k1 = np.arange(n1)[:, None].astype(np.float64)
    m2 = np.arange(n2)[None, :].astype(np.float64)
    theta = 2.0 * np.pi / n * (1.0 if inverse else -1.0) * k1 * m2
    return np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32)


def _cmatmul(ar, ai, br, bi, transpose_b: bool = False):
    """(ar + i*ai) @ (br + i*bi) (``b`` transposed if asked) as four float32
    products."""
    if transpose_b:
        br, bi = br.transpose(-1, -2), bi.transpose(-1, -2)
    rr = torch.matmul(ar, br) - torch.matmul(ai, bi)
    ri = torch.matmul(ar, bi) + torch.matmul(ai, br)
    return rr, ri


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


def _fft1_last(xr, xi, n1: int, n2: int, inverse: bool):
    """Length-(n1*n2) DFT along the LAST axis of (..., N) via four-step."""
    n = n1 * n2
    batch = xr.shape[:-1]
    ar = xr.reshape(*batch, n1, n2)
    ai = xi.reshape(*batch, n1, n2)
    w1r, w1i = (_const(m, xr) for m in _dft_mats(n1, inverse))
    w2r, w2i = (_const(m, xr) for m in _dft_mats(n2, inverse))
    twr, twi = (_const(m, xr) for m in _twiddle(n1, n2, inverse))

    # B[k1, n2] = sum_{n1} W1[k1, n1] * A[n1, n2], contracting A's n1 axis
    # with W1's second axis
    br, bi = _cmatmul(ar.transpose(-1, -2), ai.transpose(-1, -2), w1r, w1i, transpose_b=True)
    br, bi = br.transpose(-1, -2), bi.transpose(-1, -2)  # (..., k1, n2)
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    dr, di = _cmatmul(cr, ci, w2r, w2i)  # (..., k1, k2)
    # output index k = k2*n1 + k1
    dr = dr.transpose(-1, -2).reshape(*batch, n)
    di = di.transpose(-1, -2).reshape(*batch, n)
    if inverse:
        dr = dr / n
        di = di / n
    return dr, di


def _axis_plan(n: int) -> Optional[Tuple[int, int]]:
    if n < 4:
        return None
    return best_factor_pair(n)


def fft2_mxu(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """2-D (inverse) FFT over the last two axes as batched GEMMs; complex64
    in and out.  Falls back to ``torch.fft`` for an axis with no usable
    factorization (primes)."""
    rows, cols = x.shape[-2], x.shape[-1]
    plan_c = _axis_plan(cols)
    plan_r = _axis_plan(rows)
    if plan_c is None or plan_r is None:
        return torch.fft.ifft2(x) if inverse else torch.fft.fft2(x)
    xr = x.real.float()
    xi = x.imag.float()
    xr, xi = _fft1_last(xr, xi, *plan_c, inverse)
    xr, xi = _fft1_last(xr.transpose(-1, -2), xi.transpose(-1, -2), *plan_r, inverse)
    return torch.complex(xr.transpose(-1, -2), xi.transpose(-1, -2))


def ifft2_mxu(x: torch.Tensor) -> torch.Tensor:
    return fft2_mxu(x, inverse=True)
