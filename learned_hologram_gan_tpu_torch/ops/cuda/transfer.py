"""Kernel K4: the transfer-stack apply, H computed on the fly.

Counterpart of ``learned_hologram_gan_tpu/ops/pallas/transfer.py``
(``apply_transfer_stack``, the ``pl.pallas_call`` at transfer.py:104):

  out[b, d, c] = g0[b, c] * exp(-2*pi*i * z_d * w[c]) * mask

for a (B, C, Rp, Cp) complex64 spectrum ``g0``, the (C, Rp, Cp) float32
w-grid of a plan (``asm._w_grid``, as ``asm.make_plan`` builds
``plan.w_grid``), the (Rp, Cp) float32 mask and (D,) float32 distances:
(B, D, C, Rp, Cp) complex64, with no H stack ever stored.

:func:`apply_transfer_stack_reference` is the plain version.
:func:`apply_transfer_stack` launches ``csrc/k4_transfer_stack.cu`` on
CUDA tensors or raises; CPU tensors take the plain version.  Like the JAX
function, it has no caller on the port's paths.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

KERNEL_NAME = "k4_transfer_stack"


def apply_transfer_stack_reference(g0, w_grid, mask, distances) -> torch.Tensor:
    """Plain version of :func:`apply_transfer_stack` (same arguments), with
    theta rounded as ``((-2*pi) * z) * w`` in float32 (transfer.py:124-133)."""
    sign = torch.tensor(np.float32(-2.0 * np.pi), device=w_grid.device)
    theta = (sign * distances.float())[:, None, None, None] * w_grid[None]
    h = torch.complex(torch.cos(theta), torch.sin(theta)) * mask
    return g0[:, None] * h[None]


@functools.lru_cache(maxsize=None)
def _kernel_fn(defines: Tuple[str, ...] = ()):
    """(the C entry, the error-string function) of the build with
    ``defines`` (the wrapper loads the plain build; only k5_ablation.py
    asks for others)."""
    from .build import load_library

    lib = load_library(KERNEL_NAME, defines)
    fn = lib.k4_transfer_stack
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    err = lib.k4_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def apply_transfer_stack(g0, w_grid, mask, distances) -> torch.Tensor:
    """(B, C, Rp, Cp) complex64 spectrum x (D,) distances -> (B, D, C, Rp, Cp)
    complex64 spectra, ``g0[:, None] * (exp(-2i*pi*z*w) * mask)`` with H
    computed in the kernel.  CPU tensors take the plain version."""
    if g0.device.type == "cpu":
        return apply_transfer_stack_reference(g0, w_grid, mask, distances)
    if g0.device.type != "cuda":
        raise ValueError(f"K4 needs a CUDA tensor, got {g0.device}")
    if torch.cuda.get_device_capability(g0.device) != (9, 0):
        raise RuntimeError("K4 is built for sm_90a (Hopper) only")
    if g0.dtype != torch.complex64 or g0.dim() != 4:
        raise ValueError(f"K4 takes complex64 (B, C, Rp, Cp), got {g0.dtype} {tuple(g0.shape)}")
    b, c, rp, cp = g0.shape
    d = distances.shape[0] if distances.dim() == 1 else -1
    for name, t, shape in (("w_grid", w_grid, (c, rp, cp)), ("mask", mask, (rp, cp)),
                           ("distances", distances, (d,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != g0.device:
            raise ValueError(f"K4: {name} must be float32 {shape} on {g0.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if d < 1 or rp * cp >= 2**31 or b * d * c >= 2**31:
        raise ValueError(f"K4 does not take B {b}, D {d}, C {c}, a {rp} x {cp} grid")
    g0, w_grid, mask, distances = (t.contiguous() for t in (g0, w_grid, mask, distances))
    out = torch.empty((b, d, c, rp, cp), dtype=torch.complex64, device=g0.device)
    fn, err_str = _kernel_fn()
    code = fn(
        g0.data_ptr(), w_grid.data_ptr(), mask.data_ptr(), distances.data_ptr(), out.data_ptr(),
        b, d, c, rp * cp, float(np.float32(-2.0 * np.pi)),
        g0.device.index if g0.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(g0.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"K4 launch failed: {err_str(code).decode()} ({code})")
    apply_transfer_stack.launches += 1
    return out


def reset_launch_counts() -> None:
    apply_transfer_stack.launches = 0


# launches of K4 (incremented only where it is launched)
reset_launch_counts()
