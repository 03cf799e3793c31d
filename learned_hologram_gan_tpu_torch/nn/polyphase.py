"""Polyphase (space-to-depth) convolution primitives, NHWC (counterpart of
``learned_hologram_gan_tpu/nn/polyphase.py``, plain PyTorch: the JAX package
runs them in XLA, with no kernel of their own).

The UNet's level 0 can be computed exactly in the (H/2, W/2, 4C) phase
domain, phase-major channel layout ``ch = (di*2 + dj)*C + c``:

- a 3x3 SAME conv is four phase-aligned 2x2 convs over 4*Cin channels:
  output phase (do, dj) draws input rows 2i+do+u = 2(i+p)+q with
  q = (do+u) mod 2 and p = floor((do+u)/2) in {do-1, do}, a 2-tap window
  with asymmetric SAME padding ((1-do, do), (1-dj, dj)); each original tap
  lands in exactly one of the 2x2x4 kernel slots;
- the 2x2/stride-2 max-pool is a max over the 4 phases;
- the 2x2/stride-2 up-conv GEMM emits phase-major columns, so its pixel
  shuffle vanishes;
- 1x1 convs and every elementwise op apply per phase.

Kernels are in the JAX package's layouts: 3x3 (3, 3, Cin, Cout), 1x1
(..., Cin, Cout), the up-conv (2, 2, Cin, Cout) as ``lax.conv_transpose``
applies it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C), phase-major: ch = (di*2+dj)*C + c."""
    n, h, w, c = x.shape
    y = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h // 2, w // 2, 4 * c)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    n, h2, w2, c4 = y.shape
    c = c4 // 4
    y = y.reshape(n, h2, w2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * h2, 2 * w2, c)


def tile4(b: torch.Tensor) -> torch.Tensor:
    """Per-channel vector -> phase-major 4C layout (same value every phase)."""
    return b.repeat(4)


def poly_conv3x3(x4: torch.Tensor, k: torch.Tensor, b=None) -> torch.Tensor:
    """Exact 3x3 SAME conv in the phase domain.

    ``x4`` (N, h, w, 4*Cin) phase-major; ``k`` (3, 3, Cin, Cout) the original
    spatial kernel; ``b`` optional (Cout,) bias.
    """
    cin, cout = k.shape[2], k.shape[3]
    xc = x4.permute(0, 3, 1, 2)
    outs = []
    for do in (0, 1):
        for dj in (0, 1):
            kp = k.new_zeros((2, 2, 4, cin, cout))
            for u in (-1, 0, 1):
                qi = (do + u) % 2
                pi = (do + u) // 2 - (do - 1)
                for v in (-1, 0, 1):
                    qj = (dj + v) % 2
                    pj = (dj + v) // 2 - (dj - 1)
                    kp[pi, pj, qi * 2 + qj] = k[u + 1, v + 1]
            weight = kp.reshape(2, 2, 4 * cin, cout).permute(3, 2, 0, 1).to(x4.dtype)
            outs.append(F.conv2d(F.pad(xc, (1 - dj, dj, 1 - do, do)), weight))
    y = torch.stack(outs, dim=-1)  # (n, cout, h, w, 4)
    y = y.permute(0, 2, 3, 4, 1).reshape(x4.shape[0], x4.shape[1], x4.shape[2], 4 * cout)
    if b is not None:
        y = y + tile4(b).to(y.dtype)
    return y


def poly_conv1x1(x4: torch.Tensor, k: torch.Tensor, b=None) -> torch.Tensor:
    """1x1 conv applied per phase: (N, h, w, 4Cin) -> (N, h, w, 4Cout)."""
    n, h, w, _ = x4.shape
    cin, cout = k.shape[-2], k.shape[-1]
    y = x4.reshape(n, h, w, 4, cin) @ k.reshape(cin, cout).to(x4.dtype)
    y = y.reshape(n, h, w, 4 * cout)
    if b is not None:
        y = y + tile4(b).to(y.dtype)
    return y


def poly_upconv_gemm(x: torch.Tensor, kernel: torch.Tensor, bias=None) -> torch.Tensor:
    """2x up-conv GEMM with the output kept phase-major (no pixel shuffle).

    ``kernel`` (2, 2, Cin, Cout) as ``lax.conv_transpose`` applies it (taps
    flipped); the flipped, transposed weight matrix's columns are ordered
    (di*2+dj)*Cout + co, exactly the phase-major layout.
    """
    cin, cout = kernel.shape[-2], kernel.shape[-1]
    wmat = kernel.flip(0, 1).permute(2, 0, 1, 3).reshape(cin, 4 * cout)
    y = x @ wmat.to(x.dtype)
    if bias is not None:
        y = y + tile4(bias).to(x.dtype)
    return y


def poly_concat(a4: torch.Tensor, b4: torch.Tensor) -> torch.Tensor:
    """Channel concat in the phase domain (per-phase interleaved layout)."""
    n, h, w, ca = a4.shape
    cb = b4.shape[-1]
    a = a4.reshape(n, h, w, 4, ca // 4)
    b = b4.reshape(n, h, w, 4, cb // 4)
    return torch.cat([a, b], dim=-1).reshape(n, h, w, ca + cb)


def poly_pool(x4: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool == max over the 4 phases, back to standard."""
    n, h, w, c4 = x4.shape
    return x4.reshape(n, h, w, 4, c4 // 4).amax(dim=3)
