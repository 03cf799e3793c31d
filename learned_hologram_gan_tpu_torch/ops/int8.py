"""Exact int8 x int8 -> int32 products for the quantized UNet (``nn/quant.py``).

The JAX package computes its int8 convolutions with XLA's
``conv_general_dilated`` / ``dot_general`` at ``preferred_element_type=int32``
(``nn/quant.py:214-243, 424-444``), outside any Pallas kernel.  Here every
product is an im2col of the int8 codes followed by ``torch._int_mm`` (int8 x
int8 -> int32; cuBLASLt's int8 GEMM on a CUDA tensor), on both devices:

* a float convolution would not be exact: at levels 4 / base 64, dec_3's
  first conv sums 9 * 1024 products of up to 127^2, ~1.5e8, past float32's
  2^24;
* ``F.conv2d`` on int8 tensors returns int8 on the CPU and wraps, and
  cuDNN offers PyTorch no int8 convolution.

``torch._int_mm`` on a CUDA tensor takes M > 16 rows and K, N multiples of
8, and cuBLASLt's int8 GEMM a row-major first operand only with a
column-major second one.  :func:`matmul` pads every product to those
sizes, zero codes in K and zero weight columns in N (exact: they add
nothing), in those layouts, on both devices, so that the CPU runs the
shapes and layouts the card runs; a product the card still refuses raises
from ``torch._int_mm``.  :func:`conv2d` chunks its im2col
over the batch so that one chunk's columns stay under :data:`IM2COL_BYTES`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: the most bytes of im2col columns :func:`conv2d` builds at once
IM2COL_BYTES = 1 << 30
#: ``torch._int_mm``'s CUDA shape rules: rows above MIN_ROWS, K and N
#: multiples of ALIGN
MIN_ROWS, ALIGN = 17, 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_weight(wmat: torch.Tensor) -> torch.Tensor:
    """An int8 (K, N) weight matrix zero-padded to K and N multiples of 8,
    in column-major order (strides (1, K)): cuBLASLt's int8 GEMM takes a
    row-major first operand only with a column-major second one, and
    reports any other pairing as not supported."""
    k, n = wmat.shape
    kp, np_ = _round_up(k, ALIGN), _round_up(n, ALIGN)
    if (kp, np_) != (k, n):
        wmat = F.pad(wmat, (0, np_ - n, 0, kp - k))
    return wmat.t().contiguous().t()


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact (M, K) int8 x (K, N) int8 -> (M, N) int32 through
    ``torch._int_mm``, padded to its CUDA shape rules and sliced back, ``a``
    row-major and ``b`` column-major.  ``b`` may come padded already
    (:func:`pad_weight`): its extra rows meet zero columns of ``a``."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {a.dtype} and {b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    if b.shape[0] < k:
        raise ValueError(f"inner sizes differ: ({m}, {k}) x {tuple(b.shape)}")
    bp = pad_weight(b)
    kp = bp.shape[0]
    mp = max(m, MIN_ROWS)
    if kp != k or mp != m:
        a = F.pad(a, (0, kp - k, 0, mp - m))
    out = torch._int_mm(a.contiguous(), bp)
    matmul.launches += 1
    return out[:m, :n]


# calls of torch._int_mm (incremented only where it is called)
matmul.launches = 0


def im2col(x: torch.Tensor, ksize: int, k_cols: int) -> torch.Tensor:
    """The (N * H * W, k_cols) "SAME" patch matrix of NHWC int8 codes for a
    ``ksize`` x ``ksize`` window, columns in (kh, kw, cin) order (the HWIO
    kernel's rows), then zero columns up to ``k_cols``.  Code 0 is the
    value 0, so the zero border is SAME's zero padding."""
    n, h, w, c = x.shape
    r = ksize // 2
    xp = F.pad(x, (0, 0, r, r, r, r)) if r else x
    views = [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(ksize) for dx in range(ksize)]
    extra = k_cols - ksize * ksize * c
    if extra:
        views.append(x.new_zeros(n, h, w, extra))
    return torch.cat(views, dim=-1).reshape(n * h * w, k_cols)


def conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact "SAME" stride-1 convolution of NHWC int8 codes ``x`` by an
    HWIO int8 kernel ``w`` (3x3 or 1x1) -> NHWC int32 accumulators, as
    XLA's ``conv_general_dilated(..., preferred_element_type=int32)``."""
    kh, kw, cin, cout = w.shape
    if kh != kw or kh % 2 == 0:
        raise ValueError(f"odd square kernels only, got {kh}x{kw}")
    if x.shape[-1] != cin:
        raise ValueError(f"input has {x.shape[-1]} channels, the kernel {cin}")
    n, h, wd, _ = x.shape
    wmat = pad_weight(w.reshape(kh * kw * cin, cout))
    k_cols = wmat.shape[0]
    step = max(1, IM2COL_BYTES // max(1, h * wd * k_cols))
    outs = [matmul(im2col(x[i:i + step], kh, k_cols), wmat)[:, :cout].reshape(-1, h, wd, cout)
            for i in range(0, n, step)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 "VALID" max pool of NHWC int8 codes (the JAX
    package's ``reduce_window`` max): the pooled tensor's own codes."""
    n, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
