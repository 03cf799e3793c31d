"""Kernel K5: the eval-mode residual block with its BatchNorms folded.

Counterpart of ``learned_hologram_gan_tpu/ops/pallas/conv_block.py``
(``fused_residual_block``, the ``pl.pallas_call`` at conv_block.py:223):

  relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2 + conv1x1(x, w3) + b3)

NHWC ``(B, H, W, Cin) -> (B, H, W, Cout)``, SAME padding, float32
accumulation; ``w1`` (3, 3, Cin, C), ``w2`` (3, 3, C, C), ``w3`` (Cin, C)
or (1, 1, Cin, C), biases (C,): the JAX package's layouts.  The compute
dtype is ``x``'s, float32 or bfloat16: the weights go in cast to it, the
biases stay float32, and in bfloat16 the kernel rounds y1 once between the
two convolutions and the output once at the end, as the JAX kernel does
(conv_block.py:138, :169).

* :func:`fold_conv_bn` folds an eval-mode :class:`~..nn.blocks.BatchNorm`
  into the convolution before it (exact at eval time).
* :func:`residual_block_reference` is the plain version: cuDNN convolutions
  with TF32 off (``full_f32_convs``), in bfloat16 as the JAX reference
  (conv_block.py:244-266) rounds: each conv output in bfloat16, its bias
  cast to bfloat16 and added there.
* :func:`fused_residual_block` is K5's wrapper: on a CUDA tensor it
  launches ``csrc/k5_residual_block.cu`` (one C entry per block, two kernel
  launches inside; a float32 entry on the SIMT cores and a bfloat16 entry
  on the tensor cores, ``mma.sync`` with float32 accumulation) or raises; a
  CPU tensor takes the plain version.
* :func:`supported` is K5's own predicate, from Hopper's limits (the
  kernel tiles over pixels and channels, so neither the weights nor the
  activations need to fit in shared memory whole), not the TPU's VMEM model.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.blocks import BN_EPS, BatchNorm, full_f32_convs

KERNEL_NAME = "k5_residual_block"
# the kernel's tile (csrc/k5_residual_block.cu): 8 x 32 pixels x 64 channels
TILE_ROWS, TILE_COLS, TILE_N = 8, 32, 64
_MAX_GRID_YZ = 65535
_MAX_GRID_X = 2**31 - 1


def fold_conv_bn(conv: nn.Conv2d, bn: BatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an eval-mode BatchNorm into the preceding conv (exact).

    bn(conv(x, W) + b) == conv(x, W * s) + (b - mean) * s + beta, with
    s = scale * rsqrt(var + eps) from the running statistics.  Returns
    (W_folded (kh, kw, Cin, Cout), b_folded (Cout,)), float32.
    """
    w = conv.weight.detach().float().permute(2, 3, 1, 0)  # OIHW -> HWIO
    b = conv.bias.detach().float()
    s = bn.weight.detach().float() * torch.rsqrt(bn.running_var.float() + BN_EPS)
    return w * s, (b - bn.running_mean.float()) * s + bn.bias.detach().float()


def _oihw(k: torch.Tensor) -> torch.Tensor:
    if k.dim() == 2:
        k = k[None, None]
    return k.permute(3, 2, 0, 1)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, padding: int) -> torch.Tensor:
    """conv(x, w) + b in x's dtype; below float32 the output rounds before
    the bias adds, as XLA's conv + add does."""
    dt = x.dtype
    if dt == torch.float32:
        return F.conv2d(x, _oihw(w).float(), b.float(), padding=padding)
    return F.conv2d(x, _oihw(w).to(dt), padding=padding) + b.to(dt)[:, None, None]


def residual_block_reference(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Plain version of :func:`fused_residual_block` (same arguments):
    ``F.conv2d`` on the NCHW view in x's dtype, TF32 off."""
    xc = x.permute(0, 3, 1, 2)
    with full_f32_convs():
        y = F.relu(_conv(xc, w1, b1, 1))
        y = _conv(y, w2, b2, 1)
        sc = _conv(xc, w3, b3, 0)
    return F.relu(y + sc).permute(0, 2, 3, 1).contiguous()


def supported(h: int, w: int, cin: int, cout: int) -> bool:
    """True if K5 runs a block of these sizes: any positive sizes whose
    launch grid fits (pixel tiles < 2^31, channel tiles <= 65535).  The
    shared memory per block is fixed (59 KB of 227 KB), whatever the
    channels, because the kernel loops over them in chunks."""
    if min(h, w, cin, cout) < 1:
        return False
    tiles = -(-h // TILE_ROWS) * -(-w // TILE_COLS)
    return tiles <= _MAX_GRID_X and -(-cout // TILE_N) <= _MAX_GRID_YZ


# the C entry for each compute dtype
ENTRIES = {torch.float32: "k5_residual_block", torch.bfloat16: "k5_residual_block_bf16"}


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """({dtype: C entry}, the error-string function)."""
    from .build import load_library

    lib = load_library(KERNEL_NAME)
    fns = {}
    for dtype, name in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    err = lib.k5_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fns, err


def prepare(x, w1, b1, w2, b2, w3, b3):
    """Check a CUDA call's arguments and lay them out as the kernel takes
    them: x (B, H, W, Cin), w1 (9, Cin, C), w2 (9, C, C), w3 (Cin, C) in x's
    dtype (float32 or bfloat16), biases (C,) float32, all contiguous on x's
    device; in bfloat16 the weights go with their input channels last, as
    the tensor-core kernel reads them (w1 (9, C, Cin), w2 (9, C, C), w3
    (C, Cin)).  Raises on anything K5 does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"K5 needs a CUDA tensor, got {x.device}")
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError("K5 is built for sm_90a (Hopper) only")
    if x.dtype not in ENTRIES or x.dim() != 4:
        raise ValueError(f"K5 takes float32 or bfloat16 NHWC input, got {x.dtype} "
                         f"{tuple(x.shape)}")
    bsz, h, w, cin = x.shape
    cout = w1.shape[-1]
    if not supported(h, w, cin, cout) or bsz > _MAX_GRID_YZ:
        raise ValueError(f"K5 does not support a ({bsz}, {h}, {w}, {cin}) -> {cout} block")
    if w3.dim() == 4:
        w3 = w3[0, 0]
    f32 = torch.float32
    want = {"w1": (w1, (3, 3, cin, cout), x.dtype), "w2": (w2, (3, 3, cout, cout), x.dtype),
            "w3": (w3, (cin, cout), x.dtype),
            "b1": (b1, (cout,), f32), "b2": (b2, (cout,), f32), "b3": (b3, (cout,), f32)}
    out = []
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"K5: {name} must be {dtype} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        out.append(t.contiguous())
    w1, w2, w3, b1, b2, b3 = out
    w1, w2 = w1.reshape(9, cin, cout), w2.reshape(9, cout, cout)
    if x.dtype == torch.bfloat16:
        w1, w2, w3 = (w.transpose(-1, -2).contiguous() for w in (w1, w2, w3))
    return (x.contiguous(), w1, b1, w2, b2, w3, b3)


def launch(x, w1, b1, w2, b2, w3, b3, y1, out) -> torch.Tensor:
    """Launch K5 on arguments from :func:`prepare`, with ``y1`` and ``out``
    (B, H, W, C) buffers in x's dtype; returns ``out``."""
    bsz, h, w, cin = x.shape
    fns, err_str = _kernel_fn()
    if y1.dtype != x.dtype or out.dtype != x.dtype:
        raise ValueError(f"K5: y1 and out must be {x.dtype}, got {y1.dtype} and {out.dtype}")
    code = fns[x.dtype](
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), y1.data_ptr(), out.data_ptr(),
        bsz, h, w, cin, out.shape[-1],
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"K5 launch failed: {err_str(code).decode()} ({code})")
    fused_residual_block.launches += 1
    return out


def fused_residual_block(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """relu(conv3x3(relu(conv3x3(x, w1)+b1), w2)+b2 + conv1x1(x, w3)+b3).

    x: (B, H, W, Cin); w1 (3, 3, Cin, C); w2 (3, 3, C, C); w3 (Cin, C) or
    (1, 1, Cin, C); biases (C,).  SAME padding, stride 1: the eval-mode
    ``ResidualBlock`` with its BatchNorms folded by :func:`fold_conv_bn`.
    x's dtype is the compute dtype: the weights are cast to it and the
    biases to float32, as the JAX wrapper casts them.  A CPU tensor takes
    :func:`residual_block_reference`; a CUDA tensor launches K5 or raises.
    """
    if x.device.type == "cpu":
        return residual_block_reference(x, w1, b1, w2, b2, w3, b3)
    w1, w2, w3 = (w.to(x.dtype) for w in (w1, w2, w3))
    b1, b2, b3 = (b.float() for b in (b1, b2, b3))
    args = prepare(x, w1, b1, w2, b2, w3, b3)
    y1 = torch.empty(x.shape[:3] + (w1.shape[-1],), dtype=x.dtype, device=x.device)
    return launch(*args, y1, torch.empty_like(y1))


def reset_launch_counts() -> None:
    fused_residual_block.launches = 0


# launches of K5, one per C entry (incremented only where it is launched)
reset_launch_counts()
