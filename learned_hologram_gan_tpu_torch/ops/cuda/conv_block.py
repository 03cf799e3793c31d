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
  launches inside: an implicit GEMM on ``wgmma`` with float32 accumulation
  fed by a ring of ``cp.async`` stages, in float32 as three TF32 products
  per product, split precision, in bfloat16 as one) or raises; a CPU
  tensor takes the plain version.
* :func:`supported` is K5's own predicate, from Hopper's limits (the
  kernel tiles over pixels and channels, so neither the weights nor the
  activations need to fit in shared memory whole), not the TPU's VMEM model.
* :func:`tiling` picks the kernel's tile and grid for a block shape and an
  element size; :func:`gemm_weights` lays a convolution's weights out as
  its GEMM matrix in the kernel's K order (:class:`Segment`),
  :func:`weight_tiles` that matrix as the kernel's stages hold it, and in
  float32 :func:`split_tf32` splits the tiles into their TF32 hi and lo.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn.blocks import BN_EPS, BatchNorm, full_f32_convs

KERNEL_NAME = "k5_residual_block"
# The kernel (conv_wgmma_kernel): a tile of GEMM_BM flattened output
# pixels (two consumer warpgroups of 64 rows) by 64, 128 or (bfloat16) 256
# output channels (tile_bn), K through shared memory in atoms of one
# 128-byte swizzled row (gemm_bk: 64 bfloat16, 32 float32 values),
# stage_atoms of them a stage (with B_hi and B_lo in float32), in a ring of
# ring_stages stages in RING_BYTES; one block of 384 threads (the consumers
# and a producer warpgroup) an SM.
GEMM_BM = 128
GEMM_BLOCKS_PER_SM = 1
RING_BYTES = 192 * 1024
_INT32_MAX = 2**31 - 1


def gemm_bk(itemsize: int) -> int:
    """K values of one atom, a 128-byte row: 64 bfloat16, 32 float32."""
    return 128 // itemsize


def b_split(itemsize: int) -> int:
    """B atoms a K atom takes: one in bfloat16; hi and lo in float32."""
    return 2 if itemsize == 4 else 1


@dataclasses.dataclass(frozen=True)
class Segment:
    """One convolution's part of the kernel's K: ``channels`` input
    channels at ``taps`` taps (9: a 3x3 conv; 1: the 1x1 shortcut, its
    centre tap).  K runs chunk by chunk, then tap by tap, then channel by
    channel: kk = chunk * kchunk + tap * width + ci reads channel
    chunk * width + ci.  ``width`` is one atom's channels (:func:`gemm_bk`),
    or all of them when there are fewer (the K step then spans taps:
    enc_0's 4 channels take 9 * 4 = 36 values, not 9 * 64); ``kchunk`` is
    taps * width padded to one wgmma's K (32 bytes: 16 bfloat16, 8 TF32
    values), ``kseg`` the chunks' K.  ``vec`` is the channels one copy
    moves: the largest power of two up to 16 bytes' worth that divides
    ``channels`` (16-byte copies where it is 16 bytes' worth; 2-byte loads
    where a bfloat16 count is odd)."""

    channels: int
    taps: int
    width: int
    kchunk: int
    kseg: int
    vec: int


def segment(channels: int, taps: int, itemsize: int) -> Segment:
    kstep, vmax = 32 // itemsize, 16 // itemsize
    width = min(channels, gemm_bk(itemsize))
    kchunk = -(-taps * width // kstep) * kstep
    vec = next(v for v in (8, 4, 2, 1) if v <= vmax and channels % v == 0)
    return Segment(channels, taps, width, kchunk, -(-channels // width) * kchunk, vec)


def segments(cin: int, cout: int, itemsize: int) -> Tuple[Segment, Tuple[Segment, Segment]]:
    """conv1's segment (x at 9 taps), and conv2's two: y1 at 9 taps, then
    the shortcut, x at its centre tap."""
    return segment(cin, 9, itemsize), (segment(cout, 9, itemsize), segment(cin, 1, itemsize))


def tile_bn(cout: int, itemsize: int) -> int:
    """The tile width: the widest of 64, 128 and 256 channels that cout
    fills; in float32 at most 128, whose consumers hold a stage's partial
    sums beside the tile's."""
    return 64 if cout <= 64 else (128 if cout <= 128 or itemsize == 4 else 256)


def stage_atoms(bn: int, ktot: int, itemsize: int) -> int:
    """K atoms a stage holds for a convolution of K ``ktot`` at tile width
    ``bn``.  bfloat16: two where the tile is at most 128 channels wide, so
    that a step's products outweigh its handshakes; one at 256, whose stage
    is large already, and where one atom holds all of K (enc_0's conv1).
    float32: one, whose 12 TF32 products already outweigh a handshake."""
    return 1 if itemsize == 4 or bn == 256 or ktot <= gemm_bk(itemsize) else 2


def ring_stages(bn: int, atoms: int, itemsize: int) -> int:
    """The ring's depth: as many stages (``atoms`` atoms of the A tile and
    of each B tile) as RING_BYTES of shared memory holds."""
    return RING_BYTES // (atoms * (GEMM_BM + b_split(itemsize) * bn) * 128)


@dataclasses.dataclass(frozen=True)
class Tiling:
    """The kernel's launch for one block shape: tiles of GEMM_BM pixels x
    ``bn`` channels, ``n_tiles`` fastest; a persistent grid of ``grid``
    blocks, block i taking tiles i, i + grid, ...; conv1's segment and
    conv2's two (its own, then the shortcut's)."""

    bn: int
    m_total: int
    m_tiles: int
    n_tiles: int
    grid: int
    conv1: Segment
    conv2: Tuple[Segment, Segment]

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    def ints(self) -> np.ndarray:
        """What the C entry reads (int32): bn, grid, then width, kchunk,
        kseg and vec of conv1's segment, conv2's and the shortcut's."""
        segs = (self.conv1,) + self.conv2
        return np.array([self.bn, self.grid] + [v for sg in segs
                                                for v in (sg.width, sg.kchunk, sg.kseg, sg.vec)],
                        dtype=np.int32)


def tiling(batch: int, h: int, w: int, cin: int, cout: int, sms: int, itemsize: int) -> Tiling:
    """The tile and grid of a (batch, h, w, cin) -> cout block of
    ``itemsize``-byte elements on a card of ``sms`` SMs: the widest tile
    that cout fills (:func:`tile_bn`; a wider tile reads each pixel's
    inputs fewer times: the stages' loads, not the products, bound the
    bfloat16 kernel), the flattened pixels in tiles of 128 (so a
    24 x 24 image wastes no column slots), and one persistent block per SM
    (or one per tile, if fewer), each walking its tiles so that a tile's
    epilogue overlaps the next one's loads."""
    bn = tile_bn(cout, itemsize)
    m_total = batch * h * w
    m_tiles, n_tiles = -(-m_total // GEMM_BM), -(-cout // bn)
    grid = min(m_tiles * n_tiles, sms * GEMM_BLOCKS_PER_SM)
    return Tiling(bn, m_total, m_tiles, n_tiles, grid, *segments(cin, cout, itemsize))


def gemm_weights(wt: torch.Tensor, sg: Segment) -> torch.Tensor:
    """HWIO weights (3, 3, cs, C) (taps 9) or (cs, C) (taps 1) as the
    kernel's (C, kseg) GEMM matrix in the segment's K order, zeros in the
    padding, contiguous."""
    c = wt.shape[-1]
    w = wt.reshape(sg.taps, sg.channels, c)
    chunks = sg.kseg // sg.kchunk
    w = F.pad(w, (0, 0, 0, chunks * sg.width - sg.channels))  # (taps, chunks * width, C)
    w = w.reshape(sg.taps, chunks, sg.width, c).permute(3, 1, 0, 2)  # (C, chunks, taps, width)
    w = w.reshape(c, chunks, sg.taps * sg.width)
    return F.pad(w, (0, sg.kchunk - sg.taps * sg.width)).reshape(c, sg.kseg).contiguous()


def weight_tiles(wm: torch.Tensor, bn: int, atoms: int, itemsize: int) -> torch.Tensor:
    """A (C, K) GEMM weight matrix as the kernel's B tiles, (n_tiles,
    atoms * steps, bn, bk), bk = :func:`gemm_bk`: atom (j, a) holds output
    channels j bn .. j bn + bn - 1 and K a bk .. + bk, zeros past C and
    past K (which pads to a whole step of ``atoms`` atoms), each row's
    16-byte chunk q (bk / 8 values) stored at q ^ (row % 8) (the 128-byte
    swizzle, as the kernel's producer stores A), so that one bulk copy of a
    step's atoms * bn * 128 bytes (twice that in float32, with
    :func:`split_tf32`'s lo) fills a stage's B."""
    bk = gemm_bk(itemsize)
    c, k = wm.shape
    n_tiles, n_atoms = -(-c // bn), -(-k // (atoms * bk)) * atoms
    w = F.pad(wm, (0, n_atoms * bk - k, 0, n_tiles * bn - c))
    w = w.reshape(n_tiles, bn, n_atoms, 8, bk // 8).permute(0, 2, 1, 3, 4)
    # chunk q of row n lands at q ^ (n % 8); the XOR is its own inverse
    src = torch.arange(8)[None, :] ^ (torch.arange(bn) % 8)[:, None]  # (bn, 8)
    w = w[:, :, torch.arange(bn)[:, None], src]
    return w.reshape(n_tiles, n_atoms, bn, bk).contiguous()


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``: half of the low 13 bits' range
    added to the magnitude, then those bits cleared."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` as two TF32 values, hi = rna(t) and lo = rna(t - hi),
    stacked after t's first two dimensions (a tile's step): t = hi + lo
    within 2^-22 |t|, and the kernel's three products hi hi, hi lo, lo hi
    of two split values are exact in float32."""
    hi = tf32_rna(t)
    return torch.stack([hi, tf32_rna(t - hi)], dim=2).contiguous()


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
    weights the wrapper's int32 gather index can address (9 C (Cin + C) +
    Cin C < 2^31; the persistent grid and the kernel's 64-bit pixel
    indices take any batch and image).  The shared memory per block is
    fixed whatever the channels (192 KB of stages plus 1 KB of alignment
    and barriers, of 227 KB), because the kernel loops over them."""
    if min(h, w, cin, cout) < 1:
        return False
    return 9 * cout * (cin + cout) + cin * cout < _INT32_MAX


# the C entry for each compute dtype
ENTRIES = {torch.float32: "k5_residual_block", torch.bfloat16: "k5_residual_block_bf16"}


@functools.lru_cache(maxsize=None)
def _kernel_fn(defines: Tuple[str, ...] = ()):
    """({dtype: C entry}, the error-string function) of the build with
    ``defines`` (the wrappers load the plain build; only k5_ablation.py
    asks for others)."""
    from .build import load_library

    lib = load_library(KERNEL_NAME, defines)
    fns = {}
    for dtype, name in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    err = lib.k5_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fns, err


def prepare(x, w1, b1, w2, b2, w3, b3):
    """Check a CUDA call's arguments and lay them out as the kernel takes
    them: x (B, H, W, Cin) in float32 or bfloat16, w1 (3, 3, Cin, C), w2
    (3, 3, C, C), w3 (Cin, C) in x's dtype, biases (C,) float32, all on
    x's device.  Returns (x, w1 tiles, b1, w2 tiles, b2, b3), contiguous:
    the weights as the kernel's B tiles (:func:`weight_tiles` of the
    :func:`gemm_weights` matrices), conv1's, and conv2's with the
    shortcut's K appended, in float32 split into TF32 hi and lo
    (:func:`split_tf32`).  Raises on anything K5 does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"K5 needs a CUDA tensor, got {x.device}")
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError("K5 is built for sm_90a (Hopper) only")
    if x.dtype not in ENTRIES or x.dim() != 4:
        raise ValueError(f"K5 takes float32 or bfloat16 NHWC input, got {x.dtype} "
                         f"{tuple(x.shape)}")
    _, h, w, cin = x.shape
    cout = w1.shape[-1]
    if not supported(h, w, cin, cout):
        raise ValueError(f"K5 does not support a ({h}, {w}, {cin}) -> {cout} block")
    if w3.dim() == 4:
        w3 = w3[0, 0]
    f32 = torch.float32
    want = {"w1": (w1, (3, 3, cin, cout), x.dtype), "w2": (w2, (3, 3, cout, cout), x.dtype),
            "w3": (w3, (cin, cout), x.dtype),
            "b1": (b1, (cout,), f32), "b2": (b2, (cout,), f32), "b3": (b3, (cout,), f32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"K5: {name} must be {dtype} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    idx1, idx2 = _tile_index(cin, cout, x.dtype.itemsize, x.device)
    zero = w1.new_zeros(1)
    t1 = torch.cat([zero, w1.reshape(-1)]).index_select(0, idx1.reshape(-1)).reshape(idx1.shape)
    t2 = torch.cat([zero, w2.reshape(-1), w3.reshape(-1)]).index_select(
        0, idx2.reshape(-1)).reshape(idx2.shape)
    if x.dtype == torch.float32:
        t1, t2 = split_tf32(t1), split_tf32(t2)
    return x.contiguous(), t1, b1.contiguous(), t2, b2.contiguous(), b3.contiguous()


@functools.lru_cache(maxsize=64)
def _tile_index(cin: int, cout: int, itemsize: int, device: torch.device):
    """Gather indices that lay the kernel's B tiles out (conv1's, and
    conv2's with the shortcut's K appended) from [0, w1 flat] and
    [0, w2 flat, w3 flat]: gemm_weights and weight_tiles only move and pad,
    so running them once on 1, 2, 3, ... (float64, exact) gives each tile
    element's source, 0 where they pad."""
    conv1, (conv2, shortcut) = segments(cin, cout, itemsize)
    bn = tile_bn(cout, itemsize)

    def positions(shape, start):
        n = int(np.prod(shape))
        return torch.arange(start, start + n, dtype=torch.float64).reshape(shape)

    n2 = 9 * cout * cout
    t1 = weight_tiles(gemm_weights(positions((3, 3, cin, cout), 1), conv1), bn,
                      stage_atoms(bn, conv1.kseg, itemsize), itemsize)
    t2 = weight_tiles(torch.cat([gemm_weights(positions((3, 3, cout, cout), 1), conv2),
                                 gemm_weights(positions((cin, cout), 1 + n2), shortcut)], dim=1),
                      bn, stage_atoms(bn, conv2.kseg + shortcut.kseg, itemsize), itemsize)
    return tuple(t.int().to(device) for t in (t1, t2))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(*args) -> torch.Tensor:
    """Launch K5 on the arguments from :func:`prepare` followed by ``y1``
    and ``out``, (B, H, W, C) buffers in x's dtype; returns ``out``."""
    *tensors, y1, out = args
    x = tensors[0]
    bsz, h, w, cin = x.shape
    fns, err_str = _kernel_fn()
    if y1.dtype != x.dtype or out.dtype != x.dtype:
        raise ValueError(f"K5: y1 and out must be {x.dtype}, got {y1.dtype} and {out.dtype}")
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    ints = tiling(bsz, h, w, cin, out.shape[-1], _sm_count(index), x.dtype.itemsize).ints()
    code = fns[x.dtype](
        *(t.data_ptr() for t in tensors), y1.data_ptr(), out.data_ptr(),
        bsz, h, w, cin, out.shape[-1], ints.ctypes.data, index,
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
