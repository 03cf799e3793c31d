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
  on the tensor cores, an implicit GEMM on ``wgmma`` with float32
  accumulation fed by a ring of ``cp.async`` stages) or raises; a CPU
  tensor takes the plain version.
* :func:`supported` is K5's own predicate, from Hopper's limits (the
  kernel tiles over pixels and channels, so neither the weights nor the
  activations need to fit in shared memory whole), not the TPU's VMEM model.
* :func:`bf16_tiling` picks the bfloat16 kernel's tile and grid for a
  block shape; :func:`gemm_weights` lays a convolution's weights out as
  its GEMM matrix in the kernel's K order (:class:`Segment`), and
  :func:`weight_tiles` that matrix as the kernel's stages hold it.
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
# the float32 kernel's tile (csrc/k5_residual_block.cu): 8 x 32 pixels x 64 channels
TILE_ROWS, TILE_COLS, TILE_N = 8, 32, 64
_MAX_GRID_YZ = 65535
_MAX_GRID_X = 2**31 - 1
# the bfloat16 kernel's (conv_wgmma_kernel): a tile of BF16_BM flattened
# output pixels (two consumer warpgroups of 64 rows) by 64, 128 or 256
# output channels (bf16_bn), K through shared memory in atoms of BF16_BK
# (one 128-byte swizzled row of bf16), bf16_atoms of them a stage, in a
# ring of bf16_stages stages; one block of 384 threads (the consumers and
# a producer warpgroup) an SM
BF16_BM, BF16_BK = 128, 64
BF16_BLOCKS_PER_SM = 1


@dataclasses.dataclass(frozen=True)
class Segment:
    """One convolution's part of the bfloat16 kernel's K: ``channels``
    input channels at ``taps`` taps (9: a 3x3 conv; 1: the 1x1 shortcut,
    its centre tap).  K runs chunk by chunk, then tap by tap, then channel
    by channel: kk = chunk * kchunk + tap * width + ci reads channel
    chunk * width + ci.  ``width`` is 64 channels, or all of them when
    there are fewer (the K step then spans taps: enc_0's 4 channels take
    9 * 4 = 36 values, not 9 * 64); ``kchunk`` is taps * width padded to a
    multiple of 16 (one wgmma's K), ``kseg`` the chunks' K.  ``vec`` is the
    channels one copy moves: the largest power of two up to 8 that divides
    ``channels`` (16-byte copies where it is 8; 2-byte loads where the
    count is odd)."""

    channels: int
    taps: int
    width: int
    kchunk: int
    kseg: int
    vec: int


def segment(channels: int, taps: int) -> Segment:
    width = min(channels, BF16_BK)
    kchunk = -(-taps * width // 16) * 16
    vec = next(v for v in (8, 4, 2, 1) if channels % v == 0)
    return Segment(channels, taps, width, kchunk, -(-channels // width) * kchunk, vec)


def bf16_segments(cin: int, cout: int) -> Tuple[Segment, Tuple[Segment, Segment]]:
    """conv1's segment (x at 9 taps), and conv2's two: y1 at 9 taps, then
    the shortcut, x at its centre tap."""
    return segment(cin, 9), (segment(cout, 9), segment(cin, 1))


def bf16_bn(cout: int) -> int:
    """The bfloat16 kernel's tile width: the widest of 64, 128 and 256
    channels that cout fills."""
    return 64 if cout <= 64 else (128 if cout <= 128 else 256)


def bf16_atoms(bn: int, ktot: int) -> int:
    """K atoms of BF16_BK a stage holds for a convolution of K ``ktot`` at
    tile width ``bn``: two where the tile is at most 128 channels wide, so
    that a step's products outweigh its handshakes; one at 256, whose stage
    is large already, and where one atom holds all of K (enc_0's conv1)."""
    return 1 if bn == 256 or ktot <= BF16_BK else 2


def bf16_stages(bn: int, atoms: int) -> int:
    """The ring's depth: as many stages (``atoms`` atoms of the A and the B
    tile each) as 192 KB of shared memory holds."""
    return (192 * 1024) // (atoms * (BF16_BM + bn) * BF16_BK * 2)


@dataclasses.dataclass(frozen=True)
class Bf16Tiling:
    """The bfloat16 kernel's launch for one block shape: tiles of BF16_BM
    pixels x ``bn`` channels, ``n_tiles`` fastest; a persistent grid of
    ``grid`` blocks, block i taking tiles i, i + grid, ...; conv1's segment
    and conv2's two (its own, then the shortcut's)."""

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


def bf16_tiling(batch: int, h: int, w: int, cin: int, cout: int, sms: int) -> Bf16Tiling:
    """The tile and grid of a (batch, h, w, cin) -> cout block on a card of
    ``sms`` SMs: the widest of 64, 128 and 256 channels a tile that cout
    fills (a wider tile reads each pixel's inputs fewer times: the stages'
    loads, not the products, bound the kernel), the flattened pixels in
    tiles of 128 (so a 24 x 24 image wastes no column slots), and one
    persistent block per SM (or one per tile, if fewer), each walking its
    tiles so that a tile's epilogue overlaps the next one's loads."""
    bn = bf16_bn(cout)
    m_total = batch * h * w
    m_tiles, n_tiles = -(-m_total // BF16_BM), -(-cout // bn)
    grid = min(m_tiles * n_tiles, sms * BF16_BLOCKS_PER_SM)
    return Bf16Tiling(bn, m_total, m_tiles, n_tiles, grid, *bf16_segments(cin, cout))


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


def weight_tiles(wm: torch.Tensor, bn: int, atoms: int) -> torch.Tensor:
    """A (C, K) GEMM weight matrix as the kernel's B tiles, (n_tiles,
    atoms * steps, bn, BF16_BK): atom (j, a) holds output channels j bn ..
    j bn + bn - 1 and K a BF16_BK .. + BF16_BK, zeros past C and past K
    (which pads to a whole step of ``atoms`` atoms), each row's 16-byte
    chunk q stored at q ^ (row % 8) (the 128-byte swizzle, as the kernel's
    producer stores A), so that one bulk copy of a step's atoms * bn * 128
    bytes fills a stage's B."""
    c, k = wm.shape
    n_tiles, n_atoms = -(-c // bn), -(-k // (atoms * BF16_BK)) * atoms
    w = F.pad(wm, (0, n_atoms * BF16_BK - k, 0, n_tiles * bn - c))
    w = w.reshape(n_tiles, bn, n_atoms, BF16_BK // 8, 8).permute(0, 2, 1, 3, 4)
    # chunk q of row n lands at q ^ (n % 8); the XOR is its own inverse
    src = torch.arange(BF16_BK // 8)[None, :] ^ (torch.arange(bn) % 8)[:, None]  # (bn, 8)
    w = w[:, :, torch.arange(bn)[:, None], src]
    return w.reshape(n_tiles, n_atoms, bn, BF16_BK).contiguous()


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
    float32 launch grid fits (pixel tiles < 2^31, channel tiles <= 65535;
    the bfloat16 kernel's persistent grid takes any).  The shared memory
    per block is fixed whatever the channels (59 KB of 227 KB in float32,
    97 or 129 KB in bfloat16), because the kernels loop over them."""
    if min(h, w, cin, cout) < 1:
        return False
    tiles = -(-h // TILE_ROWS) * -(-w // TILE_COLS)
    return tiles <= _MAX_GRID_X and -(-cout // TILE_N) <= _MAX_GRID_YZ


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
        bf16 = dtype == torch.bfloat16  # one weight tensor fewer, the tiling more
        fn.argtypes = ([ctypes.c_void_p] * (8 if bf16 else 9) + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * bf16 + [ctypes.c_int, ctypes.c_void_p])
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
    device.  In bfloat16 the weights go as the tensor-core kernel's B
    tiles (:func:`weight_tiles` of the :func:`gemm_weights` matrices):
    conv1's, and conv2's with the shortcut's K appended, so that the call
    is (x, w1, b1, w2, b2, b3).  Raises on anything K5 does not take."""
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
    if x.dtype == torch.bfloat16:
        idx1, idx2 = _bf16_tile_index(cin, cout, x.device)
        zero = w1.new_zeros(1)
        return (x.contiguous(), torch.cat([zero, w1.reshape(-1)]).index_select(0, idx1.reshape(-1)),
                b1, torch.cat([zero, w2.reshape(-1), w3.reshape(-1)]).index_select(0, idx2.reshape(-1)),
                b2, b3)
    return (x.contiguous(), w1.reshape(9, cin, cout), b1, w2.reshape(9, cout, cout), b2, w3, b3)


@functools.lru_cache(maxsize=64)
def _bf16_tile_index(cin: int, cout: int, device: torch.device):
    """Gather indices that lay the bfloat16 kernel's B tiles out (conv1's,
    and conv2's with the shortcut's K appended) from [0, w1 flat] and
    [0, w2 flat, w3 flat]: gemm_weights and weight_tiles only move and pad,
    so running them once on 1, 2, 3, ... (float64, exact) gives each tile
    element's source, 0 where they pad."""
    conv1, (conv2, shortcut) = bf16_segments(cin, cout)
    bn = bf16_bn(cout)

    def positions(shape, start):
        n = int(np.prod(shape))
        return torch.arange(start, start + n, dtype=torch.float64).reshape(shape)

    n2 = 9 * cout * cout
    t1 = weight_tiles(gemm_weights(positions((3, 3, cin, cout), 1), conv1), bn,
                      bf16_atoms(bn, conv1.kseg))
    t2 = weight_tiles(torch.cat([gemm_weights(positions((3, 3, cout, cout), 1), conv2),
                                 gemm_weights(positions((cin, cout), 1 + n2), shortcut)], dim=1),
                      bn, bf16_atoms(bn, conv2.kseg + shortcut.kseg))
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
    tiling = ()
    if x.dtype == torch.bfloat16:
        ints = bf16_tiling(bsz, h, w, cin, out.shape[-1], _sm_count(index)).ints()
        tiling = (ints.ctypes.data,)
    code = fns[x.dtype](
        *(t.data_ptr() for t in tensors), y1.data_ptr(), out.data_ptr(),
        bsz, h, w, cin, out.shape[-1], *tiling, index,
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
