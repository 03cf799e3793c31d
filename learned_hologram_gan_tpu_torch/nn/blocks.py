"""Neural-net building blocks (counterpart of
``learned_hologram_gan_tpu/nn/blocks.py``), NCHW.

Submodules carry the flax module names (``Conv_0``, ``BatchNorm_0``,
``enc_0``, ``ConvTranspose_0`` ...), so a parameter path in the JAX tree
and its ``state_dict`` key name the same thing (see ``convert.py``).

Initialization follows the JAX package's scheme with an explicit
``torch.Generator``: truncated-normal Xavier for convs, normal Kaiming
(fan_out, gain 2) for transposed convs, zero biases, unit BatchNorm scale,
``|N(0, 1)|`` radial weights.  Numbers differ from JAX's for the same seed.

Compute dtype, as flax's ``dtype`` (not ``torch.autocast``): parameters
stay float32; each conv casts its input, kernel and bias to the module's
compute dtype at the call (flax ``promote_dtype``), so gradients reach the
float32 parameters through the cast.  In bfloat16 the conv output rounds to
bfloat16 and the bias adds in bfloat16, as flax adds it; :class:`BatchNorm`
reduces its statistics in float32, normalizes in float32 and rounds once
(flax ``_compute_stats`` / ``_normalize``).  Float32 modules take torch's
fused conv bias and ``F.batch_norm``.

:func:`remat` is flax's ``nn.remat`` / ``jax.checkpoint``: a region's
activations are recomputed in the backward instead of kept.  The recompute
leaves BatchNorm running statistics as the forward left them, so a remat
step updates them once, as the plain step does.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..parallel import collectives
from .polyphase import (
    depth_to_space,
    poly_concat,
    poly_conv1x1,
    poly_conv3x3,
    poly_pool,
    poly_upconv_gemm,
    space_to_depth,
    tile4,
)

# BatchNorm as flax.linen.BatchNorm: epsilon 1e-5, momentum 0.99 on the
# running average, which is torch's momentum 0.01.
BN_EPS = 1e-5
BN_MOMENTUM = 0.01
# std of a standard normal truncated to (-2, 2), as jax.nn.initializers uses
_TRUNC_STD = 0.87962566103423978


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {name!r}")
    return DTYPES[name]


@contextlib.contextmanager
def full_f32_convs():
    """Accumulate in full float32 inside the block.

    By default torch lets cuDNN round float32 convolution inputs to TF32
    (a 10-bit mantissa), and lets cuBLAS reduce bfloat16 matrix products in
    reduced precision.  The port keeps full float32 in both, the numerics
    its tests hold against the JAX package (whose bfloat16 products
    accumulate in float32).  The previous settings come back on exit.
    Usable as a decorator.
    """
    matmul = torch.backends.cuda.matmul
    prev = torch.backends.cudnn.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = prev


def _bias(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return b.to(dtype)[:, None, None]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's compute dtype: float32 parameters, input,
    kernel and bias cast to ``compute_dtype`` per call."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x.float())
        return self._conv_forward(x.to(dt), self.weight.to(dt), None) + _bias(self.bias, dt)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with flax's compute dtype, as :class:`Conv2d`."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x.float())
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding,
                               self.output_padding, self.groups, self.dilation)
        return y + _bias(self.bias, dt)


def _conv(in_ch: int, features: int, kernel: int, dtype: torch.dtype = torch.float32) -> Conv2d:
    """flax ``nn.Conv`` with "SAME" padding for k > 1, "VALID" for 1x1."""
    return Conv2d(in_ch, features, kernel, padding=kernel // 2 if kernel > 1 else 0,
                  compute_dtype=dtype)


def _moments(xf: torch.Tensor, dims: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Biased float32 mean and variance of ``xf`` over ``dims``, as flax's
    fast variance ``E[x^2] - E[x]^2``: sums over the count.  Inside
    ``parallel.collectives.data_parallel`` over the global batch: the
    per-rank sums all-reduce (differentiably, twice over) and divide by
    the global count, so one rank computes what no mesh does."""
    group = collectives.data_group()
    count = math.prod(xf.shape[d] for d in dims)
    sums = torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)])
    if group is not None:
        count *= torch.distributed.get_world_size(group)
        sums = collectives.all_reduce(sums, group)
    mean, mean2 = sums[0] / count, sums[1] / count
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


def _two_pass(x: torch.Tensor, dims, shape, count: int, group, reduce):
    """Mean and ``E[(x - mean)^2]`` over ``dims`` (over ``group``'s global
    batch when given), summing across ranks with ``reduce``."""
    def total(t):
        return t if group is None else reduce(t, group)

    mean = total(x.sum(dim=dims)) / count
    return mean, total(((x - mean.reshape(shape)) ** 2).sum(dim=dims)) / count


class _BatchNormF32(torch.autograd.Function):
    """Train-mode float32 BatchNorm over ``dims`` with the batch's
    statistics (the global batch's over ``group``), where ``F.batch_norm``
    cannot serve: a data-parallel region, the phase domain, one value per
    channel.  ``F.batch_norm``'s arithmetic: the two-pass variance, and the
    fused backward ``invstd * (g - mean(g) - xhat * mean(g * xhat))`` with
    ``g = dy * weight``, which keeps only ``x``, the weight, the mean and
    ``invstd`` for the backward.  On the card, against a float64 critic at
    384² (feature_d 32, batch 4), its penalty gradients lie 2.2e-4 of
    max |g| off, cuDNN's BatchNorm's 5.5e-4 (PERF.md §6).  The
    backward is written in differentiable ops (the statistics recomputed
    from ``x`` under ``create_graph``), so the WGAN-GP double backward
    runs through it.  Returns the output, the mean and flax's fast
    variance (for the running statistics; neither differentiable)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dims, group):
        shape = [1 if d in dims else n for d, n in enumerate(x.shape)]
        count = math.prod(x.shape[d] for d in dims) * (
            1 if group is None else torch.distributed.get_world_size(group))
        mean, var = _two_pass(x, dims, shape, count, group, collectives.sum_no_grad)
        sq = x.pow(2).sum(dim=dims)
        fast = torch.clamp((sq if group is None else collectives.sum_no_grad(sq, group)) / count
                           - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        y = (x - mean.reshape(shape)) * (invstd * weight).reshape(shape) + bias.reshape(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.cfg = (eps, dims, group, count, shape)
        ctx.mark_non_differentiable(mean, fast)
        return y, mean, fast

    @staticmethod
    def backward(ctx, dy, _mean, _fast):
        x, weight, mean, invstd = ctx.saved_tensors
        eps, dims, group, count, shape = ctx.cfg
        if torch.is_grad_enabled():  # create_graph: the statistics as functions of x
            mean, var = _two_pass(x, dims, shape, count, group, collectives.all_reduce)
            invstd = torch.rsqrt(var + eps)
        xhat = (x - mean.reshape(shape)) * invstd.reshape(shape)
        g = dy * weight.reshape(shape)
        sums = torch.stack([g.sum(dim=dims), (g * xhat).sum(dim=dims)])
        if group is not None:
            sums = collectives.all_reduce(sums, group)
        dx = invstd.reshape(shape) * (g - (sums[0] / count).reshape(shape)
                                      - xhat * (sums[1] / count).reshape(shape))
        return dx, (dy * xhat).sum(dim=dims), dy.sum(dim=dims), None, None, None


class BatchNorm(nn.BatchNorm2d):
    """``flax.linen.BatchNorm`` over NCHW channels.

    Eval mode normalizes with the running statistics, as torch does.  Train
    mode normalizes with the batch statistics and updates the running ones
    as flax does (flax/linen/normalization.py): with the *biased* batch
    variance ``E[x^2] - E[x]^2``, where torch's own BatchNorm would take the
    unbiased one, and with momentum 0.99 on the running average.  Inside
    :func:`frozen_batch_stats` train mode leaves the running statistics as
    they are (flax's apply with the update discarded).

    A bfloat16 input takes flax's rule for a bfloat16 BatchNorm: statistics
    reduce in float32, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``
    runs in float32, and the result rounds once to bfloat16; the running
    statistics stay float32.  A float32 input takes ``F.batch_norm``, but
    for a single value per channel in train mode, which it refuses
    (:class:`_BatchNormF32` then).

    Inside ``parallel.collectives.data_parallel`` the train-mode statistics
    are the global batch's (the per-rank sums all-reduced, as GSPMD
    reduces over a batch-sharded axis; a float32 input through
    :class:`_BatchNormF32`, ``F.batch_norm``'s arithmetic), and every
    rank's running statistics move alike.  ``nn.SyncBatchNorm`` is not
    used: it folds the unbiased variance into the running statistics, and
    its backward is not twice differentiable.
    """

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.update_stats = True

    def fold_batch_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Move the running statistics toward a batch's, unless frozen."""
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
                self.num_batches_tracked.add_(1)

    def _batch_stats(self, x: torch.Tensor):
        """Biased float32 batch statistics (``force_float32_reductions``),
        folded into the running ones unless frozen."""
        mean, var = _moments(x.float(), (0, 2, 3))
        self.fold_batch_stats(mean, var)
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # F.batch_norm refuses one value per channel in train mode (a batch-1
        # 1 x 1 bottleneck); flax normalizes it to the bias, as _BatchNormF32 does
        group = collectives.data_group()
        if x.dtype == torch.float32 and self.training and (x.numel() == x.shape[1] or group is not None):
            y, mean, fast = _BatchNormF32.apply(x, self.weight, self.bias, self.eps, (0, 2, 3), group)
            self.fold_batch_stats(mean, fast)
            return y
        if x.dtype != torch.float32:
            if self.training:
                mean, var = self._batch_stats(x)
            else:
                mean, var = self.running_mean, self.running_var
            mul = torch.rsqrt(var + self.eps) * self.weight
            y = (x.float() - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
            return y.to(x.dtype)
        if not self.training:
            return super().forward(x)
        if self.update_stats:
            with torch.no_grad():
                self._batch_stats(x)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class frozen_batch_stats:
    """Train-mode forwards of ``module`` inside the block normalize with
    batch statistics but leave every :class:`BatchNorm`'s running
    statistics unchanged.  Reusable: a :func:`remat` region enters it at
    each recompute, and a ``create_graph`` double backward recomputes a
    region more than once."""

    def __init__(self, module: nn.Module):
        self.norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
        self.saved = []

    def __enter__(self):
        self.saved.append([m.update_stats for m in self.norms])
        for m in self.norms:
            m.update_stats = False
        return self

    def __exit__(self, *exc):
        for m, p in zip(self.norms, self.saved.pop()):
            m.update_stats = p
        return False


def remat(fn: Callable, *args, module: Optional[nn.Module] = None):
    """``fn(*args)`` with its activations recomputed in the backward instead
    of kept (``torch.utils.checkpoint``, non-reentrant: it carries a
    ``create_graph`` double backward, and nests).  The recompute runs under
    :class:`frozen_batch_stats` for ``module``, the module of ``fn`` whose
    BatchNorms run in train mode, and under the backward's own settings
    (the train step's run in full float32).  ``fn`` draws no random
    numbers: the callers hoist their draws, so no RNG state is stashed."""
    recompute = frozen_batch_stats(module) if module is not None else contextlib.nullcontext()
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), recompute),
    )


def _batch_norm(features: int) -> BatchNorm:
    return BatchNorm(features)


class ResidualBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN (+1x1 shortcut) -> add -> ReLU
    (reference neural_network_components.py:6-32), in compute ``dtype``."""

    def __init__(self, in_ch: int, features: int, use_1x1conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not use_1x1conv and in_ch != features:
            raise ValueError("an identity shortcut needs in_ch == features")
        self.Conv_0 = _conv(in_ch, features, 3, dtype)
        self.BatchNorm_0 = _batch_norm(features)
        self.Conv_1 = _conv(features, features, 3, dtype)
        self.BatchNorm_1 = _batch_norm(features)
        self.Conv_2 = _conv(in_ch, features, 1, dtype) if use_1x1conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return F.relu(y + x)


class FourierBlock(nn.Module):
    """A spatial :class:`ResidualBlock` plus :class:`ResidualBlock`s on the
    real and imaginary parts of the 1-D FFT along W, summed (the JAX
    package's ``FourierBlock``, reference :336-353).  The FFT runs in
    float32 (``torch.fft``, as the JAX package runs ``jnp.fft``); the
    inverse's real part joins the sum in the input's dtype.  The children
    carry flax's auto names: ``ResidualBlock_0`` (spatial), ``_1`` (real),
    ``_2`` (imaginary)."""

    def __init__(self, in_ch: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ResidualBlock_0 = ResidualBlock(in_ch, features, True, dtype)
        self.ResidualBlock_1 = ResidualBlock(in_ch, features, True, dtype)
        self.ResidualBlock_2 = ResidualBlock(in_ch, features, True, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spatial = self.ResidualBlock_0(x)
        f = torch.fft.fft(x.float(), dim=-1)  # along W in NCHW
        fr = self.ResidualBlock_1(f.real.to(x.dtype))
        fi = self.ResidualBlock_2(f.imag.to(x.dtype))
        fourier = torch.fft.ifft(torch.complex(fr.float(), fi.float()), dim=-1).real.to(x.dtype)
        return spatial + fourier


def _flax_kernel(conv: nn.Conv2d) -> torch.Tensor:
    """A conv's weight (O, I, kh, kw) in flax's (kh, kw, I, O) layout, as
    a differentiable view."""
    return conv.weight.permute(2, 3, 1, 0)


def _flax_up_kernel(up: nn.ConvTranspose2d) -> torch.Tensor:
    """A 2x2 up-conv's weight (I, O, 2, 2) in the flax (2, 2, I, O) layout
    that ``lax.conv_transpose`` applies (taps flipped; convert.py), as a
    differentiable view."""
    return up.weight.permute(2, 3, 0, 1).flip(0, 1)


def poly_batch_norm(bn: BatchNorm, x4: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``bn`` over phase-major (N, h, w, 4C) input, per original channel
    (the JAX package's ``_PolyBatchNorm``, ``nn/blocks.py:88-151``).

    Train-mode statistics reduce over the phase axis too, so they equal the
    standard-domain statistics (the phases partition the pixels), with
    :class:`BatchNorm`'s rules: biased float32 statistics, float32 input
    through ``F.batch_norm``'s arithmetic (:class:`_BatchNormF32`; the JAX
    function normalizes with the fast variance), the fast variance moving
    the running statistics with momentum 0.99, none moved under
    :class:`frozen_batch_stats`, the global batch's inside
    ``data_parallel``.  Otherwise scale and bias round to the compute
    ``dtype`` before use, and the normalization runs in float32 and
    rounds once to ``dtype``."""
    c = x4.shape[-1] // 4
    xf = x4.float()
    if bn.training and dtype == torch.float32:
        y, mean, fast = _BatchNormF32.apply(xf.reshape(*x4.shape[:3], 4, c), bn.weight, bn.bias, bn.eps,
                                            (0, 1, 2, 3), collectives.data_group())
        bn.fold_batch_stats(mean, fast)
        return y.reshape(x4.shape)
    if bn.training:
        mean, var = _moments(xf.reshape(*x4.shape[:3], 4, c), (0, 1, 2, 3))
        bn.fold_batch_stats(mean, var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight.to(dtype).float()
    y = (xf - tile4(mean)) * tile4(mul) + tile4(bn.bias.to(dtype).float())
    return y.to(dtype)


def poly_residual_block(block: "ResidualBlock", x4: torch.Tensor) -> torch.Tensor:
    """``block`` computed in the space-to-depth phase domain (exact; the
    JAX package's ``PolyResidualBlock``, ``nn/blocks.py:154-182``) from
    the block's own parameters: phase-major (N, h, w, 4Cin) in,
    (N, h, w, 4C) out, in the block's compute dtype, differentiable."""
    dt = block.Conv_0.compute_dtype
    x4 = x4.to(dt)
    y = poly_conv3x3(x4, _flax_kernel(block.Conv_0).to(dt), block.Conv_0.bias)
    y = F.relu(poly_batch_norm(block.BatchNorm_0, y, dt))
    y = poly_conv3x3(y, _flax_kernel(block.Conv_1).to(dt), block.Conv_1.bias)
    y = poly_batch_norm(block.BatchNorm_1, y, dt)
    sc = poly_conv1x1(x4, _flax_kernel(block.Conv_2).to(dt), block.Conv_2.bias)
    return F.relu(y + sc)


class SymmetricConv2d(nn.Module):
    """Radially-symmetric single-channel conv: one weight per unique squared
    distance from the kernel centre, expanded through a static index map
    (reference neural_network_components.py:35-75)."""

    def __init__(self, kernel_size: int = 3):
        super().__init__()
        idx_map, n_uniq = self.distance_map(kernel_size)
        self.kernel_size = kernel_size
        self.register_buffer("idx_map", torch.from_numpy(idx_map).long(), persistent=False)
        self.radial_weights = nn.Parameter(torch.ones(n_uniq))
        self.bias = nn.Parameter(torch.zeros(1))

    @staticmethod
    def distance_map(kernel_size: int) -> Tuple[np.ndarray, int]:
        c = kernel_size // 2
        ii, jj = np.meshgrid(np.arange(kernel_size), np.arange(kernel_size), indexing="ij")
        d = (ii - c) ** 2 + (jj - c) ** 2
        uniq = np.unique(d)
        return np.searchsorted(uniq, d).astype(np.int64), len(uniq)

    def kernel(self) -> torch.Tensor:
        return self.radial_weights[self.idx_map]  # (k, k)


class ChannelWiseSymmetricConv(nn.Module):
    """Three independent :class:`SymmetricConv2d`, one per R/G/B channel
    (reference :78-95), run as one grouped conv in compute ``dtype``.
    (N, 3, H, W) in and out."""

    def __init__(self, kernel_size: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_r = SymmetricConv2d(kernel_size)
        self.conv_g = SymmetricConv2d(kernel_size)
        self.conv_b = SymmetricConv2d(kernel_size)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = (self.conv_r, self.conv_g, self.conv_b)
        weight = torch.stack([c.kernel() for c in convs])[:, None]  # (3, 1, k, k)
        bias = torch.cat([c.bias for c in convs])
        k, dt = convs[0].kernel_size, self.compute_dtype
        if dt == torch.float32:
            return F.conv2d(x.float(), weight, bias, padding=k // 2, groups=3)
        y = F.conv2d(x.to(dt), weight.to(dt), None, padding=k // 2, groups=3)
        return y + _bias(bias, dt)


class FakeChannelWiseSymmetricConv(nn.Module):
    """Identity stand-in for the no-modulation ablation (reference :98-103)."""

    def __init__(self, kernel_size: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def PixelShuffleConvTranspose(in_ch: int, features: int,
                              dtype: torch.dtype = torch.float32) -> ConvTranspose2d:
    """2x2 / stride-2 transposed conv (reference ConvTranspose2d(.., 2,
    stride=2)).  A flax kernel maps onto its weight with the spatial taps
    flipped: ``lax.conv_transpose`` flips them, torch does not (convert.py)."""
    return ConvTranspose2d(in_ch, features, 2, stride=2, compute_dtype=dtype)


class UNet(nn.Module):
    """Residual-block UNet, shape-preserving, sigmoid head
    (reference UNet :241-315): ``levels`` encoder levels at base*2^i
    channels, a base*2^levels bottleneck, transposed-conv ups, skip
    connections by channel concat [skip, up], a final 1x1 conv.  Its
    convolutions run in compute ``dtype``, and so does its output.  With
    ``remat`` each residual block recomputes its activations in the
    backward (:func:`remat`; the JAX package's per-block ``nn.remat``); the
    parameters are the same.

    ``polyphase_level0`` computes level 0 (``enc_0``, the last up-conv,
    ``dec_0`` and the head ``Conv_0``) in the space-to-depth phase domain
    (``nn/polyphase.py``, exact math) from the same modules' parameters, so
    ``state_dict`` keys and shapes do not change and checkpoints
    interchange; as in the JAX package it applies with ``levels > 1`` and
    even H and W, and the plain path runs otherwise.

    ``fourier`` makes every block a :class:`FourierBlock` (reference
    Unet_Fourier :348-353); level 0 then never runs in the phase domain,
    and ``remat`` wraps the FourierBlocks as it wraps residual blocks."""

    def __init__(
        self,
        in_channels: int = 4,
        output_channels: int = 6,
        base_features: int = 64,
        levels: int = 4,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        polyphase_level0: bool = False,
        fourier: bool = False,
    ):
        super().__init__()
        f = base_features
        self.levels = levels
        self.dtype = dtype
        self.remat = remat
        self.polyphase_level0 = polyphase_level0
        self.fourier = fourier

        def block(cin, cout):
            return FourierBlock(cin, cout, dtype) if fourier else ResidualBlock(cin, cout, True, dtype)

        self.enc_0 = block(in_channels, f)
        for i in range(1, levels):
            setattr(self, f"enc_{i}", block(f * 2 ** (i - 1), f * 2**i))
        self.bottleneck = block(f * 2 ** (levels - 1), f * 2**levels)
        if levels > 1:
            self.ConvTranspose_0 = PixelShuffleConvTranspose(
                f * 2**levels, f * 2 ** (levels - 1), dtype
            )
        for i in reversed(range(1, levels)):
            setattr(self, f"dec_{i}", block(f * 2 ** (i + 1), f * 2**i))
            if i > 1:
                setattr(
                    self,
                    f"ConvTranspose_{levels - i}",
                    PixelShuffleConvTranspose(f * 2**i, f * 2 ** (i - 1), dtype),
                )
        setattr(self, f"ConvTranspose_{levels - 1}", PixelShuffleConvTranspose(2 * f, f, dtype))
        self.dec_0 = block(2 * f, f)
        self.Conv_0 = _conv(f, output_channels, 1, dtype)

    def _block(self, name: str, x: torch.Tensor, poly: bool = False) -> torch.Tensor:
        block = getattr(self, name)
        fn = functools.partial(poly_residual_block, block) if poly else block
        return remat(fn, x, module=block) if self.remat else fn(x)

    def uses_polyphase(self, x: torch.Tensor) -> bool:
        """Whether level 0 runs in the phase domain for input ``x``."""
        return (self.polyphase_level0 and not self.fourier and self.levels > 1
                and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0)

    def encode_level0(self, x: torch.Tensor, poly: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """``enc_0`` and its pool: (skip, pooled NCHW).  With ``poly`` the
        block runs in the phase domain and the skip stays phase-major NHWC."""
        if poly:
            s0 = self._block("enc_0", space_to_depth(x.permute(0, 2, 3, 1)), poly=True)
            return s0, poly_pool(s0).permute(0, 3, 1, 2).contiguous()
        s0 = self._block("enc_0", x)
        return s0, F.max_pool2d(s0, 2)

    def inner(self, y: torch.Tensor) -> torch.Tensor:
        """Levels 1 and up, the bottleneck and their decoders: the pooled
        level-0 features -> the input of the last up-conv."""
        skips = []
        for i in range(1, self.levels):
            y = self._block(f"enc_{i}", y)
            skips.append(y)
            y = F.max_pool2d(y, 2)
        y = self._block("bottleneck", y)
        if self.levels > 1:
            y = self.ConvTranspose_0(y)
        for i in reversed(range(1, self.levels)):
            y = self._block(f"dec_{i}", torch.cat([skips[i - 1], y], dim=1))
            if i > 1:
                y = getattr(self, f"ConvTranspose_{self.levels - i}")(y)
        return y

    def decode_level0(self, skip: torch.Tensor, y: torch.Tensor, poly: bool) -> torch.Tensor:
        """The last up-conv, ``dec_0`` and the head ``Conv_0`` from
        :meth:`encode_level0`'s skip and :meth:`inner`'s output."""
        up = getattr(self, f"ConvTranspose_{self.levels - 1}")
        if poly:
            dt = self.dtype
            y = poly_upconv_gemm(y.permute(0, 2, 3, 1).to(dt), _flax_up_kernel(up).to(dt), up.bias)
            y = self._block("dec_0", poly_concat(skip, y), poly=True)
            y = poly_conv1x1(y.to(dt), _flax_kernel(self.Conv_0).to(dt), self.Conv_0.bias)
            return torch.sigmoid(depth_to_space(y)).permute(0, 3, 1, 2)
        y = self._block("dec_0", torch.cat([skip, up(y)], dim=1))
        return torch.sigmoid(self.Conv_0(y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        poly = self.uses_polyphase(x)  # level 0 in the phase domain, NHWC, skip kept phase-major
        skip, y = self.encode_level0(x, poly)
        return self.decode_level0(skip, self.inner(y), poly)


def MiniUNet(in_channels: int, output_channels: int = 1,
             dtype: torch.dtype = torch.float32) -> UNet:
    """2-level, 16-base-feature UNet (reference miniUNet :188-238)."""
    return UNet(in_channels, output_channels, base_features=16, levels=2, dtype=dtype)


class RGBDUNet(nn.Module):
    """Per-colour variant: three 4-level UNets on (R, D), (G, D), (B, D)
    (reference RGBD_UNet :318-333).  (N, 4, H, W) input with channels
    [R, G, B, D]; output channels [amp_r, amp_g, amp_b, phs_r, phs_g, phs_b]."""

    def __init__(self, base_features: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        for c in "rgb":
            setattr(self, f"unet_{c}", UNet(2, 2, base_features=base_features, dtype=dtype))

    def forward(self, rgbd: torch.Tensor) -> torch.Tensor:
        outs = [getattr(self, f"unet_{c}")(rgbd[:, [i, 3]]) for i, c in enumerate("rgb")]
        return torch.cat([o[:, :1] for o in outs] + [o[:, 1:] for o in outs], dim=1)


class _ResNetBase(nn.Module):
    """Shared stride-1 ResNet trunk (reference miniResNet / ResNet): a 7x7
    stem conv, BatchNorm, ReLU, the residual blocks of ``block_plan``
    ((features, use_1x1conv) each), a 1x1 head and a sigmoid."""

    def __init__(self, in_channels: int, output_channels: int, stem_features: int,
                 block_plan, stem_kernel: int = 7, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = _conv(in_channels, stem_features, stem_kernel, dtype)
        self.BatchNorm_0 = _batch_norm(stem_features)
        cin = stem_features
        for i, (feats, use_1x1) in enumerate(block_plan):
            setattr(self, f"ResidualBlock_{i}", ResidualBlock(cin, feats, use_1x1, dtype))
            cin = feats
        self.num_blocks = len(block_plan)
        self.Conv_1 = _conv(cin, output_channels, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        for i in range(self.num_blocks):
            y = getattr(self, f"ResidualBlock_{i}")(y)
        return torch.sigmoid(self.Conv_1(y))


def MiniResNet(in_channels: int, output_channels: int = 3,
               dtype: torch.dtype = torch.float32) -> _ResNetBase:
    """4 residual blocks at 32/64 channels (reference :106-138)."""
    return _ResNetBase(in_channels, output_channels, 32,
                       [(32, False), (32, False), (64, True), (64, False)], dtype=dtype)


def ResNet(in_channels: int, output_channels: int = 3,
           dtype: torch.dtype = torch.float32) -> _ResNetBase:
    """8 residual blocks, 64 -> 512 channels (reference :141-177)."""
    plan = [(64, False), (64, False), (128, True), (128, False),
            (256, True), (256, False), (512, True), (512, False)]
    return _ResNetBase(in_channels, output_channels, 64, plan, dtype=dtype)


class ResNetPOH(nn.Module):
    """:func:`ResNet` with its output scaled to a [0, 2*pi] phase
    (reference :180-185); the trunk carries flax's auto name."""

    def __init__(self, in_channels: int, output_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self._ResNetBase_0 = ResNet(in_channels, output_channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return 2.0 * np.pi * self._ResNetBase_0(x)


@torch.no_grad()
def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Initialize ``module`` in place with the JAX package's scheme, drawing
    from ``generator`` (on the CPU)."""

    def draw(shape, std, truncated):
        t = torch.empty(shape)
        if truncated:
            # truncated to (-2, 2) standard deviations, then rescaled
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
            return t * (std / _TRUNC_STD)
        return t.normal_(0.0, std, generator=generator)

    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            cout = m.weight.shape[1]
            fan_out = cout * m.weight.shape[2] * m.weight.shape[3]
            m.weight.copy_(draw(m.weight.shape, math.sqrt(2.0 / fan_out), False))
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            cout, cin, kh, kw = m.weight.shape
            fan_avg = (cin + cout) * kh * kw / 2.0
            m.weight.copy_(draw(m.weight.shape, math.sqrt(1.0 / fan_avg), True))
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, SymmetricConv2d):
            m.radial_weights.copy_(draw(m.radial_weights.shape, 1.0, False).abs())
            nn.init.zeros_(m.bias)
