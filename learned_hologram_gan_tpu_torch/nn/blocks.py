"""Neural-net building blocks (counterpart of
``learned_hologram_gan_tpu/nn/blocks.py``), NCHW.

Submodules carry the flax module names (``Conv_0``, ``BatchNorm_0``,
``enc_0``, ``ConvTranspose_0`` ...), so a parameter path in the JAX tree
and its ``state_dict`` key name the same thing (see ``convert.py``).

Initialization follows the JAX package's scheme with an explicit
``torch.Generator``: truncated-normal Xavier for convs, normal Kaiming
(fan_out, gain 2) for transposed convs, zero biases, unit BatchNorm scale,
``|N(0, 1)|`` radial weights.  Numbers differ from JAX's for the same seed.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# BatchNorm as flax.linen.BatchNorm: epsilon 1e-5, momentum 0.99 on the
# running average, which is torch's momentum 0.01 (unused in eval).
BN_EPS = 1e-5
BN_MOMENTUM = 0.01
# std of a standard normal truncated to (-2, 2), as jax.nn.initializers uses
_TRUNC_STD = 0.87962566103423978


@contextlib.contextmanager
def full_f32_convs():
    """Run cuDNN convolutions in full float32 inside the block.

    By default torch lets cuDNN round float32 convolution inputs to TF32
    (a 10-bit mantissa).  The port's float32 path keeps full float32, the
    numerics its tests hold against the JAX package.  The previous setting
    comes back on exit.  Usable as a decorator.
    """
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv(in_ch: int, features: int, kernel: int) -> nn.Conv2d:
    """flax ``nn.Conv`` with "SAME" padding for k > 1, "VALID" for 1x1."""
    return nn.Conv2d(in_ch, features, kernel, padding=kernel // 2 if kernel > 1 else 0)


def _batch_norm(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)


class ResidualBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN (+1x1 shortcut) -> add -> ReLU
    (reference neural_network_components.py:6-32)."""

    def __init__(self, in_ch: int, features: int, use_1x1conv: bool = False):
        super().__init__()
        if not use_1x1conv and in_ch != features:
            raise ValueError("an identity shortcut needs in_ch == features")
        self.Conv_0 = _conv(in_ch, features, 3)
        self.BatchNorm_0 = _batch_norm(features)
        self.Conv_1 = _conv(features, features, 3)
        self.BatchNorm_1 = _batch_norm(features)
        self.Conv_2 = _conv(in_ch, features, 1) if use_1x1conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return F.relu(y + x)


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
    (reference :78-95), run as one grouped conv.  (N, 3, H, W) in and out."""

    def __init__(self, kernel_size: int = 3):
        super().__init__()
        self.conv_r = SymmetricConv2d(kernel_size)
        self.conv_g = SymmetricConv2d(kernel_size)
        self.conv_b = SymmetricConv2d(kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = (self.conv_r, self.conv_g, self.conv_b)
        weight = torch.stack([c.kernel() for c in convs])[:, None]  # (3, 1, k, k)
        bias = torch.cat([c.bias for c in convs])
        k = convs[0].kernel_size
        return F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype), padding=k // 2, groups=3)


class FakeChannelWiseSymmetricConv(nn.Module):
    """Identity stand-in for the no-modulation ablation (reference :98-103)."""

    def __init__(self, kernel_size: int = 3):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def PixelShuffleConvTranspose(in_ch: int, features: int) -> nn.ConvTranspose2d:
    """2x2 / stride-2 transposed conv (reference ConvTranspose2d(.., 2,
    stride=2)).  A flax kernel maps onto its weight with the spatial taps
    flipped: ``lax.conv_transpose`` flips them, torch does not (convert.py)."""
    return nn.ConvTranspose2d(in_ch, features, 2, stride=2)


class UNet(nn.Module):
    """Residual-block UNet, shape-preserving, sigmoid head
    (reference UNet :241-315): ``levels`` encoder levels at base*2^i
    channels, a base*2^levels bottleneck, transposed-conv ups, skip
    connections by channel concat [skip, up], a final 1x1 conv."""

    def __init__(
        self,
        in_channels: int = 4,
        output_channels: int = 6,
        base_features: int = 64,
        levels: int = 4,
    ):
        super().__init__()
        f = base_features
        self.levels = levels
        self.enc_0 = ResidualBlock(in_channels, f, use_1x1conv=True)
        for i in range(1, levels):
            setattr(self, f"enc_{i}", ResidualBlock(f * 2 ** (i - 1), f * 2**i, True))
        self.bottleneck = ResidualBlock(f * 2 ** (levels - 1), f * 2**levels, True)
        if levels > 1:
            self.ConvTranspose_0 = PixelShuffleConvTranspose(
                f * 2**levels, f * 2 ** (levels - 1)
            )
        for i in reversed(range(1, levels)):
            setattr(self, f"dec_{i}", ResidualBlock(f * 2 ** (i + 1), f * 2**i, True))
            if i > 1:
                setattr(
                    self,
                    f"ConvTranspose_{levels - i}",
                    PixelShuffleConvTranspose(f * 2**i, f * 2 ** (i - 1)),
                )
        setattr(self, f"ConvTranspose_{levels - 1}", PixelShuffleConvTranspose(2 * f, f))
        self.dec_0 = ResidualBlock(2 * f, f, True)
        self.Conv_0 = _conv(f, output_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        y = x
        for i in range(self.levels):
            y = getattr(self, f"enc_{i}")(y)
            skips.append(y)
            y = F.max_pool2d(y, 2)
        y = self.bottleneck(y)
        if self.levels > 1:
            y = self.ConvTranspose_0(y)
        for i in reversed(range(1, self.levels)):
            y = getattr(self, f"dec_{i}")(torch.cat([skips[i], y], dim=1))
            if i > 1:
                y = getattr(self, f"ConvTranspose_{self.levels - i}")(y)
        y = getattr(self, f"ConvTranspose_{self.levels - 1}")(y)
        y = self.dec_0(torch.cat([skips[0], y], dim=1))
        return torch.sigmoid(self.Conv_0(y))


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
