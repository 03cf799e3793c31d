"""WGAN-GP patch critic (counterpart of
``learned_hologram_gan_tpu/models/discriminator.py``; reference
discriminator.py:5-67), NCHW.

conv3x3 + LeakyReLU(0.2) stem, then 5 conv-BN-LeakyReLU blocks with strides
2/1/2/1/2 and channels feature_d * (2, 4, 8, 16, 32), a final 1-channel
conv, flattened to per-patch Wasserstein scores (no sigmoid).  Submodules
carry the flax names (``Conv_0``..``Conv_6``, ``BatchNorm_0``..``BatchNorm_4``)
so ``convert.discriminator_state_dict`` maps a flax tree by path.

flax's ``"SAME"`` padding of a stride-2 3x3 conv pads (0, 1) on an even
input, not torch's symmetric (1, 1): the strided convs pad explicitly.
``dtype`` is the convolutions' compute dtype (flax's rule, nn/blocks.py);
the scores come back to float32 (JAX ``models/discriminator.py:41``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import BatchNorm, Conv2d, _TRUNC_STD, compute_dtype

_STRIDES = (2, 1, 2, 1, 2)


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Zero-pad H and W as XLA's "SAME" does for ``kernel`` / ``stride``."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class WGANGPDiscriminator192(nn.Module):
    """Patch critic for ~192px inputs: (B, 3, H, W) -> (B, patches)."""

    def __init__(self, feature_d: int = 32, dtype: str = "float32"):
        super().__init__()
        dt = compute_dtype(dtype)
        self.Conv_0 = Conv2d(3, feature_d, 3, padding=1, compute_dtype=dt)
        cin = feature_d
        for i, stride in enumerate(_STRIDES):
            cout = feature_d * 2 ** (i + 1)
            setattr(self, f"Conv_{i + 1}", Conv2d(cin, cout, 3, stride, padding=0, compute_dtype=dt))
            setattr(self, f"BatchNorm_{i}", BatchNorm(cout))
            cin = cout
        self.Conv_6 = Conv2d(cin, 1, 3, padding=1, compute_dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.Conv_0(x), 0.2)
        for i, stride in enumerate(_STRIDES):
            x = getattr(self, f"Conv_{i + 1}")(_same_pad(x, 3, stride))
            x = F.leaky_relu(getattr(self, f"BatchNorm_{i}")(x), 0.2)
        x = self.Conv_6(x).float()
        return x.reshape(x.shape[0], -1)


class FakeDiscriminator(nn.Module):
    """Constant-zero critic with one dummy parameter (reference :54-67),
    for the non-GAN trainers."""

    def __init__(self, feature_d: int = 32, dtype: str = "float32"):
        super().__init__()
        self.a = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros(1, device=x.device)


@torch.no_grad()
def init_discriminator(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """flax's default initialization, drawn from ``generator`` on the CPU:
    LeCun truncated-normal conv kernels, zero biases, unit BatchNorm scale."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            t = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
            m.weight.copy_(t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))
            nn.init.zeros_(m.bias)
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
